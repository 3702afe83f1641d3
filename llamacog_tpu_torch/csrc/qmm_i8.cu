// qmm_i8 — int8 x int8 -> int32 tensor-core prefill GEMM over the mmq planes.
//
// Replaces llamacog_tpu/ops/pallas/qmm_i8.py::_qmm_i8_call (_i8_kernel):
//   out[b, n] f32 = xs[b] * sum_g f32(xq[b, g] . qi8[n, g]) * ws8T[g, n]
// over the 512-column blocks g of K, with xq int8 [B, K] (one scale xs per
// row), qi8 int8 [N, K] and ws8T f32 [K / 512, N] (quant/mmq.py).
//
// Bound on this card: at a 512-row prefill chunk the 8B gate_up does 120 G
// int8 operations on 179 MB, so operations (1979 TOP/s dense int8) bound
// it just above bytes (3.35 TB/s). Design: xq and qi8 are both
// K-contiguous, which is the row.col operand pair of mma.sync m16n8k32
// s8.s8.s32. A block of 8 warps owns a 128 x 128 output tile and walks K in
// steps of 128 bytes through a 3-stage cp.async ring in shared memory (rows
// padded to 160 bytes, so the 8-byte fragment reads of a half-warp fall on
// distinct banks). Each warp owns 64 x 32 of the tile as 4 x 4 int32 m16n8
// accumulators. A thread reads 8 consecutive bytes of a row for the two
// k-halves of its fragment; A and B use the same k order, so the integer
// sum is the same. Every 512 columns the int32 partials (exact: |sum| <=
// 127^2 * 512 < 2^24, so also exact as f32) fold into the f32 sums as
// acc + f32(p) * ws8T[g] in the order g = 0, 1, ... with __fmul_rn /
// __fadd_rn (no FMA contraction), and reset; the epilogue scales by xs.
// That is the plain version's arithmetic operation for operation, so the
// two agree bit for bit. Rows past B and weight rows past N load as zeros
// and are not stored: B needs no padding to a tile multiple (the TPU pads
// it to 256). wgmma and TMA are later work.
#include "common.cuh"

constexpr int I8_BM = 128;                 // activation rows per block
constexpr int I8_BN = 128;                 // weight rows per block
constexpr int I8_BK = 128;                 // K bytes per pipeline stage
constexpr int I8_LDS = I8_BK + 32;         // shared row stride, bytes
constexpr int I8_STAGES = 3;
constexpr int I8_THREADS = 256;            // 2 x 4 warps of 64 x 32
constexpr int I8_KB = 512;                 // columns per weight scale (MMQ_KB)
constexpr int I8_STAGE_BYTES = (I8_BM + I8_BN) * I8_LDS;
constexpr int I8_SMEM = I8_STAGES * I8_STAGE_BYTES;  // 122,880 bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Queue the copy of columns [k0, k0 + I8_BK) of activation rows m0.. and
// weight rows n0.. into one stage: rows 0..I8_BM-1 activations, then the
// weights. Out-of-range rows are zero-filled.
__device__ __forceinline__ void load_stage(uint8_t* st, const int8_t* xq, const int8_t* qi,
                                           int B, int N, int K, int m0, int n0, int k0) {
    constexpr int CH = I8_BK / 16;  // 16-byte chunks per row
#pragma unroll
    for (int i = 0; i < (I8_BM + I8_BN) * CH / I8_THREADS; ++i) {
        const int c = threadIdx.x + i * I8_THREADS;
        const int r = c / CH, j = c % CH;
        const bool is_x = r < I8_BM;
        const int row = is_x ? m0 + r : n0 + r - I8_BM;
        const bool ok = row < (is_x ? B : N);
        const int8_t* base = is_x ? xq : qi;
        cp_async16(st + r * I8_LDS + j * 16,
                   base + (ok ? (size_t)row * K + k0 + j * 16 : 0), ok);
    }
}

__global__ void __launch_bounds__(I8_THREADS)
qmm_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
              const int8_t* __restrict__ qi, const float* __restrict__ ws,
              float* __restrict__ out, int B, int N, int K) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int n0 = blockIdx.x * I8_BN, m0 = blockIdx.y * I8_BM;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // mma group and thread in group
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

    int acc[4][4][4];
    float facc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[i][j][e] = 0;
                facc[i][j][e] = 0.f;
            }

    const int KT = K / I8_BK;
    constexpr int STEPS_PER_SCALE = I8_KB / I8_BK;
#pragma unroll
    for (int s = 0; s < I8_STAGES - 1; ++s) {
        if (s < KT) load_stage(smem + s * I8_STAGE_BYTES, xq, qi, B, N, K, m0, n0, s * I8_BK);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<I8_STAGES - 2>();
        __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
        const int pf = kt + I8_STAGES - 1;
        if (pf < KT)
            load_stage(smem + (pf % I8_STAGES) * I8_STAGE_BYTES, xq, qi, B, N, K, m0, n0,
                       pf * I8_BK);
        cp_async_commit();
        const uint8_t* As = smem + (kt % I8_STAGES) * I8_STAGE_BYTES;
        const uint8_t* Bs = As + I8_BM * I8_LDS;
#pragma unroll
        for (int kk = 0; kk < I8_BK; kk += 32) {
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                // rows g and g + 8 of m-tile i; bytes 8t..8t+3 are fragment
                // k-columns 4t.. and bytes 8t+4..8t+7 are 16+4t.. (B the same)
                const uint8_t* p = As + (wm + i * 16 + g) * I8_LDS + kk + t * 8;
                const uint2 lo = *reinterpret_cast<const uint2*>(p);
                const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * I8_LDS);
                a[i][0] = lo.x;
                a[i][1] = hi.x;
                a[i][2] = lo.y;
                a[i][3] = hi.y;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint2 w = *reinterpret_cast<const uint2*>(
                    Bs + (wn + j * 8 + g) * I8_LDS + kk + t * 8);
                b[j][0] = w.x;
                b[j][1] = w.y;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
        }
        if ((kt + 1) % STEPS_PER_SCALE == 0) {  // a 512-column block is complete
            const int gb = kt / STEPS_PER_SCALE;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int n = n0 + wn + j * 8 + t * 2 + c;
                    const float w = n < N ? ws[(size_t)gb * N + n] : 0.f;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int e = 2 * h + c;
                            const float part = __fmul_rn(__int2float_rn(acc[i][j][e]), w);
                            facc[i][j][e] = gb == 0 ? part : __fadd_rn(facc[i][j][e], part);
                            acc[i][j][e] = 0;
                        }
                }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm + i * 16 + g + 8 * h;
            if (row >= B) continue;
            const float x = xs[row];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + wn + j * 8 + t * 2;
                if (n >= N) continue;  // N is even, so n + 1 < N too
                const float2 v = make_float2(__fmul_rn(facc[i][j][2 * h], x),
                                             __fmul_rn(facc[i][j][2 * h + 1], x));
                *reinterpret_cast<float2*>(out + (size_t)row * N + n) = v;
            }
        }
}

// xq int8 [B, K], xs f32 [B], qi8 int8 [N, K], ws8T f32 [K / 512, N], out f32
// [B, N]; all contiguous, xq and qi8 16-byte aligned; K a multiple of 512,
// N even.
LCG_EXPORT int lcg_qmm_i8(const void* xq, const void* xs, const void* qi8, const void* ws8T,
                          void* out, int B, int N, int K, void* stream) {
    if (B < 1 || N < 2 || N % 2 || K < I8_KB || K % I8_KB)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(qmm_i8_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + I8_BN - 1) / I8_BN, (B + I8_BM - 1) / I8_BM);
    qmm_i8_kernel<<<grid, I8_THREADS, I8_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(qi8), static_cast<const float*>(ws8T),
        static_cast<float*>(out), B, N, K);
    return static_cast<int>(cudaGetLastError());
}

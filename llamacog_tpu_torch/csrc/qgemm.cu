// qgemm — fused dequant x GEMM over GGUF wire-format Q4_K / Q6_K weights.
//
// Replaces (llamacog_tpu/ops/pallas/qmm.py): _qmm_call at B > 8 (the plain
// and the row-tiled tb > 0 branches, _qmm_kernel -> _tile_matvec with bf16
// operands and f32 accumulation), and _qmm_multi_call / _qmm_multi_kernel
// at B > 8: out_t[B, N_t] f32 = x @ bf16(dequant(W_t))^T for bf16
// activations x and up to QG_MAX_DESC weights sharing x, in one launch
// whose blockIdx.x range is partitioned by weight.
//
// Bound on this card: at prefill batch (B = 128 on the main path) the work
// is 2*B flops per weight against under a byte per weight, and the least
// time is the larger of the weight bytes over 3.35 TB/s and the flops over
// the 989 TFLOP/s bf16 tensor-core peak — near the ridge at B = 128. Design:
// each block owns a 64 x 64 output tile and walks K in half-superblock steps
// of 128: the weight tile is dequantized from the wire blocks straight into
// shared memory as bf16 (each weight formed exactly as the plain torch
// dequant forms it, then rounded to bf16), the bf16 activation tile is
// copied beside it, and four warps take the product with WMMA
// bf16 x bf16 -> f32 fragments. Any B is taken (rows past B are zero), so
// there is no counterpart of the TPU's VMEM row-tiling rule. No pipelining
// of loads against the tensor cores yet: that is later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int QG_MAX_DESC = 4;
constexpr int QG_BM = 64;     // activation rows per block
constexpr int QG_BN = 64;     // weight rows per block
constexpr int QG_BK = 128;    // K per step: half a superblock
constexpr int QG_LDS = QG_BK + 8;   // smem row stride (bf16), a multiple of 8
constexpr int QG_LDC = QG_BN + 4;   // epilogue row stride (f32)
constexpr int QG_THREADS = 128;

struct QgDesc {
    const uint8_t* w;
    float* out;
    int kind;
    int n;
    int row_bytes;
    int block0;
};

struct QgParams {
    QgDesc d[QG_MAX_DESC];
    int n_desc;
    int B;
    int K;
};

// Dequantize the half-superblock `half` of superblock `sb` for weight rows
// n0..n0+63 into Bs [64][QG_LDS] bf16. Thread t owns row t/2 and 64 of the
// 128 columns.
__device__ __forceinline__ void dequant_q4k_tile(const QgDesc& D, int n0, int sb, int half,
                                                 __nv_bfloat16* Bs) {
    const int r = threadIdx.x >> 1;
    const int g = threadIdx.x & 1;
    __nv_bfloat16* dst = Bs + r * QG_LDS + g * 64;
    const int row = n0 + r;
    if (row >= D.n) {
#pragma unroll
        for (int i = 0; i < 64; ++i) dst[i] = __float2bfloat16(0.f);
        return;
    }
    const int j = 2 * half + g;  // 64-weight group of the superblock
    const uint8_t* blk = D.w + (size_t)row * D.row_bytes + (size_t)sb * Q4K_BYTES;
    const uint32_t dm = *reinterpret_cast<const uint32_t*>(blk);
    const uint32_t s0 = *reinterpret_cast<const uint32_t*>(blk + 4);
    const uint32_t s1 = *reinterpret_cast<const uint32_t*>(blk + 8);
    const uint32_t s2 = *reinterpret_cast<const uint32_t*>(blk + 12);
    const float d = f16_bits(dm & 0xFFFF);
    const float dmin = f16_bits(dm >> 16);
    int sc0, m0, sc1, m1;
    q4k_scale_min(s0, s1, s2, 2 * j, sc0, m0);
    q4k_scale_min(s0, s1, s2, 2 * j + 1, sc1, m1);
    const float dl0 = __fmul_rn(d, (float)sc0), ml0 = __fmul_rn(dmin, (float)m0);
    const float dl1 = __fmul_rn(d, (float)sc1), ml1 = __fmul_rn(dmin, (float)m1);
    const uint4* qs = reinterpret_cast<const uint4*>(blk + 16 + 32 * j);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        const uint4 u = qs[v];
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
            // bytes l0..l0+3 of the group: 4 low-nibble weights at column
            // l0, 4 high-nibble weights at 32 + l0, each stored as 8 bytes
            const int l0 = v * 16 + wi * 4;
            __nv_bfloat16 lo[4], hi[4];
#pragma unroll
            for (int bi = 0; bi < 4; ++bi) {
                const int q = (words[wi] >> (8 * bi)) & 0xFF;
                lo[bi] = __float2bfloat16(q4k_weight(dl0, ml0, q & 0xF));
                hi[bi] = __float2bfloat16(q4k_weight(dl1, ml1, q >> 4));
            }
            *reinterpret_cast<uint2*>(dst + l0) = *reinterpret_cast<const uint2*>(lo);
            *reinterpret_cast<uint2*>(dst + 32 + l0) = *reinterpret_cast<const uint2*>(hi);
        }
    }
}

// Q6_K: half = chunk c (elements c*128 .. c*128+127). Thread t owns row
// t/2 and positions l = g*16 .. g*16+15 of the chunk's 32, for all four
// quarters (tile column quarter*32 + l).
__device__ __forceinline__ void dequant_q6k_tile(const QgDesc& D, int n0, int sb, int c,
                                                 __nv_bfloat16* Bs) {
    const int r = threadIdx.x >> 1;
    const int g = threadIdx.x & 1;
    __nv_bfloat16* dst = Bs + r * QG_LDS;
    const int row = n0 + r;
    if (row >= D.n) {
#pragma unroll
        for (int qt = 0; qt < 4; ++qt)
#pragma unroll
            for (int i = 0; i < 16; ++i) dst[qt * 32 + g * 16 + i] = __float2bfloat16(0.f);
        return;
    }
    const uint8_t* blk = D.w + (size_t)row * D.row_bytes + (size_t)sb * Q6K_BYTES;
    const int8_t* scales = reinterpret_cast<const int8_t*>(blk + 192);
    const float d = f16_bits(*reinterpret_cast<const uint16_t*>(blk + 208));
    float dl[4];
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) dl[qt] = __fmul_rn(d, (float)scales[c * 8 + qt * 2 + g]);
    const uint16_t* ql0 = reinterpret_cast<const uint16_t*>(blk + c * 64 + g * 16);
    const uint16_t* ql1 = reinterpret_cast<const uint16_t*>(blk + c * 64 + 32 + g * 16);
    const uint16_t* qhp = reinterpret_cast<const uint16_t*>(blk + 128 + c * 32 + g * 16);
#pragma unroll
    for (int i2 = 0; i2 < 8; ++i2) {
        const uint32_t a = ql0[i2], b = ql1[i2], h2 = qhp[i2];
        __nv_bfloat16 wv[4][2];  // [quarter][t]: positions l, l+1 of the pair
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int b0 = (a >> (8 * t)) & 0xFF;
            const int b1 = (b >> (8 * t)) & 0xFF;
            const int h = (h2 >> (8 * t)) & 0xFF;
            const int qv[4] = {
                ((b0 & 0xF) | (((h >> 0) & 3) << 4)) - 32,
                ((b1 & 0xF) | (((h >> 2) & 3) << 4)) - 32,
                ((b0 >> 4) | (((h >> 4) & 3) << 4)) - 32,
                ((b1 >> 4) | (((h >> 6) & 3) << 4)) - 32,
            };
#pragma unroll
            for (int qt = 0; qt < 4; ++qt)
                wv[qt][t] = __float2bfloat16(__fmul_rn(dl[qt], (float)qv[qt]));
        }
        const int l = g * 16 + 2 * i2;
#pragma unroll
        for (int qt = 0; qt < 4; ++qt)
            *reinterpret_cast<__nv_bfloat162*>(dst + qt * 32 + l) =
                *reinterpret_cast<const __nv_bfloat162*>(wv[qt]);
    }
}

__global__ void __launch_bounds__(QG_THREADS)
qgemm_kernel(const QgParams p, const __nv_bfloat16* __restrict__ x) {
    __shared__ __align__(128) unsigned char smem[2 * QG_BM * QG_LDS * 2];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Bs = As + QG_BM * QG_LDS;
    float* Cs = reinterpret_cast<float*>(smem);  // epilogue, after the K loop

    int t = 0;
#pragma unroll
    for (int i = 1; i < QG_MAX_DESC; ++i)
        if (i < p.n_desc && (int)blockIdx.x >= p.d[i].block0) t = i;
    const QgDesc& D = p.d[t];
    const int n0 = ((int)blockIdx.x - D.block0) * QG_BN;
    const int m0 = (int)blockIdx.y * QG_BM;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < p.K; k0 += QG_BK) {
        // activation tile [64][128], 8 bf16 (16 bytes) a load
        for (int i = threadIdx.x; i < QG_BM * QG_BK / 8; i += QG_THREADS) {
            const int r = i / (QG_BK / 8), c = (i % (QG_BK / 8)) * 8;
            const int m = m0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (m < p.B) v = *reinterpret_cast<const uint4*>(x + (size_t)m * p.K + k0 + c);
            *reinterpret_cast<uint4*>(As + r * QG_LDS + c) = v;
        }
        const int sb = k0 / QK_K, half = (k0 / QG_BK) & 1;
        if (D.kind == KIND_Q4_K) dequant_q4k_tile(D, n0, sb, half, Bs);
        else dequant_q6k_tile(D, n0, sb, half, Bs);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < QG_BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * QG_LDS + kk, QG_LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * QG_LDS + kk, QG_LDS);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * QG_LDC + wn * 32 + j * 16,
                                    acc[i][j], QG_LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < QG_BM * QG_BN; i += QG_THREADS) {
        const int r = i / QG_BN, c = i % QG_BN;
        const int m = m0 + r, n = n0 + c;
        if (m < p.B && n < D.n) D.out[(size_t)m * D.n + n] = Cs[r * QG_LDC + c];
    }
}

// x [B, K] bf16, contiguous; weight t: w[t] [n[t], K/256 blocks], kind[t];
// out[t] [B, n[t]] f32.
LCG_EXPORT int lcg_qgemm(const void* x, int x_dtype, int B, int K, int n_desc,
                         const void* const* w, void* const* out, const int* kind,
                         const int* n, void* stream) {
    if (x_dtype != DT_BF16 || n_desc < 1 || n_desc > QG_MAX_DESC || B < 1 || K % QK_K)
        return static_cast<int>(cudaErrorInvalidValue);
    QgParams p{};
    p.n_desc = n_desc;
    p.B = B;
    p.K = K;
    int blocks = 0;
    for (int t = 0; t < n_desc; ++t) {
        if (kind[t] != KIND_Q4_K && kind[t] != KIND_Q6_K) return static_cast<int>(cudaErrorInvalidValue);
        p.d[t].w = static_cast<const uint8_t*>(w[t]);
        p.d[t].out = static_cast<float*>(out[t]);
        p.d[t].kind = kind[t];
        p.d[t].n = n[t];
        p.d[t].row_bytes = (K / QK_K) * (kind[t] == KIND_Q4_K ? Q4K_BYTES : Q6K_BYTES);
        p.d[t].block0 = blocks;
        blocks += (n[t] + QG_BN - 1) / QG_BN;
    }
    const dim3 grid(blocks, (B + QG_BM - 1) / QG_BM);
    qgemm_kernel<<<grid, QG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const __nv_bfloat16*>(x));
    return static_cast<int>(cudaGetLastError());
}

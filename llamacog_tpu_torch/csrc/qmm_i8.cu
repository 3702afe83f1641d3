// qmm_i8 — int8 x int8 -> int32 prefill GEMM over the mmq planes, on wgmma,
// and the one-launch activation quantization in front of it.
//
// Replaces llamacog_tpu/ops/pallas/qmm_i8.py::_qmm_i8_call (_i8_kernel):
//   out[b, n] f32 = xs[b] * sum_g f32(xq[b, g] . qi8[n, g]) * ws8T[g, n]
// over the 512-column blocks g of K, with xq int8 [B, K] (one scale xs per
// row), qi8 int8 [N, K] and ws8T f32 [K / 512, N] (quant/mmq.py); and the
// XLA glue in front of it (qmm_i8, qmm_i8.py:100-120): one max-abs scale per
// activation row, xq = clamp(rint(x / xs), -127, 127).
//
// Bound on this card: at a 512-row prefill chunk the 8B gate_up does 120 G
// int8 operations on 179 MB, so operations (1979 TOP/s dense int8) bound it
// just above bytes (3.35 TB/s). Design:
//   * wgmma m64n128k32 .s32.s8.s8 with both operands K-major in shared
//     memory, as wgmma requires for 8-bit types: the weight rows are operand
//     A (64 a consumer warpgroup), 128 activation rows operand B. With the
//     weights on the M side a thread's accumulators span two weight rows,
//     so the fold below reads two weight scales a block of K.
//   * A ring of I8_STAGES stages of 128 K-bytes (one 128-byte swizzle row),
//     filled by TMA from one producer warp (cp.async.bulk.tensor, mbarriers
//     counting the bytes); the consumer warpgroups wait on a stage's full
//     barrier, run four wgmma on it and release it on its empty barrier once
//     the next stage's products are issued (wgmma.wait_group 1).
//   * The fold every 512 columns keeps the plain version's arithmetic: the
//     int32 block products (exact: |p| <= 127^2 * 512 < 2^24, so also exact
//     as f32) fold as acc + f32(p) * ws8T[g] for g = 0, 1, ... with
//     __fmul_rn / __fadd_rn, and the epilogue scales by xs: bit parity with
//     qmm_i8_plain. Split-K would reorder the f32 sums, so it is not taken.
//     Two int32 accumulator sets alternate by block of K: block g's products
//     run on the tensor cores while block g - 1's partials are converted and
//     folded, a quarter after each of g's four stages (I2F issues at 16 a
//     clock per SM, a quarter of the wgmma time of a block).
//   * Persistent blocks (one an SM) walk the output tiles in weight-strip
//     order, the activation tiles of a strip back to back (its weight bytes
//     leave device memory once); the producer runs ahead into the next tile
//     while the consumers store. A tile is 128 weight rows (two consumer
//     warpgroups, 232 registers each by setmaxnreg) or 64 (one); lcg_qmm_i8
//     takes 64 only where those tiles still leave no SM with two (the grid
//     rule of qgemm.cu).
// Rows past B and weight rows past N load as zeros (TMA's edge fill) and are
// not stored: B needs no padding.
#include <cuda.h>

#include "hopper.cuh"

constexpr int I8_BN = 128;      // activation rows a tile: the wgmma N
constexpr int I8_BK = 128;      // K bytes a stage: one 128-byte swizzle row
constexpr int I8_KB = 512;      // columns a weight scale (MMQ_KB)
constexpr int I8_GSTEPS = I8_KB / I8_BK;  // stages a scale block
constexpr int I8_STAGES = 6;

template <int WG>  // consumer warpgroups, 64 weight rows each
struct I8Tile {
    static constexpr int BM = 64 * WG;
    static constexpr int A_BYTES = BM * I8_BK;
    static constexpr int STAGE = A_BYTES + I8_BN * I8_BK;
    // and a producer warpgroup (one lane issues the copies): registers go to
    // a block in whole warpgroups, and setmaxnreg moves them per warpgroup
    static constexpr int THREADS = 128 * (WG + 1);
    static constexpr int SMEM = 1024 + I8_STAGES * STAGE + 2 * I8_STAGES * 8;
};

// The consumer's ring position: stage index, phase parity, and the stage
// whose release waits for the next stage's products to be issued.
struct I8Ring {
    int st = 0;
    uint32_t ph = 0;
    int held = -1;
};

// One block of 512 columns into `cur` (four stages), folding the previous
// block's partials `prv` (scales wprv) a quarter after each stage.
template <int WG>
__device__ __forceinline__ void i8_block(int (&cur)[64], int (&prv)[64], float (&facc)[64],
                                         const float (&wprv)[2], bool fold, bool first,
                                         uint8_t* smem, uint64_t* full, uint64_t* empty,
                                         I8Ring& ring, int wg) {
    using T = I8Tile<WG>;
#pragma unroll
    for (int s = 0; s < I8_GSTEPS; ++s) {
        mbar_wait(&full[ring.st], ring.ph);
        uint8_t* a = smem + ring.st * T::STAGE;
        const uint64_t da = sw128_desc(a + wg * 64 * I8_BK);
        const uint64_t db = sw128_desc(a + T::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < I8_BK / 32; ++kk)
            wgmma_s8_m64n128k32(cur, da + 2 * kk, db + 2 * kk, (s | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (ring.held >= 0) mbar_arrive(&empty[ring.held]);
        ring.held = ring.st;
        if (++ring.st == I8_STAGES) {
            ring.st = 0;
            ring.ph ^= 1;
        }
        if (fold) {
#pragma unroll
            for (int i = 16 * s; i < 16 * s + 16; ++i) {
                reg_fence(prv[i]);
                const float part = __fmul_rn(__int2float_rn(prv[i]), wprv[(i >> 1) & 1]);
                facc[i] = first ? part : __fadd_rn(facc[i], part);
            }
        }
    }
}

__device__ __forceinline__ void i8_fold_all(int (&acc)[64], float (&facc)[64], const float (&w)[2],
                                            bool first) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        reg_fence(acc[i]);
        const float part = __fmul_rn(__int2float_rn(acc[i]), w[(i >> 1) & 1]);
        facc[i] = first ? part : __fadd_rn(facc[i], part);
    }
}

template <int WG>
__global__ void __launch_bounds__(I8Tile<WG>::THREADS, 1)
qmm_i8_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
              const float* __restrict__ xs, const float* __restrict__ ws, float* __restrict__ out,
              int B, int N, int K) {
    using T = I8Tile<WG>;
    extern __shared__ uint8_t i8_smem_raw[];
    uint8_t* smem = align1024(i8_smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + I8_STAGES * T::STAGE);
    uint64_t* empty = full + I8_STAGES;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < I8_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 128 * WG);
        }
        fence_mbar_init();
    }
    __syncthreads();
    const int tiles_b = (B + I8_BN - 1) / I8_BN;
    const int tiles = tiles_b * ((N + T::BM - 1) / T::BM);
    const int n_st = K / I8_BK;

    if (warpgroup_index() == WG) {  // the producer warpgroup: one lane issues every copy
        // 2 consumer warpgroups need ~200 registers each, more than the
        // 168 an even split of 384 threads gives: the producer hands its over
        if constexpr (WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (warp == 4 * WG && lane == 0) {
            int st = 0;
            uint32_t ph = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int n0 = (tile / tiles_b) * T::BM, b0 = (tile % tiles_b) * I8_BN;
                for (int k = 0; k < n_st; ++k) {
                    mbar_wait(&empty[st], ph ^ 1);
                    uint8_t* a = smem + st * T::STAGE;
                    mbar_expect_tx(&full[st], T::STAGE);
                    tma_load_2d(a, &wmap, &full[st], k * I8_BK, n0);
                    tma_load_2d(a + T::A_BYTES, &xmap, &full[st], k * I8_BK, b0);
                    if (++st == I8_STAGES) {
                        st = 0;
                        ph ^= 1;
                    }
                }
            }
        }
        return;
    }

    if constexpr (WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int G = K / I8_KB;
    I8Ring ring;
    int acc0[64], acc1[64];
    float facc[64];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile / tiles_b) * T::BM, b0 = (tile % tiles_b) * I8_BN;
        const int nr = n0 + wg * 64 + (warp & 3) * 16 + g;  // weight rows nr, nr + 8
        float w0[2], w1[2];  // scales of the blocks in acc0 / acc1
        auto scales = [&](int gb, float (&w)[2]) {
            w[0] = nr < N ? __ldg(ws + (size_t)gb * N + nr) : 0.f;
            w[1] = nr + 8 < N ? __ldg(ws + (size_t)gb * N + nr + 8) : 0.f;
        };
        for (int gb = 0; gb < G; gb += 2) {
            scales(gb, w0);
            i8_block<WG>(acc0, acc1, facc, w1, gb > 0, gb == 1, smem, full, empty, ring, wg);
            if (gb + 1 < G) {
                scales(gb + 1, w1);
                i8_block<WG>(acc1, acc0, facc, w0, true, gb == 0, smem, full, empty, ring, wg);
            }
        }
        wgmma_wait<0>();
        mbar_arrive(&empty[ring.held]);
        ring.held = -1;
        if (G & 1) i8_fold_all(acc0, facc, w0, G == 1);
        else i8_fold_all(acc1, facc, w1, false);

        // epilogue: out[b, n] = facc * xs[b]; a warp's store covers 8
        // consecutive weight rows (32 bytes) of 4 activation rows
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int b = b0 + 8 * j + 2 * t + c;
                if (b >= B) continue;
                const float x = __ldg(xs + b);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int n = nr + 8 * h;
                    if (n < N) out[(size_t)b * N + n] = __fmul_rn(facc[4 * j + 2 * h + c], x);
                }
            }
    }
}

// ---------------------------------------------------------------------------
// The activation quantization (ops/cuda/qmm_i8.py::quantize_activations,
// bit for bit): one block a row; the row's max |x| by a block reduction,
// xs = amax * f32(1/127) (1 where 0), xq = clamp(rint(x / xs), -127, 127)
// with IEEE division.
constexpr int Q8_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(Q8_THREADS)
quantize_i8_kernel(const T* __restrict__ x, int K, int8_t* __restrict__ xq,
                   float* __restrict__ xs) {
    __shared__ float red[Q8_THREADS / 32];
    const T* xr = x + (size_t)blockIdx.x * K;
    float m = 0.f;
    for (int c = threadIdx.x * 8; c < K; c += Q8_THREADS * 8) {
        float v[8];
        load8(xr + c, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[i]));
    }
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0.f;
#pragma unroll
    for (int i = 0; i < Q8_THREADS / 32; ++i) m = fmaxf(m, red[i]);
    float s = __fmul_rn(m, __int_as_float(0x3C010204));  // f32(1/127)
    if (s == 0.f) s = 1.f;
    int8_t* qr = xq + (size_t)blockIdx.x * K;
    for (int c = threadIdx.x * 8; c < K; c += Q8_THREADS * 8) {
        float v[8];
        load8(xr + c, v);
        uint32_t q[2] = {0, 0};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
            q[i >> 2] |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu) << (8 * (i & 3));
        }
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(q[0], q[1]);
    }
    if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// Host side. The tensor maps are encoded through the driver entry point the
// runtime hands out, so the library links no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                             cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                cudaSuccess && q == cudaDriverEntryPointSuccess)
#endif
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// rows x cols int8, row-major, boxes of 128 columns x box_rows rows, 128-byte swizzle
static bool i8_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols};
    const cuuint32_t box[2] = {(cuuint32_t)I8_BK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

static int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

template <int WG>
static int launch_i8(const void* xq, const void* xs, const void* qi8, const void* ws8T, void* out,
                     int B, int N, int K, cudaStream_t stream) {
    using T = I8Tile<WG>;
    static bool attr_set = false;  // once per instantiation, not per launch
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            qmm_i8_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        attr_set = true;
    }
    CUtensorMap wmap, xmap;
    if (!i8_map(&wmap, qi8, N, K, T::BM) || !i8_map(&xmap, xq, B, K, I8_BN))
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = ((B + I8_BN - 1) / I8_BN) * ((N + T::BM - 1) / T::BM);
    const int grid = tiles < sm_count() ? tiles : sm_count();
    qmm_i8_kernel<WG><<<grid, T::THREADS, T::SMEM, stream>>>(
        wmap, xmap, static_cast<const float*>(xs), static_cast<const float*>(ws8T),
        static_cast<float*>(out), B, N, K);
    return static_cast<int>(cudaGetLastError());
}

// The tile height the grid gives (the rule of qgemm.cu): 64 weight rows
// where their tiles still give every block an SM of its own, else 128 (two
// consumer warpgroups share each activation tile: half the L2 traffic a
// product).
static int i8_wg(int B, int N) {
    const int tb = (B + I8_BN - 1) / I8_BN;
    return (N + 63) / 64 * tb <= sm_count() ? 1 : 2;
}

// xq int8 [B, K], xs f32 [B], qi8 int8 [N, K], ws8T f32 [K / 512, N], out f32
// [B, N]; all contiguous, xq and qi8 16-byte aligned; K a multiple of 512,
// N even. wg: 1 or 2 consumer warpgroups (64- or 128-row weight tiles), 0
// for the grid rule.
LCG_EXPORT int lcg_qmm_i8(const void* xq, const void* xs, const void* qi8, const void* ws8T,
                          void* out, int B, int N, int K, int wg, void* stream) {
    if (B < 1 || N < 2 || N % 2 || K < I8_KB || K % I8_KB || wg < 0 || wg > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    if (wg == 0) wg = i8_wg(B, N);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return wg == 1 ? launch_i8<1>(xq, xs, qi8, ws8T, out, B, N, K, s)
                   : launch_i8<2>(xq, xs, qi8, ws8T, out, B, N, K, s);
}

// The weight rows of a tile lcg_qmm_i8 takes at these shapes (64 or 128).
LCG_EXPORT int lcg_qmm_i8_tile_rows(int B, int N) { return 64 * i8_wg(B, N); }

// x [B, K] f32 (dtype 0) or bf16 (1), contiguous, 16-byte aligned, K a
// multiple of 8 -> xq int8 [B, K], xs f32 [B].
LCG_EXPORT int lcg_quantize_i8(const void* x, int dtype, int B, int K, void* xq, void* xs,
                               void* stream) {
    if (B < 1 || K < 8 || K % 8 || (dtype != DT_F32 && dtype != DT_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DT_F32)
        quantize_i8_kernel<float><<<B, Q8_THREADS, 0, s>>>(
            static_cast<const float*>(x), K, static_cast<int8_t*>(xq), static_cast<float*>(xs));
    else
        quantize_i8_kernel<__nv_bfloat16><<<B, Q8_THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), K, static_cast<int8_t*>(xq),
            static_cast<float*>(xs));
    return static_cast<int>(cudaGetLastError());
}

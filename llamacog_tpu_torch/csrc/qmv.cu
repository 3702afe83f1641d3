// qmv — fused dequant x matvec over GGUF wire-format weights: Q4_K, Q6_K,
// Q8_0, Q5_K, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, the codebook kinds
// IQ4_NL, IQ4_XS, IQ3_XXS, IQ3_S, IQ2_S, IQ2_XXS, IQ2_XS, IQ1_S, IQ1_M and
// the ternary TQ1_0, TQ2_0.
//
// Replaces (llamacog_tpu/ops/pallas/qmm.py):
//   * _qmm_call at B <= 8 (_qmm_kernel -> _tile_matvec, the decoders of
//     TILE_DECODERS but the TPU repacks Q4_KS4, Q4_KC, Q6_KP): out[B, N]
//     f32 = x[B, K] @ dequant(W)[N, K]^T;
//   * _qmm_multi_call (_qmm_multi_kernel): several weights sharing one x in
//     ONE launch. Here a launch takes up to QMV_MAX_DESC weight descriptors
//     and its warps share all of their row groups — the counterpart of the
//     Pallas phase-partitioned grid.
//
// Bound on this card: bytes. At decode batch the product does 2 flops per
// weight against 0.56 (Q4_K) or 0.82 (Q6_K) bytes per weight, far below the
// H100's ~295 flops/byte ridge, so the least time is the weight bytes over
// 3.35 TB/s. What stands in the way is instructions: a decode step has
// ~7.5 G weights, and forming each as (d*sc)*float(q) - dmin*m takes ~10
// instructions with an int->float conversion (16 a clock per SM) among
// them, longer to issue than the weights' bytes take to arrive.
//
// Design. The weights are read once, straight from the GGUF blocks, and
// never formed: as the TPU kernel (qmm.py _tile_matvec), the raw levels are
// dotted with x per sub-block part, the part's scale applied once to that
// sum, and its offset folded into one product with the part's sum of x
// (common.cuh::qmv_walk). A level plus a bias (16 + q for Q4_K, 64 + q for
// Q6_K) becomes an exact f32 by one byte permute into the float's high
// mantissa byte — no conversion, no add — and the bias folds into the
// offset. A warp owns 4 Q4_K rows (2 Q6_K rows, or 2 at B > 1) a group and
// walks their superblocks four at a time, eight lanes a superblock and a
// 32-weight slice a lane; partial sums are reduced with warp shuffles.
// The grid is what the card holds at once, and each warp walks its groups
// as one flat sequence of steps, loading the next step's blocks before this
// one's arithmetic, across the ends of groups too.
// Kernel and plain version differ in the order of the f32 sums only.
// A launch whose weights are all of a Q4_K_M file's kinds (Q4_K, Q6_K,
// Q8_0, Q5_K) takes the instantiation of those four alone; a launch with
// a codebook kind the one of those four and the codebook kinds; a launch
// with a 1-2 bit or ternary kind the one of those four, IQ3_S and the six
// kinds; a launch with any other kind the one of the ten others: each has
// the register count of its widest kind (KSET, common.cuh). The codebook
// and ternary kinds' levels are the signed integers of their tables
// (common.cuh::iq_slot), dotted with x as Q8_0's, with no offset.
// blockIdx.y walks x in chunks of QMV_MAX_B rows, so f32 activations of any
// batch take this f32 path too (streaming the weights once per chunk).
#include "common.cuh"

constexpr int QMV_MAX_DESC = 4;
constexpr int QMV_MAX_B = 8;

struct QmvDesc {
    const uint8_t* w;  // [n, row_bytes] wire blocks
    float* out;        // [B, n] f32
    int kind;
    int n;
    int row_bytes;
};

struct QmvParams {
    QmvDesc d[QMV_MAX_DESC];
    int n_desc;
    int B;
    int K;
};

// Row groups of an n-row weight of `kind` (every kind but Q4_K has Q6_K's rows).
template <int NB>
__host__ __device__ inline int qmv_groups(int kind, int n) {
    const int R = kind == KIND_Q4_K ? qmv_rows_per_warp<NB, KIND_Q4_K>()
                                    : qmv_rows_per_warp<NB, KIND_Q6_K>();
    return (n + R - 1) / R;
}

template <int KIND, int NB, typename TX>
__device__ __forceinline__ void qmv_desc(const QmvDesc& D, const TX* x, int B, int K, int g,
                                         int nw, int groups, float* out) {
    qmv_walk<KIND, NB, qmv_rows_per_warp<NB, KIND>(), TX>(D.w, D.n, D.row_bytes, x, B, K, g, nw,
                                                          groups, out);
}

// The grid is what the card holds at once. Each weight's row groups are
// shared round-robin by the warps, starting where the weight before ended,
// so the load evens out across weights; blockIdx.y takes NB activation rows.
template <int NB, typename TX, int KSET>
__global__ void __launch_bounds__(QMV_WARPS * 32)
qmv_kernel(const QmvParams p, const TX* __restrict__ x) {
    const int gw = (int)blockIdx.x * QMV_WARPS + (int)(threadIdx.x >> 5);
    const int nw = (int)gridDim.x * QMV_WARPS;
    const int b0 = (int)blockIdx.y * NB;  // first activation row of this chunk
    const int B = min(NB, p.B - b0);
    x += (size_t)b0 * p.K;
    int first = 0;  // row groups of the weights before this one
    for (int t = 0; t < p.n_desc; ++t) {
        const QmvDesc& D = p.d[t];
        const int groups = qmv_groups<NB>(D.kind, D.n);
        const int g = ((gw - first) % nw + nw) % nw;
        float* out = D.out + (size_t)b0 * D.n;
#define QMV_CASE(KIND) \
    case KIND: qmv_desc<KIND, NB>(D, x, B, p.K, g, nw, groups, out); break;
        if constexpr (KSET == KS_Q4KM) {
            switch (D.kind) {
                QMV_CASE(KIND_Q4_K) QMV_CASE(KIND_Q6_K) QMV_CASE(KIND_Q8_0)
                default: qmv_desc<KIND_Q5_K, NB>(D, x, B, p.K, g, nw, groups, out); break;
            }
        } else if constexpr (KSET == KS_ALL) {
            switch (D.kind) {
                QMV_CASE(KIND_Q4_K) QMV_CASE(KIND_Q6_K) QMV_CASE(KIND_Q8_0) QMV_CASE(KIND_Q5_K)
                QMV_CASE(KIND_Q4_0) QMV_CASE(KIND_Q4_1) QMV_CASE(KIND_Q5_0) QMV_CASE(KIND_Q5_1)
                QMV_CASE(KIND_Q2_K)
                default: qmv_desc<KIND_Q3_K, NB>(D, x, B, p.K, g, nw, groups, out); break;
            }
        } else if constexpr (KSET == KS_IQ) {
            switch (D.kind) {
                QMV_CASE(KIND_Q4_K) QMV_CASE(KIND_Q6_K) QMV_CASE(KIND_Q8_0) QMV_CASE(KIND_Q5_K)
                QMV_CASE(KIND_IQ4_NL) QMV_CASE(KIND_IQ4_XS) QMV_CASE(KIND_IQ3_XXS)
                QMV_CASE(KIND_IQ3_S)
                default: qmv_desc<KIND_IQ2_S, NB>(D, x, B, p.K, g, nw, groups, out); break;
            }
        } else {
            switch (D.kind) {
                QMV_CASE(KIND_Q4_K) QMV_CASE(KIND_Q6_K) QMV_CASE(KIND_Q8_0) QMV_CASE(KIND_Q5_K)
                QMV_CASE(KIND_IQ3_S) QMV_CASE(KIND_IQ2_XXS) QMV_CASE(KIND_IQ2_XS)
                QMV_CASE(KIND_IQ1_S) QMV_CASE(KIND_IQ1_M) QMV_CASE(KIND_TQ1_0)
                default: qmv_desc<KIND_TQ2_0, NB>(D, x, B, p.K, g, nw, groups, out); break;
            }
        }
#undef QMV_CASE
        first += groups;
    }
}

// Blocks of kernel K that the card holds at once (queried once).
template <typename KERNEL>
static int resident_blocks(KERNEL kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, QMV_WARPS * 32, 0);
    return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <int NB, typename TX, int KSET>
static int launch(const QmvParams& p, const TX* x, const int* n, cudaStream_t stream) {
    static const int resident = resident_blocks(qmv_kernel<NB, TX, KSET>);
    int groups = 0;
    for (int t = 0; t < p.n_desc; ++t) groups += qmv_groups<NB>(p.d[t].kind, n[t]);
    const int blocks = (groups + QMV_WARPS - 1) / QMV_WARPS;  // enough for every group at once
    const dim3 grid(min(blocks, resident), (p.B + NB - 1) / NB);
    qmv_kernel<NB, TX, KSET><<<grid, QMV_WARPS * 32, 0, stream>>>(p, x);
    return static_cast<int>(cudaGetLastError());
}

// qmv's instantiations (a Q4_K + Q6_K launch takes KS_Q4KM's kernel)
constexpr unsigned QMV_SETS = 1u << KS_Q4KM | 1u << KS_ALL | 1u << KS_IQ | 1u << KS_IQ_LOW;

template <int NB, typename TX>
static int launch_kinds(const QmvParams& p, const TX* x, const int* n, int set,
                        cudaStream_t stream) {
    return set == KS_Q4KM ? launch<NB, TX, KS_Q4KM>(p, x, n, stream)
         : set == KS_ALL  ? launch<NB, TX, KS_ALL>(p, x, n, stream)
         : set == KS_IQ   ? launch<NB, TX, KS_IQ>(p, x, n, stream)
                          : launch<NB, TX, KS_IQ_LOW>(p, x, n, stream);
}

template <int NB>
static int launch_x(const QmvParams& p, const void* x, int x_dtype, const int* n, int set,
                    cudaStream_t stream) {
    if (x_dtype == DT_BF16)
        return launch_kinds<NB>(p, static_cast<const __nv_bfloat16*>(x), n, set, stream);
    return launch_kinds<NB>(p, static_cast<const float*>(x), n, set, stream);
}

// x [B, K] (f32 or bf16, contiguous); weight t: w[t] [n[t], ceil(K/256)
// runs], kind[t]; out[t] [B, n[t]] f32. K is a multiple of 256, or of 32
// where every kind is a 32-weight-block kind (rows padded to a whole run).
LCG_EXPORT int lcg_qmv(const void* x, int x_dtype, int B, int K, int n_desc,
                       const void* const* w, void* const* out, const int* kind,
                       const int* n, void* stream) {
    if (n_desc < 1 || n_desc > QMV_MAX_DESC || B < 1 || !k_fits(K, kind, n_desc))
        return static_cast<int>(cudaErrorInvalidValue);
    QmvParams p{};
    p.n_desc = n_desc;
    p.B = B;
    p.K = K;
    for (int t = 0; t < n_desc; ++t) {
        if (kind_sb_bytes(kind[t]) == 0) return static_cast<int>(cudaErrorInvalidValue);
        p.d[t].w = static_cast<const uint8_t*>(w[t]);
        p.d[t].out = static_cast<float*>(out[t]);
        p.d[t].kind = kind[t];
        p.d[t].n = n[t];
        p.d[t].row_bytes = ((K + QK_K - 1) / QK_K) * kind_sb_bytes(kind[t]);
    }
    const int set = launch_set(kind, n_desc, QMV_SETS);
    if (set < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return B == 1 ? launch_x<1>(p, x, x_dtype, n, set, s)
                  : launch_x<QMV_MAX_B>(p, x, x_dtype, n, set, s);
}

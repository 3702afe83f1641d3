// qmv_id — expert-gathered fused dequant x matvec over stacked GGUF wire
// experts (the MoE decode product, ggml's mul_mat_id at few rows).
//
// Replaces (llamacog_tpu/ops/pallas/qmm_id.py):
//   * _gather_call (qmm_gather, _gather_kernel): out[s, N] f32 =
//     x[s, K] @ dequant(W[ids[s]])[N, K]^T for S <= 32 (token, slot) rows,
//     W a stack of n_exp experts stored as wire blocks [n_exp * N, row_bytes];
//   * _offset_call (qmm_gather_offset, _offset_kernel): the same contract,
//     which the TPU ran as one launch per row to reuse qmm's DMA pipeline.
//     Here it is one launch of this kernel over all rows.
//
// Bound on this card: bytes. Each row does 2 flops per weight of one expert
// against 0.56 (Q4_K) or 0.82 (Q6_K) bytes per weight, so the least time is
// the selected experts' bytes (each distinct expert once) over 3.35 TB/s.
// Every weight kind of qmv.cu: a Q4_K or Q6_K stack (a Q4_K_M file's
// experts) takes the instantiation of those two alone, a codebook kind's
// stack the one of the five codebook kinds, a 1-2 bit or ternary kind's the
// one of those six, every other kind the one of the other eight, so each
// set leaves the others' registers as they were.
// Design: qmv.cu's row walk (common.cuh::qmv_walk: raw levels dotted with x
// per sub-block part, the scale applied once and the offset folded against
// the part's sum of x, f32 throughout), 2 rows a warp and one group a warp,
// with one activation row per blockIdx.x. The block reads its row's
// expert id from device memory (the TPU kernel's scalar prefetch), so no
// routing result reaches the host, and walks only that expert's rows at
// base ids[s] * N. A row whose id lies outside [0, n_exp) gets zeros and
// reads no weights (the ragged route's padding tiles, ops/cuda/qmm_id.py).
// The rows are the fast grid dimension, so the blocks of all S rows for
// one block of weight rows run together and rows on one expert share its
// bytes through L2. Each row still decodes its expert's weights itself,
// and at S = 32 that decode work, not the bytes, sets the time (PERF.md):
// decoding once per expert for all its rows is later work.
#include "common.cuh"

constexpr int QMV_ID_ROWS = 2;  // rows a warp

template <typename TX, int KSET>
__global__ void __launch_bounds__(QMV_WARPS * 32)
qmv_id_kernel(const uint8_t* __restrict__ w, const TX* __restrict__ x,
              const int* __restrict__ ids, float* __restrict__ out, int kind, int n_exp,
              int N, int K, int row_bytes) {
    constexpr int R = QMV_ID_ROWS;
    const int s = blockIdx.x;
    const int g = (int)blockIdx.y * QMV_WARPS + (int)(threadIdx.x >> 5);  // one group a warp
    const int groups = (N + R - 1) / R;
    const int e = ids[s];
    float* o = out + (size_t)s * N;
    if (e >= 0 && e < n_exp) {
        const uint8_t* we = w + (size_t)e * N * row_bytes;
        const TX* xs = x + (size_t)s * K;
#define QID_CASE(KIND) \
    case KIND: qmv_walk<KIND, 1, R, TX>(we, N, row_bytes, xs, 1, K, g, groups, groups, o); break;
        if constexpr (KSET == KS_Q4K_Q6K) {
            if (kind == KIND_Q4_K)
                qmv_walk<KIND_Q4_K, 1, R, TX>(we, N, row_bytes, xs, 1, K, g, groups, groups, o);
            else
                qmv_walk<KIND_Q6_K, 1, R, TX>(we, N, row_bytes, xs, 1, K, g, groups, groups, o);
        } else if constexpr (KSET == KS_ALL) {
            switch (kind) {
                QID_CASE(KIND_Q8_0) QID_CASE(KIND_Q5_K) QID_CASE(KIND_Q4_0) QID_CASE(KIND_Q4_1)
                QID_CASE(KIND_Q5_0) QID_CASE(KIND_Q5_1) QID_CASE(KIND_Q2_K)
                default:
                    qmv_walk<KIND_Q3_K, 1, R, TX>(we, N, row_bytes, xs, 1, K, g, groups, groups, o);
                    break;
            }
        } else if constexpr (KSET == KS_IQ) {
            switch (kind) {
                QID_CASE(KIND_IQ4_NL) QID_CASE(KIND_IQ4_XS) QID_CASE(KIND_IQ3_XXS)
                QID_CASE(KIND_IQ3_S)
                default:
                    qmv_walk<KIND_IQ2_S, 1, R, TX>(we, N, row_bytes, xs, 1, K, g, groups, groups, o);
                    break;
            }
        } else {
            switch (kind) {
                QID_CASE(KIND_IQ2_XXS) QID_CASE(KIND_IQ2_XS) QID_CASE(KIND_IQ1_S)
                QID_CASE(KIND_IQ1_M) QID_CASE(KIND_TQ1_0)
                default:
                    qmv_walk<KIND_TQ2_0, 1, R, TX>(we, N, row_bytes, xs, 1, K, g, groups, groups, o);
                    break;
            }
        }
#undef QID_CASE
    } else if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (g * R + r < N) o[g * R + r] = 0.f;
    }
}

// qmv_id's instantiations (Q8_0 and Q5_K stacks take KS_ALL's kernel)
constexpr unsigned QMV_ID_SETS = 1u << KS_Q4K_Q6K | 1u << KS_ALL | 1u << KS_IQ | 1u << KS_IQ_LOW;

template <typename TX>
static void launch_id(dim3 grid, cudaStream_t s, const uint8_t* w, const void* x, const int* ids,
                      float* out, int kind, int set, int n_exp, int N, int K, int row_bytes) {
    const TX* xt = static_cast<const TX*>(x);
    if (set == KS_Q4K_Q6K)
        qmv_id_kernel<TX, KS_Q4K_Q6K><<<grid, QMV_WARPS * 32, 0, s>>>(w, xt, ids, out, kind, n_exp,
                                                                      N, K, row_bytes);
    else if (set == KS_IQ)
        qmv_id_kernel<TX, KS_IQ><<<grid, QMV_WARPS * 32, 0, s>>>(w, xt, ids, out, kind, n_exp, N,
                                                                 K, row_bytes);
    else if (set == KS_IQ_LOW)
        qmv_id_kernel<TX, KS_IQ_LOW><<<grid, QMV_WARPS * 32, 0, s>>>(w, xt, ids, out, kind, n_exp,
                                                                     N, K, row_bytes);
    else
        qmv_id_kernel<TX, KS_ALL><<<grid, QMV_WARPS * 32, 0, s>>>(w, xt, ids, out, kind, n_exp, N,
                                                                  K, row_bytes);
}

// x [S, K] (f32 or bf16, contiguous); w [n_exp * N, ceil(K/256) runs] of
// `kind` (any; K a multiple of 256, or of 32 for a 32-weight-block kind,
// rows padded to a whole run); ids [S] int32 on the device; out [S, N] f32.
LCG_EXPORT int lcg_qmv_id(const void* x, int x_dtype, int S, int K, const void* w, int kind,
                          int n_exp, int N, const void* ids, void* out, void* stream) {
    constexpr int rows = QMV_WARPS * QMV_ID_ROWS;  // output rows a block
    const int row_blocks = (N + rows - 1) / rows;
    if (S < 1 || !k_fits(K, &kind, 1) || n_exp < 1 || N < 1 || row_blocks > 65535 ||
        kind_sb_bytes(kind) == 0 || (x_dtype != DT_F32 && x_dtype != DT_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    const int set = launch_set(&kind, 1, QMV_ID_SETS);
    if (set < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int row_bytes = ((K + QK_K - 1) / QK_K) * kind_sb_bytes(kind);
    const dim3 grid(S, row_blocks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* wq = static_cast<const uint8_t*>(w);
    const int* id = static_cast<const int*>(ids);
    float* o = static_cast<float*>(out);
    if (x_dtype == DT_BF16)
        launch_id<__nv_bfloat16>(grid, s, wq, x, id, o, kind, set, n_exp, N, K, row_bytes);
    else
        launch_id<float>(grid, s, wq, x, id, o, kind, set, n_exp, N, K, row_bytes);
    return static_cast<int>(cudaGetLastError());
}

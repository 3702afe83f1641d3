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
// Design: qmv.cu's matvec (common.cuh::qmv_rows, the same slice decoders,
// f32 operands, every weight formed bit for bit as the plain dequant forms
// it) with one activation row per blockIdx.x. The block reads its row's
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

template <typename TX>
__global__ void __launch_bounds__(QMV_WARPS * 32)
qmv_id_kernel(const uint8_t* __restrict__ w, const TX* __restrict__ x,
              const int* __restrict__ ids, float* __restrict__ out, int kind, int n_exp,
              int N, int K, int row_bytes) {
    const int s = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = (int)blockIdx.y * QMV_BLOCK_ROWS + warp * QMV_ROWS;
    const int e = ids[s];
    float acc[QMV_ROWS][1];
#pragma unroll
    for (int r = 0; r < QMV_ROWS; ++r) acc[r][0] = 0.f;
    if (e >= 0 && e < n_exp && row0 < N) {
        const uint8_t* we = w + (size_t)e * N * row_bytes;
        const TX* xs = x + (size_t)s * K;
        if (kind == KIND_Q4_K) qmv_rows<KIND_Q4_K, 1, TX>(we, N, row_bytes, xs, 1, K, row0, acc);
        else qmv_rows<KIND_Q6_K, 1, TX>(we, N, row_bytes, xs, 1, K, row0, acc);
    }
#pragma unroll
    for (int r = 0; r < QMV_ROWS; ++r) {
        const float v = warp_sum(acc[r][0]);
        if (lane == 0 && row0 + r < N) out[(size_t)s * N + row0 + r] = v;
    }
}

// x [S, K] (f32 or bf16, contiguous); w [n_exp * N, K/256 blocks] of `kind`;
// ids [S] int32 on the device; out [S, N] f32.
LCG_EXPORT int lcg_qmv_id(const void* x, int x_dtype, int S, int K, const void* w, int kind,
                          int n_exp, int N, const void* ids, void* out, void* stream) {
    const int row_blocks = (N + QMV_BLOCK_ROWS - 1) / QMV_BLOCK_ROWS;
    if (S < 1 || K < QK_K || K % QK_K || n_exp < 1 || N < 1 || row_blocks > 65535 ||
        (kind != KIND_Q4_K && kind != KIND_Q6_K) || (x_dtype != DT_F32 && x_dtype != DT_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    const int row_bytes = (K / QK_K) * (kind == KIND_Q4_K ? Q4K_BYTES : Q6K_BYTES);
    const dim3 grid(S, row_blocks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* wq = static_cast<const uint8_t*>(w);
    const int* id = static_cast<const int*>(ids);
    float* o = static_cast<float*>(out);
    if (x_dtype == DT_BF16)
        qmv_id_kernel<__nv_bfloat16><<<grid, QMV_WARPS * 32, 0, s>>>(
            wq, static_cast<const __nv_bfloat16*>(x), id, o, kind, n_exp, N, K, row_bytes);
    else
        qmv_id_kernel<float><<<grid, QMV_WARPS * 32, 0, s>>>(
            wq, static_cast<const float*>(x), id, o, kind, n_exp, N, K, row_bytes);
    return static_cast<int>(cudaGetLastError());
}

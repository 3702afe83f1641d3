// qgemm_id — grouped fused dequant x GEMM over expert-sorted rows (the MoE
// prefill product, ggml's mul_mat_id at many rows).
//
// Replaces (llamacog_tpu/ops/pallas/qmm_id.py): _ragged_call (qmm_ragged,
// _ragged_kernel): out[S_pad, N] f32 = xs @ bf16(dequant(W[e]))^T tile by
// tile, where token tile i (rows i*64 .. i*64+63 of the expert-sorted,
// per-expert padded xs) belongs to expert e = tile_expert[i] of the stack W
// (wire blocks [n_exp * N, row_bytes]). bf16 operands, f32 accumulation.
//
// Bound on this card: at the 128-token Mixtral prefill (256 (token, slot)
// rows, s_pad 768) the used experts' weight bytes (each read once) over
// 3.35 TB/s exceed the real rows' flops over the 989 TFLOP/s bf16 peak:
// bytes, 0.158 ms against 0.061 ms for gate_up. Design: qgemm.cu's 64 x 64
// WMMA tile (qgemm_tile.cuh) with the weight base picked per blockIdx.y:
// the block reads tile_expert[blockIdx.y] from device memory (the TPU
// kernel's scalar prefetch) and runs the tile against that expert's rows at
// base e * N. A tile whose expert lies outside [0, n_exp) is a padding tile
// past the last used expert's padded end: its rows are all zero, so the
// block writes zeros and streams no weights (the TPU clipped such tiles to
// the last expert and streamed it again for each). Each (tile, N-block)
// decodes its weights once, so an expert with several tiles is decoded once
// per tile (from L2 after the first); no pipelining of loads yet.
#include "qgemm_tile.cuh"

__global__ void __launch_bounds__(QG_THREADS)
qgemm_id_kernel(const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ tile_expert, float* __restrict__ out, int kind,
                int n_exp, int S_pad, int N, int K, int row_bytes) {
    const int m0 = (int)blockIdx.y * QG_BM, n0 = (int)blockIdx.x * QG_BN;
    const int e = tile_expert[blockIdx.y];
    if (e < 0 || e >= n_exp) {
        for (int i = threadIdx.x; i < QG_BM * QG_BN; i += QG_THREADS) {
            const int col = n0 + i % QG_BN;
            if (col < N) out[(size_t)(m0 + i / QG_BN) * N + col] = 0.f;
        }
        return;
    }
    qgemm_tile(w + (size_t)e * N * row_bytes, kind, N, row_bytes, x, S_pad, K, m0, n0, out);
}

// xs [S_pad, K] bf16, contiguous, S_pad a multiple of tt = 64; w
// [n_exp * N, K/256 blocks] of `kind`; tile_expert [S_pad / tt] int32 on the
// device; out [S_pad, N] f32.
LCG_EXPORT int lcg_qgemm_id(const void* x, int x_dtype, int S_pad, int K, const void* w,
                            int kind, int n_exp, int N, const void* tile_expert, int tt,
                            void* out, void* stream) {
    if (x_dtype != DT_BF16 || tt != QG_BM || S_pad < tt || S_pad % tt ||
        S_pad / tt > 65535 || K < QK_K || K % QK_K || n_exp < 1 || N < 1 ||
        (kind != KIND_Q4_K && kind != KIND_Q6_K))
        return static_cast<int>(cudaErrorInvalidValue);
    const int row_bytes = (K / QK_K) * (kind == KIND_Q4_K ? Q4K_BYTES : Q6K_BYTES);
    const dim3 grid((N + QG_BN - 1) / QG_BN, S_pad / tt);
    qgemm_id_kernel<<<grid, QG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(x),
        static_cast<const int*>(tile_expert), static_cast<float*>(out), kind, n_exp, S_pad, N,
        K, row_bytes);
    return static_cast<int>(cudaGetLastError());
}

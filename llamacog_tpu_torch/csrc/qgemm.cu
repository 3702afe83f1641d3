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
// of loads against the tensor cores yet: that is later work. The tile
// itself (qgemm_tile) lives in qgemm_tile.cuh, shared with qgemm_id.cu.
#include "qgemm_tile.cuh"

constexpr int QG_MAX_DESC = 4;

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

__global__ void __launch_bounds__(QG_THREADS)
qgemm_kernel(const QgParams p, const __nv_bfloat16* __restrict__ x) {
    int t = 0;
#pragma unroll
    for (int i = 1; i < QG_MAX_DESC; ++i)
        if (i < p.n_desc && (int)blockIdx.x >= p.d[i].block0) t = i;
    const QgDesc& D = p.d[t];
    qgemm_tile(D.w, D.kind, D.n, D.row_bytes, x, p.B, p.K, (int)blockIdx.y * QG_BM,
               ((int)blockIdx.x - D.block0) * QG_BN, D.out);
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

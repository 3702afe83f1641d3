// qmv — fused dequant x matvec over GGUF wire-format Q4_K / Q6_K weights.
//
// Replaces (llamacog_tpu/ops/pallas/qmm.py):
//   * _qmm_call at B <= 8 (_qmm_kernel -> _tile_matvec, decoders _dec_q4_K,
//     _dec_q6_K): out[B, N] f32 = x[B, K] @ dequant(W)[N, K]^T;
//   * _qmm_multi_call (_qmm_multi_kernel): several weights sharing one x in
//     ONE launch. Here a launch takes up to QMV_MAX_DESC weight descriptors
//     and partitions blockIdx.x by weight — the counterpart of the Pallas
//     phase-partitioned grid.
//
// Bound on this card: bytes. At decode batch the product does 2 flops per
// weight against 0.56 (Q4_K) or 0.82 (Q6_K) bytes per weight, far below the
// H100's ~295 flops/byte ridge, so the least time is the weight bytes over
// 3.35 TB/s — reached only with enough bytes in flight (~25 KB per SM at
// HBM latency). Design: the weights are read once, straight from the GGUF
// blocks (no relayout, no dequantized copy). Each warp owns QMV_ROWS output
// rows and walks their superblocks four at a time: eight lanes share a
// superblock, each lane decoding a 32-weight slice from one 16-byte load
// (Q4_K) or twelve 2-byte loads (Q6_K, whose 210-byte blocks are only
// 2-byte aligned), so a warp keeps 0.5-1 KB of weights in flight per step.
// The activation slice a lane needs is loaded once (from L1) and applied to
// all the warp's rows. Partial sums are reduced with warp shuffles.
// Operands are f32, as the Pallas matvec path (mxu_f32): each weight is
// formed exactly as the plain torch dequant forms it, so kernel and plain
// differ only in summation order. blockIdx.y walks x in chunks of QMV_MAX_B
// rows, so f32 activations of any batch take this f32 path too (streaming
// the weights once per chunk). The slice decoders and the warp's row walk
// (qmv_rows) live in common.cuh, shared with qmv_id.cu.
#include "common.cuh"

constexpr int QMV_MAX_DESC = 4;
constexpr int QMV_MAX_B = 8;

struct QmvDesc {
    const uint8_t* w;  // [n, row_bytes] wire blocks
    float* out;        // [B, n] f32
    int kind;
    int n;
    int row_bytes;
    int block0;        // first blockIdx.x of this weight
};

struct QmvParams {
    QmvDesc d[QMV_MAX_DESC];
    int n_desc;
    int B;
    int K;
};

template <int NB, typename TX>
__global__ void __launch_bounds__(QMV_WARPS * 32)
qmv_kernel(const QmvParams p, const TX* __restrict__ x) {
    int t = 0;
#pragma unroll
    for (int i = 1; i < QMV_MAX_DESC; ++i)
        if (i < p.n_desc && (int)blockIdx.x >= p.d[i].block0) t = i;
    const QmvDesc& D = p.d[t];
    const int warp = threadIdx.x >> 5;
    const int row0 = ((int)blockIdx.x - D.block0) * QMV_BLOCK_ROWS + warp * QMV_ROWS;
    const int b0 = (int)blockIdx.y * NB;  // first activation row of this chunk
    const int B = min(NB, p.B - b0);
    x += (size_t)b0 * p.K;
    float acc[QMV_ROWS][NB];
#pragma unroll
    for (int r = 0; r < QMV_ROWS; ++r)
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;
    if (row0 < D.n) {
        if (D.kind == KIND_Q4_K)
            qmv_rows<KIND_Q4_K, NB, TX>(D.w, D.n, D.row_bytes, x, B, p.K, row0, acc);
        else
            qmv_rows<KIND_Q6_K, NB, TX>(D.w, D.n, D.row_bytes, x, B, p.K, row0, acc);
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < QMV_ROWS; ++r) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float s = warp_sum(acc[r][b]);
            const int row = row0 + r;
            if (lane == 0 && b < B && row < D.n) D.out[(size_t)(b0 + b) * D.n + row] = s;
        }
    }
}

template <int NB>
static void launch(const QmvParams& p, const void* x, int x_dtype, int row_blocks,
                   cudaStream_t stream) {
    const dim3 blocks(row_blocks, (p.B + NB - 1) / NB);
    if (x_dtype == DT_BF16)
        qmv_kernel<NB, __nv_bfloat16><<<blocks, QMV_WARPS * 32, 0, stream>>>(
            p, static_cast<const __nv_bfloat16*>(x));
    else
        qmv_kernel<NB, float><<<blocks, QMV_WARPS * 32, 0, stream>>>(
            p, static_cast<const float*>(x));
}

// x [B, K] (f32 or bf16, contiguous); weight t: w[t] [n[t], K/256 blocks],
// kind[t]; out[t] [B, n[t]] f32.
LCG_EXPORT int lcg_qmv(const void* x, int x_dtype, int B, int K, int n_desc,
                       const void* const* w, void* const* out, const int* kind,
                       const int* n, void* stream) {
    if (n_desc < 1 || n_desc > QMV_MAX_DESC || B < 1 || K % QK_K)
        return static_cast<int>(cudaErrorInvalidValue);
    QmvParams p{};
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
        blocks += (n[t] + QMV_BLOCK_ROWS - 1) / QMV_BLOCK_ROWS;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B == 1) launch<1>(p, x, x_dtype, blocks, s);
    else launch<QMV_MAX_B>(p, x, x_dtype, blocks, s);
    return static_cast<int>(cudaGetLastError());
}

// qgemm — fused dequant x GEMM over GGUF wire-format weights: Q4_K, Q6_K,
// Q8_0, Q5_K, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, the codebook kinds
// IQ4_NL, IQ4_XS, IQ3_XXS, IQ3_S, IQ2_S, IQ2_XXS, IQ2_XS, IQ1_S, IQ1_M and
// the ternary TQ1_0, TQ2_0.
//
// Replaces (llamacog_tpu/ops/pallas/qmm.py): _qmm_call at B > 8 (the plain
// and the row-tiled tb > 0 branches, _qmm_kernel -> _tile_matvec with bf16
// operands and f32 accumulation), and _qmm_multi_call / _qmm_multi_kernel
// at B > 8: out_t[B, N_t] f32 = x @ bf16(dequant(W_t))^T for bf16
// activations x and up to QG_MAX_DESC weights sharing x, in one launch
// whose weight-block range (blockIdx.y) is partitioned by weight.
//
// Bound on this card: operations at prefill batch. At B = 128 a weight
// takes 256 flops against under a byte, so the least time is the flops over
// the 989 TFLOP/s bf16 tensor-core peak (gate_up 0.030 ms against 0.020 for
// its bytes), and more so at B = 512. What stands in the way: the weights
// must be dequantized on the way (several integer and f32 instructions a
// weight, issued by the same warps that feed the tensor cores), so loads,
// dequant and mma.sync have to overlap, each dequantized weight has to
// feed many activation rows, and the row tiles of one weight strip have to
// run together, or it is read from device memory again at B = 512
// (gate_up's 66 MB exceed the 50 MB L2).
//
// Design: the pipelined tile of qgemm_tile.cuh — 128 x 128 output tiles of
// 8 warps (or 64-row tiles, below), two blocks an SM, activations in a
// cp.async ring two stages ahead, wire
// bytes in registers one stage ahead of a dequant that is interleaved with
// the mma.sync work of the stage before, levels to f32 with no conversion
// instruction. blockIdx.x walks the row tiles of x, so the row tiles of one
// weight strip run together and read its bytes once from device memory,
// then from L2. Each weight is formed exactly as the plain torch dequant
// forms it, then rounded to bf16 (the tolerance of qmm_plain holds). Any B
// is taken (rows past B are zero), so there is no counterpart of the TPU's
// VMEM row-tiling rule.
//
// Tile height: 64 rows at B <= 64, and wherever the 64-row grid still gives
// every block an SM of its own (ceil(B / 64) x weight blocks <= the SM
// count): there the grid of 128-row tiles would leave most SMs idle, and
// half the rows a block halve its tensor-core work while its dequant stays
// the same. Past one block an SM, two 64-row blocks that share an SM each
// dequantize the same weights, and the 128-row tile wins. tools/qgemm_tiles.py
// times this rule against both fixed heights at the 8B weights (PERF.md §6).
#include "qgemm_tile.cuh"

constexpr int QG_MAX_DESC = 4;

struct QgDesc {
    const uint8_t* w;
    float* out;
    int kind;
    int n;
    int row_bytes;
    int block0;  // first blockIdx.y of this weight
};

struct QgParams {
    QgDesc d[QG_MAX_DESC];
    int n_desc;
    int B;
    int K;
};

// KSET: the smallest kind set (common.cuh) that holds the launch's weights.
// The launches of Q4_K and Q6_K weights alone (every one of a Q4_K_M llama)
// take the kernel that holds those two tile loops only: two more cost them
// 2-3% (more code for the instruction cache; PERF.md §6). A Q4_K_M file's
// Q8_0 and Q5_K weights take the four-kind kernel, a launch with a
// codebook kind the kernel of those four and the codebook kinds, a launch
// with a 1-2 bit or ternary kind the kernel of those four, IQ3_S and the
// six kinds, every other kind the kernel of the ten others.
template <int BM, int KSET>
__global__ void __launch_bounds__(QG_THREADS, 2)
qgemm_kernel(const QgParams p, const __nv_bfloat16* __restrict__ x) {
    int t = 0;
#pragma unroll
    for (int i = 1; i < QG_MAX_DESC; ++i)
        if (i < p.n_desc && (int)blockIdx.y >= p.d[i].block0) t = i;
    const QgDesc& D = p.d[t];
    qgemm_tile_kind<BM, KSET>(D.w, D.kind, D.n, D.row_bytes, x, p.B, p.K,
                              (int)blockIdx.x * BM, ((int)blockIdx.y - D.block0) * QG_BN, D.out);
}

static int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

template <int BM, int KSET>
static int launch(const QgParams& p, const void* x, int n_blocks, cudaStream_t stream) {
    static bool attr_set = false;  // once per instantiation, not per launch
    if (!attr_set) {
        const cudaError_t err =
            cudaFuncSetAttribute(qgemm_kernel<BM, KSET>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)qg_smem_bytes(BM));
        if (err != cudaSuccess) return static_cast<int>(err);
        attr_set = true;
    }
    const dim3 grid((p.B + BM - 1) / BM, n_blocks);
    qgemm_kernel<BM, KSET><<<grid, QG_THREADS, qg_smem_bytes(BM), stream>>>(
        p, static_cast<const __nv_bfloat16*>(x));
    return static_cast<int>(cudaGetLastError());
}

template <int BM>
static int launch_kinds(const QgParams& p, const void* x, int n_blocks, int set,
                        cudaStream_t stream) {
    return set == KS_Q4K_Q6K ? launch<BM, KS_Q4K_Q6K>(p, x, n_blocks, stream)
         : set == KS_Q4KM    ? launch<BM, KS_Q4KM>(p, x, n_blocks, stream)
         : set == KS_ALL     ? launch<BM, KS_ALL>(p, x, n_blocks, stream)
         : set == KS_IQ      ? launch<BM, KS_IQ>(p, x, n_blocks, stream)
                             : launch<BM, KS_IQ_LOW>(p, x, n_blocks, stream);
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
        if (kind_sb_bytes(kind[t]) == 0) return static_cast<int>(cudaErrorInvalidValue);
        p.d[t].w = static_cast<const uint8_t*>(w[t]);
        p.d[t].out = static_cast<float*>(out[t]);
        p.d[t].kind = kind[t];
        p.d[t].n = n[t];
        p.d[t].row_bytes = (K / QK_K) * kind_sb_bytes(kind[t]);
        p.d[t].block0 = blocks;
        blocks += (n[t] + QG_BN - 1) / QG_BN;
    }
    // every set is compiled: a Q4_K + Q6_K launch takes KS_Q4K_Q6K's kernel
    const int set = launch_set(kind, n_desc, (1u << (KS_IQ_LOW + 1)) - 1);
    if (blocks > 65535 || set < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    static const int sms = sm_count();  // queried once
    const bool rows64 = B <= 64 || (long long)((B + 63) / 64) * blocks <= sms;
    return rows64 ? launch_kinds<64>(p, x, blocks, set, s)
                  : launch_kinds<128>(p, x, blocks, set, s);
}

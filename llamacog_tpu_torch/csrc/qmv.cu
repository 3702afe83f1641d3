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
// the weights once per chunk).
#include "common.cuh"

constexpr int QMV_MAX_DESC = 4;
constexpr int QMV_WARPS = 4;
constexpr int QMV_ROWS = 2;                               // rows per warp
constexpr int QMV_BLOCK_ROWS = QMV_WARPS * QMV_ROWS;      // rows per block
constexpr int QMV_MAX_B = 8;
constexpr int QMV_SB_STEP = 4;   // superblocks per warp step (8 lanes each)
constexpr int QMV_SLICE = 32;    // weights per lane per superblock

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

// Q4_K slice of lane slot i (0..7) of a superblock: qs bytes 16i..16i+15,
// i.e. group j = i/2 (64 weights), p = 16*(i%2). Slice index k < 16 is the
// low nibble of byte k (element j*64 + p + k, sub-block 2j); k >= 16 the
// high nibble of byte k-16 (element j*64 + 32 + p + k-16, sub-block 2j+1).
__device__ __forceinline__ void q4k_slice(const uint8_t* blk, int i, float* w) {
    const int j = i >> 1;
    const uint32_t dm = *reinterpret_cast<const uint32_t*>(blk);
    const uint32_t s0 = *reinterpret_cast<const uint32_t*>(blk + 4);
    const uint32_t s1 = *reinterpret_cast<const uint32_t*>(blk + 8);
    const uint32_t s2 = *reinterpret_cast<const uint32_t*>(blk + 12);
    const uint4 q = *reinterpret_cast<const uint4*>(blk + 16 + 16 * i);
    const float d = f16_bits(dm & 0xFFFF);
    const float dmin = f16_bits(dm >> 16);
    int sc0, m0, sc1, m1;
    q4k_scale_min(s0, s1, s2, 2 * j, sc0, m0);
    q4k_scale_min(s0, s1, s2, 2 * j + 1, sc1, m1);
    const float dl0 = __fmul_rn(d, (float)sc0), ml0 = __fmul_rn(dmin, (float)m0);
    const float dl1 = __fmul_rn(d, (float)sc1), ml1 = __fmul_rn(dmin, (float)m1);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int byte = (words[k >> 2] >> (8 * (k & 3))) & 0xFF;
        w[k] = q4k_weight(dl0, ml0, byte & 0xF);
        w[16 + k] = q4k_weight(dl1, ml1, byte >> 4);
    }
}

__device__ __forceinline__ int q4k_x_offset(int i, int part) {  // part 0: k<16, 1: k>=16
    return (i >> 1) * 64 + (i & 1) * 16 + part * 32;
}

// Q6_K slice of lane slot i: chunk c = i/4, positions lq..lq+7 of the
// chunk's 32 (lq = 8*(i%4)) for all four quarters; slice index qt*8 + t is
// element c*128 + qt*32 + lq + t (sub-scale c*8 + qt*2 + lq/16).
__device__ __forceinline__ void q6k_slice(const uint8_t* blk, int i, float* w) {
    const int c = i >> 2, lq = (i & 3) * 8;
    const uint16_t* ql0 = reinterpret_cast<const uint16_t*>(blk + c * 64 + lq);
    const uint16_t* ql1 = reinterpret_cast<const uint16_t*>(blk + c * 64 + 32 + lq);
    const uint16_t* qhp = reinterpret_cast<const uint16_t*>(blk + 128 + c * 32 + lq);
    const int8_t* scales = reinterpret_cast<const int8_t*>(blk + 192);
    const float d = f16_bits(*reinterpret_cast<const uint16_t*>(blk + 208));
    float dl[4];
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) dl[qt] = __fmul_rn(d, (float)scales[c * 8 + qt * 2 + (lq >> 4)]);
#pragma unroll
    for (int t2 = 0; t2 < 4; ++t2) {
        const uint32_t a = ql0[t2], b = ql1[t2], h2 = qhp[t2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int t = 2 * t2 + u;
            const int b0 = (a >> (8 * u)) & 0xFF;
            const int b1 = (b >> (8 * u)) & 0xFF;
            const int h = (h2 >> (8 * u)) & 0xFF;
            w[0 * 8 + t] = __fmul_rn(dl[0], (float)(((b0 & 0xF) | (((h >> 0) & 3) << 4)) - 32));
            w[1 * 8 + t] = __fmul_rn(dl[1], (float)(((b1 & 0xF) | (((h >> 2) & 3) << 4)) - 32));
            w[2 * 8 + t] = __fmul_rn(dl[2], (float)(((b0 >> 4) | (((h >> 4) & 3) << 4)) - 32));
            w[3 * 8 + t] = __fmul_rn(dl[3], (float)(((b1 >> 4) | (((h >> 6) & 3) << 4)) - 32));
        }
    }
}

// The 32 activation values matching a lane's slice, for one row of x.
template <int KIND, typename TX>
__device__ __forceinline__ void x_slice(const TX* xsb, int i, float* xv) {
    if constexpr (KIND == KIND_Q4_K) {
        load8(xsb + q4k_x_offset(i, 0), xv);
        load8(xsb + q4k_x_offset(i, 0) + 8, xv + 8);
        load8(xsb + q4k_x_offset(i, 1), xv + 16);
        load8(xsb + q4k_x_offset(i, 1) + 8, xv + 24);
    } else {
        const int base = (i >> 2) * 128 + (i & 3) * 8;
#pragma unroll
        for (int qt = 0; qt < 4; ++qt) load8(xsb + base + qt * 32, xv + qt * 8);
    }
}

template <int KIND, int NB, typename TX>
__device__ void qmv_rows(const QmvDesc& D, const TX* x, int B, int K, int row0,
                         float (&acc)[QMV_ROWS][NB]) {
    const int lane = threadIdx.x & 31;
    const int sub = lane >> 3;  // which of the step's four superblocks
    const int i = lane & 7;     // slice slot within the superblock
    const int nsb = K / QK_K;
    const int bpb = KIND == KIND_Q4_K ? Q4K_BYTES : Q6K_BYTES;
    for (int sb0 = 0; sb0 < nsb; sb0 += QMV_SB_STEP) {
        const int sb = sb0 + sub;
        if (sb >= nsb) continue;
        float w[QMV_ROWS][QMV_SLICE];
#pragma unroll
        for (int r = 0; r < QMV_ROWS; ++r) {
            const int row = min(row0 + r, D.n - 1);  // a spare row re-reads the last
            const uint8_t* blk = D.w + (size_t)row * D.row_bytes + (size_t)sb * bpb;
            if constexpr (KIND == KIND_Q4_K) q4k_slice(blk, i, w[r]);
            else q6k_slice(blk, i, w[r]);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            if (b >= B) break;
            float xv[QMV_SLICE];
            x_slice<KIND>(x + (size_t)b * K + (size_t)sb * QK_K, i, xv);
#pragma unroll
            for (int r = 0; r < QMV_ROWS; ++r)
#pragma unroll
                for (int k = 0; k < QMV_SLICE; ++k) acc[r][b] = fmaf(w[r][k], xv[k], acc[r][b]);
        }
    }
}

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
        if (D.kind == KIND_Q4_K) qmv_rows<KIND_Q4_K, NB, TX>(D, x, B, p.K, row0, acc);
        else qmv_rows<KIND_Q6_K, NB, TX>(D, x, B, p.K, row0, acc);
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

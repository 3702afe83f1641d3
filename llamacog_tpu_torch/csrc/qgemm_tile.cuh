// The 64 x 64 tile of the fused dequant x GEMM over GGUF wire-format Q4_K /
// Q6_K weights, shared by qgemm.cu (dense weights, K2/K3) and qgemm_id.cu
// (stacked experts, K11). A block of QG_THREADS threads owns one output
// tile and walks K in half-superblock steps of QG_BK: the weight tile is
// dequantized from the wire blocks straight into shared memory as bf16
// (each weight formed exactly as the plain torch dequant forms it, then
// rounded to bf16), the bf16 activation tile is copied beside it, and four
// warps take the product with WMMA bf16 x bf16 -> f32 fragments.
#pragma once

#include <mma.h>

#include "common.cuh"

constexpr int QG_BM = 64;     // activation rows per block
constexpr int QG_BN = 64;     // weight rows per block
constexpr int QG_BK = 128;    // K per step: half a superblock
constexpr int QG_LDS = QG_BK + 8;   // smem row stride (bf16), a multiple of 8
constexpr int QG_LDC = QG_BN + 4;   // epilogue row stride (f32)
constexpr int QG_THREADS = 128;

// Dequantize the half-superblock `half` of superblock `sb` for weight rows
// n0..n0+63 into Bs [64][QG_LDS] bf16. Thread t owns row t/2 and 64 of the
// 128 columns.
__device__ __forceinline__ void dequant_q4k_tile(const uint8_t* wq, int n, int row_bytes, int n0,
                                                 int sb, int half, __nv_bfloat16* Bs) {
    const int r = threadIdx.x >> 1;
    const int g = threadIdx.x & 1;
    __nv_bfloat16* dst = Bs + r * QG_LDS + g * 64;
    const int row = n0 + r;
    if (row >= n) {
#pragma unroll
        for (int i = 0; i < 64; ++i) dst[i] = __float2bfloat16(0.f);
        return;
    }
    const int j = 2 * half + g;  // 64-weight group of the superblock
    const uint8_t* blk = wq + (size_t)row * row_bytes + (size_t)sb * Q4K_BYTES;
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
__device__ __forceinline__ void dequant_q6k_tile(const uint8_t* wq, int n, int row_bytes, int n0,
                                                 int sb, int c, __nv_bfloat16* Bs) {
    const int r = threadIdx.x >> 1;
    const int g = threadIdx.x & 1;
    __nv_bfloat16* dst = Bs + r * QG_LDS;
    const int row = n0 + r;
    if (row >= n) {
#pragma unroll
        for (int qt = 0; qt < 4; ++qt)
#pragma unroll
            for (int i = 0; i < 16; ++i) dst[qt * 32 + g * 16 + i] = __float2bfloat16(0.f);
        return;
    }
    const uint8_t* blk = wq + (size_t)row * row_bytes + (size_t)sb * Q6K_BYTES;
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

// out[m0.., n0..] (row stride n) = x[m0..m0+63, :K] @ bf16(dequant(wq rows
// n0..n0+63))^T for the [n, K] wire weight `wq` of `kind`; x rows past B
// read as zero, and rows past B or columns past n are not written.
__device__ __forceinline__ void qgemm_tile(const uint8_t* wq, int kind, int n, int row_bytes,
                                           const __nv_bfloat16* __restrict__ x, int B, int K,
                                           int m0, int n0, float* out) {
    using namespace nvcuda;
    __shared__ __align__(128) unsigned char smem[2 * QG_BM * QG_LDS * 2];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Bs = As + QG_BM * QG_LDS;
    float* Cs = reinterpret_cast<float*>(smem);  // epilogue, after the K loop

    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += QG_BK) {
        // activation tile [64][128], 8 bf16 (16 bytes) a load
        for (int i = threadIdx.x; i < QG_BM * QG_BK / 8; i += QG_THREADS) {
            const int r = i / (QG_BK / 8), c = (i % (QG_BK / 8)) * 8;
            const int m = m0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (m < B) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c);
            *reinterpret_cast<uint4*>(As + r * QG_LDS + c) = v;
        }
        const int sb = k0 / QK_K, half = (k0 / QG_BK) & 1;
        if (kind == KIND_Q4_K) dequant_q4k_tile(wq, n, row_bytes, n0, sb, half, Bs);
        else dequant_q6k_tile(wq, n, row_bytes, n0, sb, half, Bs);
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
        const int m = m0 + r, col = n0 + c;
        if (m < B && col < n) out[(size_t)m * n + col] = Cs[r * QG_LDC + c];
    }
}

// The bf16 tensor-core tile loop of prefill attention, shared by the prefill
// kernels and templated over the K/V tile loader.
//
// One block holds BR = 16 * NW GQA query rows of one (kv head, batch row):
// row r is token r / rep, query head hk * rep + r % rep, so the rep query
// heads of a kv head share every K/V tile. Each warp owns 16 rows; their Q
// fragments stay in registers for the whole loop. K/V arrive in tiles of
// FA_BC positions, double-buffered in padded shared memory (row stride
// DK + FA_PAD or DV + FA_PAD elements keeps ldmatrix's eight row reads on
// distinct banks for every head dim that is a multiple of 16):
// the loader queues tile j + 1 (cp.async) while tile j is used. Per tile,
// S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> f32; the online
// softmax runs in f32 registers, its row statistics shared by the 4 lanes
// of an MMA row quad, and P is rounded to bf16 for the PV product.
//
// The positions are the old cache [0, n_old) (phase 0) and then the block
// itself [0, t_last] (phase 1, causal). Scores follow the plain version:
// softcap_score(s * scale, softcap), then the mask (phase 0: pos < n_old and
// pos > n + t - window; phase 1: pos <= t and pos > t - window), masked
// scores at MASKED. A tile wholly after a warp's last token is skipped by
// that warp; the mask is evaluated only on tiles it can cut (the ragged end
// of the old cache, the diagonal, a window, a warp with rows past R); tiles
// wholly before a block's window are not loaded.
//
// Head dims DK (Q, K) and DV (V, out) are multiples of 16 up to 256. Above
// 128 the Q fragments and the O accumulator outgrow the register file and
// ptxas spills part of them to local memory: right, but slower than the
// smaller widths.
//
// A loader is a type with
//   template <int DK, int DV, int NT> __device__ void load(bf16* ks, bf16* vs,
//       int phase, int c0, int len, int slot, int tid) const;
// that fills rows [0, FA_BC) of the K and V tiles (row strides DK + FA_PAD
// and DV + FA_PAD)
// with positions c0.. of `phase`, zeros at positions >= len, by cp.async
// (or by plain stores: the loop's commit and wait are then empty), and a
// constant `static constexpr bool LANDS`. A loader that LANDS may instead
// queue raw bytes into a staging slot of its own (`slot`, the tile's
// buffer parity) and turn them into the tiles once they have landed, in
//   template <int DK, int DV, int NT> __device__ bool land(bf16* ks,
//       bf16* vs, int phase, int slot, int tid) const;
// which the loop calls after the tile's wait and block barrier; it returns
// whether it wrote the tiles (the same in every thread), and the loop then
// takes one more barrier before the tiles are read. A loader that does not
// land compiles to the loop without the hook.
#pragma once

#include "common.cuh"

using bf16 = __nv_bfloat16;

constexpr int FA_BC = 64;   // key positions per tile
constexpr int FA_PAD = 8;   // bf16 elements of padding per shared-memory row

// Dynamic shared memory of the loop: two buffers of a K and a V tile.
__host__ __device__ constexpr size_t fa_smem_bytes(int DK, int DV) {
    return 2 * (size_t)FA_BC * (DK + DV + 2 * FA_PAD) * sizeof(bf16);
}

// Rows [c0, c0 + FA_BC) of one tensor, W elements a row at position stride
// st, into a tile (row stride W + FA_PAD) by 16-byte cp.async copies; zeros
// at positions >= len.
template <int W, int NT>
__device__ __forceinline__ void fa_copy_rows(bf16* dst, const bf16* src, long long st, int c0,
                                             int len, int tid) {
    constexpr int CH = W / 8;  // 16-byte chunks a row
    for (int i = tid; i < FA_BC * CH; i += NT) {
        const int r = i / CH, ch = i - r * CH;
        const int pos = c0 + r;
        const bool ok = pos < len;
        cp_async16(dst + r * (W + FA_PAD) + ch * 8, src + (ok ? pos : 0) * st + ch * 8, ok);
    }
}

// The K and V tiles of positions [c0, c0 + FA_BC) from bf16 rows k and v
// (position strides kst and vst, elements), as fa_copy_rows.
template <int DK, int DV, int NT>
__device__ __forceinline__ void fa_copy_kv(bf16* ks, bf16* vs, const bf16* k, const bf16* v,
                                           long long kst, long long vst, int c0, int len,
                                           int tid) {
    if constexpr (DK == DV) {
        // one index walk for both tensors: half the loop overhead of two,
        // which the old-cache tiles of a long prefix pay each tile
        constexpr int CH = DK / 8;
        for (int i = tid; i < FA_BC * CH; i += NT) {
            const int r = i / CH, ch = i - r * CH;
            const int pos = c0 + r;
            const bool ok = pos < len;
            const size_t p = ok ? (size_t)pos : 0;
            cp_async16(ks + r * (DK + FA_PAD) + ch * 8, k + p * kst + ch * 8, ok);
            cp_async16(vs + r * (DV + FA_PAD) + ch * 8, v + p * vst + ch * 8, ok);
        }
    } else {
        fa_copy_rows<DK, NT>(ks, k, kst, c0, len, tid);
        fa_copy_rows<DV, NT>(vs, v, vst, c0, len, tid);
    }
}

// The loop for one block: q [B, T, H, DK] and out [B, T, H, DV] contiguous
// bf16; n = seq_len[b] (the block's write offset), n_old = min(n, s_eff).
template <int DK, int DV, int NW, typename Loader>
__device__ __forceinline__ void prefill_attn_tiles(const Loader& ld, const bf16* __restrict__ q,
                                                   bf16* __restrict__ out, int b, int hk, int T_,
                                                   int H, int rep, int n, int n_old, float scale,
                                                   float softcap, int window) {
    static_assert(DK % 16 == 0 && DV % 16 == 0 && DK <= 256 && DV <= 256,
                  "head dims: multiples of 16, at most 256");
    constexpr int LDK = DK + FA_PAD;
    constexpr int LDV = DV + FA_PAD;
    constexpr int NT = 32 * NW;
    constexpr int BR = 16 * NW;
    constexpr int KS = DK / 16;     // k-steps of Q K^T
    constexpr int NS = FA_BC / 8;   // n-tiles of S
    constexpr int NO = DV / 8;      // n-tiles of O
    extern __shared__ __align__(16) unsigned char fa_smem[];
    // [2][K [FA_BC][LDK], V [FA_BC][LDV]]
    bf16* const tiles = reinterpret_cast<bf16*>(fa_smem);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int R = T_ * rep;
    const int r0 = blockIdx.x * BR;
    const int wr0 = r0 + warp * 16;
    const bool warp_live = wr0 < R;
    const bool warp_full = wr0 + 16 <= R;
    const int w_tfirst = min(wr0, R - 1) / rep;
    const int w_tlast = (min(wr0 + 16, R) - 1) / rep;

    int rows[2], trow[2];
    bool rok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        rows[i] = wr0 + g + 8 * i;
        rok[i] = rows[i] < R;
        trow[i] = rok[i] ? rows[i] / rep : 0;
    }

    // Q fragments: a[i + 2j] holds row g + 8i, columns kk*16 + 2c + 8j (+1)
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e & 1, j = e >> 1;
            qf[kk][e] = 0u;
            if (rok[i]) {
                const int h = hk * rep + rows[i] % rep;
                qf[kk][e] = *reinterpret_cast<const uint32_t*>(
                    q + (((size_t)b * T_ + trow[i]) * H + h) * DK + kk * 16 + 2 * c + 8 * j);
            }
        }

    float o[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};  // l: this lane's partial sums

    // tile ranges; with a window, tiles wholly before the block's first
    // token's window are never loaded
    const int t_first = r0 / rep;
    const int t_last = (min(r0 + BR, R) - 1) / rep;
    const int old_lo = window > 0 ? (max(0, n + t_first - window + 1) / FA_BC) * FA_BC : 0;
    const int cur_lo = window > 0 ? (max(0, t_first - window + 1) / FA_BC) * FA_BC : 0;
    const int n_old_tiles = old_lo < n_old ? (n_old - old_lo + FA_BC - 1) / FA_BC : 0;
    const int n_tiles = n_old_tiles + (t_last + 1 - cur_lo + FA_BC - 1) / FA_BC;

    auto tile_of = [&](int j, int& phase, int& c0, int& len) {
        phase = j < n_old_tiles ? 0 : 1;
        c0 = phase == 0 ? old_lo + j * FA_BC : cur_lo + (j - n_old_tiles) * FA_BC;
        len = phase == 0 ? n_old : t_last + 1;
    };
    auto buf_k = [&](int j) { return tiles + (size_t)(j & 1) * FA_BC * (LDK + LDV); };

    {
        int phase, c0, len;
        tile_of(0, phase, c0, len);
        ld.template load<DK, DV, NT>(buf_k(0), buf_k(0) + FA_BC * LDK, phase, c0, len, 0, tid);
        cp_async_commit();
    }
    for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) {
            int phase, c0, len;
            tile_of(j + 1, phase, c0, len);
            ld.template load<DK, DV, NT>(buf_k(j + 1), buf_k(j + 1) + FA_BC * LDK, phase, c0,
                                         len, (j + 1) & 1, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        int phase, c0, len;
        tile_of(j, phase, c0, len);
        if constexpr (Loader::LANDS) {
            if (ld.template land<DK, DV, NT>(buf_k(j), buf_k(j) + FA_BC * LDK, phase, j & 1, tid))
                __syncthreads();
        }
        const bool skip = !warp_live || (phase == 1 && c0 > w_tlast);
        if (!skip) {
            const bf16* ks = buf_k(j);
            const bf16* vs = ks + FA_BC * LDK;
            float s[NS][4];
#pragma unroll
            for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
                for (int np = 0; np < NS / 2; ++np) {
                    uint32_t kb[4];
                    ldsm_x4(kb, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDK + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
                    mma_bf16_16816(s[2 * np], qf[kk], kb[0], kb[1]);
                    mma_bf16_16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
                }
            }
            // scale (and softcap), then the mask on tiles it can cut: row i
            // keeps positions [lo, hi), held relative to this lane's first
            // column so each test compares with a constant offset
            if (softcap > 0.f) {
#pragma unroll
                for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        s[nt][e] = softcap * tanhf(s[nt][e] * scale / softcap);
            } else {
#pragma unroll
                for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
            }
            const bool need_mask = window > 0 || !warp_full ||
                                   (phase == 0 ? c0 + FA_BC > n_old : c0 + FA_BC - 1 > w_tfirst);
            if (need_mask) {
                int lo[2], hi[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int first = c0 + 2 * c;
                    if (!rok[i]) {
                        lo[i] = hi[i] = 0;
                    } else if (phase == 0) {
                        lo[i] = (window > 0 ? n + trow[i] - window + 1 : 0) - first;
                        hi[i] = n_old - first;
                    } else {
                        lo[i] = (window > 0 ? trow[i] - window + 1 : 0) - first;
                        hi[i] = trow[i] + 1 - first;
                    }
                }
#pragma unroll
                for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e >> 1, off = nt * 8 + (e & 1);
                        if (off < lo[i] || off >= hi[i]) s[nt][e] = MASKED;
                    }
            }
            float mx[2] = {MASKED, MASKED};
#pragma unroll
            for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
            float alpha[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i]);
                alpha[i] = __expf(m[i] - m_new);
                m[i] = m_new;
                l[i] *= alpha[i];
            }
#pragma unroll
            for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    const float p = s[nt][e] > 0.5f * MASKED ? __expf(s[nt][e] - m[i]) : 0.f;
                    s[nt][e] = p;
                    l[i] += p;
                }
#pragma unroll
            for (int nt = 0; nt < NO; ++nt) {
                o[nt][0] *= alpha[0];
                o[nt][1] *= alpha[0];
                o[nt][2] *= alpha[1];
                o[nt][3] *= alpha[1];
            }
#pragma unroll
            for (int kj = 0; kj < FA_BC / 16; ++kj) {
                const uint32_t pa[4] = {pack_bf16x2(s[2 * kj][0], s[2 * kj][1]),
                                        pack_bf16x2(s[2 * kj][2], s[2 * kj][3]),
                                        pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                                        pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
                for (int dp = 0; dp < NO / 2; ++dp) {
                    uint32_t vb[4];
                    const int vrow = kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
                    ldsm_x4_trans(vb, vs + vrow * LDV + dp * 16 + (lane >> 4) * 8);
                    mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
                    mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
                }
            }
        }
        __syncthreads();  // buffer j & 1 is refilled by the next iteration's load
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (!rok[i]) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        const int h = hk * rep + rows[i] % rep;
        bf16* orow = out + (((size_t)b * T_ + trow[i]) * H + h) * DV;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt)
            *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * c) =
                pack_bf16x2(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
    }
}

// flash_decode_quant — T=1 attention straight out of the quantized KV planes.
//
// Replaces llamacog_tpu/ops/pallas/flash_q8.py::flash_decode_stacked
// (_decode_onedot_kernel) and the per-layer entries flash_decode_q8
// (_decode_kernel) and flash_decode_q8_tiled (_decode_tiled_kernel): q
// [B, H, Dk] in natural order attends over one layer of the K and V planes
// [B, S, Hkv*W] (runtime/kv_cache.py; K and V kinds independent: q8_0, q4_0,
// q4_1, q5_0, q5_1, f16, bf16), each row stopping at its own seq_len and at
// kv_cap, with softcap and sliding window, and the current step's k_cur/v_cur
// [B, Hkv, D] (natural order, unquantized: the deferred write) folded in
// last. Out [B, H, Dv] in natural order, in the input type. The whole-S and
// the S-tiled Pallas variants are one kernel here.
//
// Bound on this card: bytes — every plane byte of the attended prefix is
// read once (q8_0 about half of a bf16 cache, q4_0 about a third) for a few
// flops per byte. The first version of this kernel gave one block to each
// (kv head, batch row), 8 blocks on 132 SMs at B = 1, each thread scoring a
// whole K row of its own position: 0.29 ms at depth 1000 and 7.44 ms at
// 32765, 3.8x its plain version (H100 80GB HBM3, 700 W; PERF.md §6).
//
// Design: split-S flash-decoding, as flash_decode_dense.cu. The host picks
// n_split and split_len from s_eff alone (ops/cuda/flash_q8.py::
// choose_splits), so a launch makes no host sync. Grid (n_split, Hkv, B):
// each block walks its split's positions once, 8 warps side by side; q
// sits in shared memory in K's stored column order. Each warp walks its own
// rounds of U rows a row group (8 positions a warp for D = 128): the plane
// bytes of a round (every plane row of K and V its positions hold) come
// into the warp's shared-memory ring by cp.async, two rounds ahead of the
// one in use. The kind decides only how many bytes a row has, so the copy
// is kind-blind, and a round waits on no other warp. A row group of lpr
// lanes reads a K and a V row from there, a lane 8 stored columns of each
// (8 bytes of a q8_0 or nibble plane, 16 of an f16/bf16 one, and the row's
// scale, min and high-bit words by one vector read where the group count
// divides 8). Each element is dequantized bit for bit as kv_dequant_planes
// does (the integer level made an exact f32 by a byte permute, then the
// rounded product and sum of common.cuh::kv_level); the partial output is
// written back by index in natural order, so q, k_cur, v_cur and the output
// need no permute outside the kernel. The rep query heads' scores are
// reduced by shuffles within the group, and one online-softmax step a round
// folds the U rows' P.V in, in f32 registers. The groups of a warp merge by
// shuffles, the warps in shared memory, and the split writes (o, m, l) to
// the workspace of flash_split.cuh, whose combine kernel, launched from the
// same entry as a programmatic dependent launch, merges the splits and the
// current token. Splits past seq_len (or wholly before the window) exit at
// once. The K and V kinds are launch arguments switched once a round
// (KV_DISPATCH): one instantiation per activation type and head group (RB)
// instead of 49 kind pairs each; q8_0 K and V at head dim 128 and four
// query heads a kv head (the 8B and Mixtral heads) in bf16 take a walk
// compiled for that kind, dim and head group.
//
// Measured (tools/attn_compare.py --only quant, 8B heads, bf16, device
// span; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): the ways tried
// on the way, q8_0 at depth 32765 (bound 0.0225 ms): rows loaded into
// registers inside the kind switch 0.176 ms (K's and V's loads waited on
// each other's arithmetic; 209 registers, one block an SM); a block-wide
// cp.async ring 0.209 (a barrier a round); per-warp rings 0.140-0.156 at
// any occupancy tried (the walk issues too many instructions, not too few
// bytes); the walk compiled for q8_0 0.096, and for head dim 128 too
// 0.076. A butterfly reduction of the 16 scores a lane (15 shuffles, the
// softmax once a lane, then each weight broadcast) read 0.087: slower.
#include <type_traits>

#include "flash_split.cuh"

constexpr int DQ_WARPS = 8;
constexpr int DQ_THREADS = 32 * DQ_WARPS;
constexpr int DQ_MAX_D = 256;
constexpr int DQ_VEC = 8;  // stored columns a lane reads of a row
constexpr int DQ_U = 4;    // rows a group reads per round
constexpr int DQ_STAGES = 3;  // rounds in a warp's shared-memory ring
// the warps' partial results (red) at the widest heads; q and the rings
// take less (16 KB + 8 warps x 3 slots x 4 positions x 1 KB: f16 K and V
// at D = 256), and red takes their place after the walk
constexpr size_t DQ_SMEM_MAX = sizeof(float) * DQ_WARPS * SPLIT_MAX_REP * (DQ_MAX_D + 2);

// Lanes a row: a power of two covering the wider head dim, 8 columns a lane.
__host__ __device__ inline int lanes_a_row(int Dk, int Dv) {
    int lpr = 1;
    while (lpr * DQ_VEC < (Dk > Dv ? Dk : Dv)) lpr <<= 1;
    return lpr;
}

// The per-group words (f32 scales or mins, int32 high bits) of one row that
// stored columns c0..c0+7 use: w[e] is group (c0 + e) % G's. Where G
// divides 8 (head dims 32, 64, 128, 256) every lane needs groups e % G, read
// with one vector load; other G read each word.
__device__ __forceinline__ void group_words(const void* row, int G, int c0, uint32_t (&w)[8]) {
    const uint32_t* p = static_cast<const uint32_t*>(row);
    if (G == 4) {
        const uint4 a = *reinterpret_cast<const uint4*>(p);
        const uint32_t v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = v[e & 3];
    } else if (G == 8) {
        const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
        w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else if (G == 2) {
        const uint2 a = *reinterpret_cast<const uint2*>(p);
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = e & 1 ? a.y : a.x;
    } else if (G == 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = p[0];
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = p[(c0 + e) % G];
    }
}

// c / G and c % G for a group count G: shifts where G is a power of two
// (head dims 32, 64, 128, 256), else a division.
__device__ __forceinline__ int group_div(int c, int G) {
    return (G & (G - 1)) == 0 ? c >> (__ffs(G) - 1) : c / G;
}

// Natural head-dim index of stored column c (common.cuh::kv_nat).
__device__ __forceinline__ int nat_col(int c, int G) {
    return (c - group_div(c, G) * G) * KV_GS + group_div(c, G);
}

// Stored columns c0..c0+7 of DQ_U rows of one plane set (in shared
// memory), dequantized to f32 bit for bit as kv_dequant_planes
// (common.cuh::kv_level's operations: the integer level exact, one rounded
// product, one rounded sum of the min). A row at a time: few registers.
template <int KIND>
__device__ __forceinline__ void kv_rows(const KVPlanes& p, const size_t (&row)[DQ_U], int D, int G,
                                        int c0, float (&out)[DQ_U][DQ_VEC]) {
#pragma unroll
    for (int u = 0; u < DQ_U; ++u) {
        const KVRow r = kv_row<KIND>(p, row[u], D, G);
        if constexpr (KIND == KV_F16 || KIND == KV_BF16) {
            kv_deq8<KIND>(r, c0, out[u]);
        } else if constexpr (KIND == KV_Q8_0) {
            const uint2 qw = *reinterpret_cast<const uint2*>(r.q + c0);
            uint32_t s[8];
            group_words(r.s, G, c0, s);
            const uint32_t a = qw.x ^ 0x80808080u, b = qw.y ^ 0x80808080u;
            out[u][0] = __fmul_rn(s8_level<0>(a), __uint_as_float(s[0]));
            out[u][1] = __fmul_rn(s8_level<1>(a), __uint_as_float(s[1]));
            out[u][2] = __fmul_rn(s8_level<2>(a), __uint_as_float(s[2]));
            out[u][3] = __fmul_rn(s8_level<3>(a), __uint_as_float(s[3]));
            out[u][4] = __fmul_rn(s8_level<0>(b), __uint_as_float(s[4]));
            out[u][5] = __fmul_rn(s8_level<1>(b), __uint_as_float(s[5]));
            out[u][6] = __fmul_rn(s8_level<2>(b), __uint_as_float(s[6]));
            out[u][7] = __fmul_rn(s8_level<3>(b), __uint_as_float(s[7]));
        } else {
            constexpr bool with_min = KIND == KV_Q4_1 || KIND == KV_Q5_1;
            constexpr bool five = KIND == KV_Q5_0 || KIND == KV_Q5_1;
            // the level's offset (q4_0: -8, q5_0: -16) taken off with 2^23
            constexpr float off =
                8388608.f + (KIND == KV_Q4_0 ? 8.f : KIND == KV_Q5_0 ? 16.f : 0.f);
            const int half = D >> 1;
            const bool hi = c0 >= half;
            const uint2 qw = *reinterpret_cast<const uint2*>(r.q + (hi ? c0 - half : c0));
            uint32_t s[8], mn[8], hb[8];
            group_words(r.s, G, c0, s);
            if constexpr (with_min) group_words(r.m, G, c0, mn);
            if constexpr (five) group_words(r.h, G, c0, hb);
            const int nib = hi ? 4 : 0;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                uint32_t lvl = ((e < 4 ? qw.x : qw.y) >> (8 * (e & 3) + nib)) & 0xFu;
                if constexpr (five) lvl |= ((hb[e] >> group_div(c0 + e, G)) & 1u) << 4;
                float v = __fmul_rn(__uint_as_float(0x4B000000u | lvl) - off, __uint_as_float(s[e]));
                if constexpr (with_min) v = __fadd_rn(v, __uint_as_float(mn[e]));
                out[u][e] = v;
            }
        }
    }
}

// kv_rows for a kind known at compile time (FIXED >= 0) or only at run
// time (FIXED < 0: switched on uniformly, KV_DISPATCH).
template <int FIXED>
__device__ __forceinline__ void kind_rows(int kind, const KVPlanes& p, const size_t (&row)[DQ_U],
                                          int D, int G, int c0, float (&out)[DQ_U][DQ_VEC]) {
    if constexpr (FIXED >= 0) {
        kv_rows<FIXED>(p, row, D, G, c0, out);
    } else {
        KV_DISPATCH(kind, kv_rows, p, row, D, G, c0, out)
    }
}

// One split of one (kv head, batch row): partial (o, m, l) of each of the
// rep <= RB query heads into the workspace, o in natural order. st holds
// the layer's planes and the rings' layout. Up to 4 query heads a kv head
// (the 8B and Mixtral heads): two blocks an SM. FIXED: the one kind of K
// and V where the launch has a compiled walk of its own (q8_0:q8_0), else
// -1 and the kinds are switched on each round; DC: the head dim of K and V
// where the walk is compiled for it (128), else 0.
template <typename T, int RB, int FIXED, int DC>
__global__ void __launch_bounds__(DQ_THREADS, RB <= 4 ? 2 : 1)
decode_quant_split_kernel(const T* __restrict__ q, const KVStage st, int kind_k, int kind_v,
                          const int* __restrict__ seq_len, float* __restrict__ ws, int S, int H,
                          int Hkv, int Dk_, int Dv_, int s_eff, int n_split, int split_len,
                          float scale, float softcap, int window) {
    const int Dk = DC ? DC : Dk_, Dv = DC ? DC : Dv_;
    // q [rep][Dk] in K's stored column order, then each warp's ring of
    // DQ_STAGES slots; after the walk, the warps' partials
    // red: o [W][rep][Dv], m [W][rep], l [W][rep]
    extern __shared__ __align__(16) unsigned char dq_smem[];
    float* red = reinterpret_cast<float*>(dq_smem);
    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int rep = H / Hkv;
    const int n = seq_len[b];
    const int n_end = min(n, s_eff);
    const int lo = split_window_lo(n, window);
    split_launch_dependents();
    if (!split_live(sp, split_len, n_end, lo)) return;
    const int start = max(sp * split_len, lo);
    const int stop = min(sp * split_len + split_len, n_end);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lpr = lanes_a_row(Dk, Dv);
    const int ch = lane & (lpr - 1), grp = lane / lpr, rpw = 32 / lpr;
    const int c0 = ch * DQ_VEC;  // this lane's first stored column of a row
    const bool k_on = c0 < Dk, v_on = c0 < Dv;
    const int Gk = Dk / KV_GS, Gv = Dv / KV_GS;
    const size_t row0 = (size_t)b * S * Hkv + hk;  // plane row of (b, position 0, hk)

    float* qs = reinterpret_cast<float*>(dq_smem);
    for (int i = tid; i < rep * Dk; i += DQ_THREADS) {
        const int r = i / Dk, c = i - r * Dk;
        qs[i] = to_f32(q[((size_t)b * H + hk * rep + r) * Dk + nat_col(c, Gk)]);
    }
    float acc[RB][DQ_VEC], m[RB], l[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        m[r] = MASKED;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < DQ_VEC; ++e) acc[r][e] = 0.f;
    }
    __syncthreads();

    // This warp's rows of round rd: positions first + [0, RW), first =
    // start + rd * P + warp * RW; a lane's are grp + u * rpw. Each warp
    // copies and reads its own ring, so a round needs no block barrier.
    const int RW = st.rows, P = DQ_WARPS * RW;
    unsigned char* ring = dq_smem + st.q_bytes + (size_t)warp * DQ_STAGES * st.bytes;
    auto copy_plane = [&](unsigned char* base, int j, int first, int rb, int unit, int sh) {
        const int per = rb / unit;
        for (int i = lane; i < RW * per; i += 32) {
            const int lp = sh >= 0 ? i >> sh : i / per, c = i - lp * per;
            const int pos = first + lp;
            const bool ok = pos < stop;
            const uint8_t* src = st.src[j] + (row0 + (size_t)(ok ? pos : start) * Hkv) * rb + c * unit;
            cp_async_n(base + st.off[j] + lp * rb + c * unit, src, unit, ok);
        }
    };
    auto issue = [&](int slot, int first) {  // past stop: zeros, nothing read
        unsigned char* base = ring + (size_t)slot * st.bytes;
        if constexpr (FIXED == KV_Q8_0 && DC == 128) {
            // the planes are known: q (128 bytes a row) and s (16) of K and V
            copy_plane(base, 0, first, DC, 16, 3);
            copy_plane(base, 1, first, DC / 8, 16, 0);
            copy_plane(base, 4, first, DC, 16, 3);
            copy_plane(base, 5, first, DC / 8, 16, 0);
        } else {
#pragma unroll 1
            for (int j = 0; j < KV_STAGE_PLANES; ++j)
                if (st.rowb[j]) copy_plane(base, j, first, st.rowb[j], st.unit[j], st.per_log2[j]);
        }
    };
    auto slot_planes = [&](int slot, int first_plane) {  // K's (0) or V's (4)
        const unsigned char* base = ring + (size_t)slot * st.bytes;
        return KVPlanes{base + st.off[first_plane],
                        reinterpret_cast<const float*>(base + st.off[first_plane + 1]),
                        reinterpret_cast<const float*>(base + st.off[first_plane + 2]),
                        reinterpret_cast<const int*>(base + st.off[first_plane + 3])};
    };

    const int mine = stop - start - warp * RW;  // positions from this warp's first on
    const int rounds = mine > 0 ? (mine + P - 1) / P : 0;
    const int first0 = start + warp * RW;
    if (rounds > 0) issue(0, first0);
    cp_async_commit();
    if (rounds > 1) issue(1, first0 + P);
    cp_async_commit();
    size_t row[DQ_U];  // this lane's rows of a slot
#pragma unroll
    for (int u = 0; u < DQ_U; ++u) row[u] = grp + u * rpw;
    for (int rd = 0; rd < rounds; ++rd) {
        // landed: round rd; the warp barrier also retires every lane's read
        // of the slot refilled below (round rd - 1's)
        cp_async_wait<1>();
        __syncwarp();
        if (rd + 2 < rounds) issue((rd + 2) % DQ_STAGES, first0 + (rd + 2) * P);
        cp_async_commit();
        const int slot = rd % DQ_STAGES;
        bool ok[DQ_U];
#pragma unroll
        for (int u = 0; u < DQ_U; ++u) ok[u] = first0 + rd * P + (int)row[u] < stop;
        // the U rows' scores for every head, reduced over the row's lanes
        float sc[DQ_U][RB];
        {
            float kf[DQ_U][DQ_VEC];
            if (k_on) {
                const KVPlanes kp = slot_planes(slot, 0);
                kind_rows<FIXED>(kind_k, kp, row, Dk, Gk, c0, kf);
            }
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                float qv[DQ_VEC];
                const float4 q0 = k_on ? *reinterpret_cast<const float4*>(qs + min(r, rep - 1) * Dk + c0)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
                const float4 q1 = k_on ? *reinterpret_cast<const float4*>(qs + min(r, rep - 1) * Dk + c0 + 4)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
                qv[0] = q0.x; qv[1] = q0.y; qv[2] = q0.z; qv[3] = q0.w;
                qv[4] = q1.x; qv[5] = q1.y; qv[6] = q1.z; qv[7] = q1.w;
#pragma unroll
                for (int u = 0; u < DQ_U; ++u) {
                    sc[u][r] = 0.f;
                    if (k_on)
#pragma unroll
                        for (int e = 0; e < DQ_VEC; ++e) sc[u][r] = fmaf(qv[e], kf[u][e], sc[u][r]);
                }
            }
        }
        for (int off = 1; off < lpr; off <<= 1)
#pragma unroll
            for (int u = 0; u < DQ_U; ++u)
#pragma unroll
                for (int r = 0; r < RB; ++r)
                    sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
        // one online-softmax step for the U rows: one rescale per head;
        // sc becomes the rows' weights p
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            float m_new = m[r];
#pragma unroll
            for (int u = 0; u < DQ_U; ++u) {
                sc[u][r] = ok[u] ? softcap_score(sc[u][r] * scale, softcap) : MASKED;
                m_new = fmaxf(m_new, sc[u][r]);
            }
            const float alpha = __expf(m[r] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int u = 0; u < DQ_U; ++u) {
                sc[u][r] = ok[u] ? __expf(sc[u][r] - m_new) : 0.f;
                psum += sc[u][r];
            }
            l[r] = l[r] * alpha + psum;
            m[r] = m_new;
#pragma unroll
            for (int e = 0; e < DQ_VEC; ++e) acc[r][e] *= alpha;
        }
        if (v_on) {
            float vf[DQ_U][DQ_VEC];
            const KVPlanes vp = slot_planes(slot, 4);
            kind_rows<FIXED>(kind_v, vp, row, Dv, Gv, c0, vf);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int e = 0; e < DQ_VEC; ++e) {
                    float a = acc[r][e];
#pragma unroll
                    for (int u = 0; u < DQ_U; ++u) a = fmaf(sc[u][r], vf[u][e], a);
                    acc[r][e] = a;
                }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // q and the rings are free: red takes their place

    // merge the row groups of the warp (lanes of one chunk, lpr apart); a
    // group that saw no position has m = MASKED, l = 0, acc = 0
    for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
            const float mn = fmaxf(m[r], mo);
            const float a = __expf(m[r] - mn), c = __expf(mo - mn);
            l[r] = l[r] * a + lo_ * c;
#pragma unroll
            for (int e = 0; e < DQ_VEC; ++e)
                acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * c;
            m[r] = mn;
        }
    }
    float* red_o = red;
    float* red_m = red + DQ_WARPS * rep * Dv;
    float* red_l = red_m + DQ_WARPS * rep;
    if (grp == 0) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            if (r >= rep) break;
            if (v_on)  // stored V column c0 + e holds natural element nat_col(c0 + e)
#pragma unroll
                for (int e = 0; e < DQ_VEC; ++e)
                    red_o[(warp * rep + r) * Dv + nat_col(c0 + e, Gv)] = acc[r][e];
            if (ch == 0) {
                red_m[warp * rep + r] = m[r];
                red_l[warp * rep + r] = l[r];
            }
        }
    }
    __syncthreads();
    // merge the warps; the split is live, so some warp holds a real maximum
    const int ld = Dv + 2;
    float* wsp = ws + (((size_t)b * Hkv + hk) * n_split + sp) * rep * ld;
    for (int i = tid; i < rep * Dv; i += DQ_THREADS) {
        const int r = i / Dv, d = i - r * Dv;
        float mt = MASKED;
#pragma unroll
        for (int w = 0; w < DQ_WARPS; ++w) mt = fmaxf(mt, red_m[w * rep + r]);
        float o = 0.f, lt = 0.f;
#pragma unroll
        for (int w = 0; w < DQ_WARPS; ++w) {
            const float mw = red_m[w * rep + r];
            const float wgt = mw > 0.5f * MASKED ? __expf(mw - mt) : 0.f;
            o += red_o[(w * rep + r) * Dv + d] * wgt;
            lt += red_l[w * rep + r] * wgt;
        }
        wsp[r * ld + d] = o;
        if (d == 0) {
            wsp[r * ld + Dv] = mt;
            wsp[r * ld + Dv + 1] = lt;
        }
    }
}

template <typename T, int RB, int FIXED, int DC>
static cudaError_t launch_split(const T* q, const KVStage& st, int kind_k, int kind_v,
                                const int* seq_len, float* ws, int B, int S, int H, int Hkv,
                                int Dk, int Dv, int s_eff, int n_split, int split_len,
                                float scale, float softcap, int window, cudaStream_t s) {
    static bool attr_set = false;  // once per instantiation, not per launch
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            decode_quant_split_kernel<T, RB, FIXED, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)DQ_SMEM_MAX);
        if (err != cudaSuccess) return err;
        attr_set = true;
    }
    const int rep = H / Hkv;
    const size_t smem = max(sizeof(float) * DQ_WARPS * rep * (Dv + 2),
                            (size_t)st.q_bytes + (size_t)DQ_WARPS * DQ_STAGES * st.bytes);
    decode_quant_split_kernel<T, RB, FIXED, DC><<<dim3(n_split, Hkv, B), DQ_THREADS, smem, s>>>(
        q, st, kind_k, kind_v, seq_len, ws, S, H, Hkv, Dk, Dv, s_eff, n_split, split_len, scale,
        softcap, window);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_decode(const void* q_, const KVPlanes& kp, const KVPlanes& vp,
                                 int kind_k, int kind_v, int B, int S, int H, int Hkv, int Dk,
                                 int Dv, const void* kc, const void* vc, const int* seq_len,
                                 void* out, int s_eff, float scale, float softcap, int window,
                                 float* ws, int n_split, int split_len, cudaStream_t s) {
    const T* q = static_cast<const T*>(q_);
    const int rep = H / Hkv;
    KVStage st = kv_stage(kind_k, kind_v, kp, vp, Dk, Dv, DQ_U * (32 / lanes_a_row(Dk, Dv)));
    st.q_bytes = (int)sizeof(float) * rep * Dk;
    cudaError_t err;
    // q8_0 K and V of head dim 128 at four query heads a kv head (-ctk/-ctv
    // q8_0 on the 8B and Mixtral heads, bf16) take a walk compiled for them:
    // the kind switch and the run-time head dim cost the walk 2x at depth
    // 32765 (the note above). Other head groups and f32 keep the generic
    // walk: the compiled one was measured at this shape only, and every
    // instantiation of it lengthens the build of this source.
    const bool q8 = kind_k == KV_Q8_0 && kind_v == KV_Q8_0 && Dk == 128 && Dv == 128;
#define LCG_SPLIT(RB, FIXED, DC)                                                               \
    launch_split<T, RB, FIXED, DC>(q, st, kind_k, kind_v, seq_len, ws, B, S, H, Hkv, Dk, Dv,    \
                                   s_eff, n_split, split_len, scale, softcap, window, s)
    if (rep <= 1) err = LCG_SPLIT(1, -1, 0);
    else if (rep <= 2) err = LCG_SPLIT(2, -1, 0);
    else if (rep <= 4) {
        if constexpr (std::is_same<T, __nv_bfloat16>::value)
            err = q8 ? LCG_SPLIT(4, KV_Q8_0, 128) : LCG_SPLIT(4, -1, 0);
        else
            err = LCG_SPLIT(4, -1, 0);
    } else if (rep <= 8) err = LCG_SPLIT(8, -1, 0);
    else err = LCG_SPLIT(16, -1, 0);
#undef LCG_SPLIT
    if (err != cudaSuccess) return err;
    // the combine is a programmatic dependent launch: its blocks start
    // while the splits run and wait for them in griddepcontrol.wait
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rep, Hkv, B);
    cfg.blockDim = dim3(COMBINE_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, split_combine_kernel<T>, (const float*)ws, q,
                             static_cast<const T*>(kc), static_cast<const T*>(vc), seq_len,
                             static_cast<T*>(out), H, Hkv, Dk, Dv, s_eff, n_split, split_len,
                             scale, softcap, window);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// q [B, H, Dk], kc/vc [B, Hkv, D], out [B, H, Dv]: contiguous, of the
// element type `dtype`. K and V planes of one layer, each [B, S, Hkv*W]
// contiguous and 16-byte aligned (m/h null where the kind has none);
// seq_len [B] int32; s_eff the attended bound (<= S). ws: f32 workspace
// [B, Hkv, n_split, H / Hkv, Dv + 2]; n_split * split_len >= s_eff.
LCG_EXPORT int lcg_flash_decode_quant(int dtype, int kind_k, int kind_v, const void* q,
                                      const void* kq, const void* ks, const void* km,
                                      const void* kh, const void* vq, const void* vs,
                                      const void* vm, const void* vh, int B, int S, int H,
                                      int Hkv, int Dk, int Dv, const void* kc, const void* vc,
                                      const int* seq_len, void* out, int s_eff, float scale,
                                      float softcap, int window, void* ws, int n_split,
                                      int split_len, void* stream) {
    if (Hkv < 1 || H % Hkv || H / Hkv > SPLIT_MAX_REP || Dk > DQ_MAX_D || Dv > DQ_MAX_D ||
        Dk % KV_GS || Dv % KV_GS || s_eff > S || !kv_kind_ok(kind_k) || !kv_kind_ok(kind_v) ||
        n_split < 1 || n_split > SPLIT_MAX || split_len < 1 ||
        (long long)n_split * split_len < s_eff)
        return static_cast<int>(cudaErrorInvalidValue);
    const KVPlanes kp{kq, static_cast<const float*>(ks), static_cast<const float*>(km),
                      static_cast<const int*>(kh)};
    const KVPlanes vp{vq, static_cast<const float*>(vs), static_cast<const float*>(vm),
                      static_cast<const int*>(vh)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* w = static_cast<float*>(ws);
    const cudaError_t err =
        dtype == DT_BF16
            ? launch_decode<__nv_bfloat16>(q, kp, vp, kind_k, kind_v, B, S, H, Hkv, Dk, Dv, kc,
                                           vc, seq_len, out, s_eff, scale, softcap, window, w,
                                           n_split, split_len, st)
            : launch_decode<float>(q, kp, vp, kind_k, kind_v, B, S, H, Hkv, Dk, Dv, kc, vc,
                                   seq_len, out, s_eff, scale, softcap, window, w, n_split,
                                   split_len, st);
    return static_cast<int>(err);
}

// The pipelined tile of the fused dequant x GEMM over GGUF wire-format
// weights of qgemm.cu (dense weights, K2/K3): Q4_K, Q6_K, Q8_0, Q5_K, the
// legacy Q4_0, Q4_1, Q5_0, Q5_1, the low-bit Q2_K, Q3_K, the codebook
// IQ4_NL, IQ4_XS, IQ3_XXS, IQ3_S, IQ2_S, IQ2_XXS, IQ2_XS, IQ1_S, IQ1_M and
// the ternary TQ1_0, TQ2_0.
//
// A block of QG_THREADS threads (8 warps) owns a BM x QG_BN output tile
// (BM = 128, or 64 where qgemm.cu's grid would leave SMs idle) and
// walks K in stages of a quarter superblock (QG_BK = 64). Two streams run
// ahead of the tensor cores:
//   * the bf16 activation tile [BM, 64] through a three-stage cp.async ring
//     in shared memory, issued two stages before it is multiplied;
//   * the wire bytes of the weight strip, loaded straight into registers
//     one stage ahead of their dequant (each thread holds the 16-byte Q4_K
//     header and 16 qs bytes of one row, or the four 8-byte Q6_K fields,
//     read as aligned words since the 210-byte blocks are only 2-byte
//     aligned: common.cuh::q4k_raw / q6k_raw), and dequantized into one of
//     two bf16 weight tiles [128, 64] in shared memory while the tensor
//     cores multiply the other. The dequant of stage s+1 is cut into four
//     pieces interleaved with the four k16 steps of stage s.
// Shared memory is 90 KB at BM = 128 (63 KB at 64), so two blocks share an
// SM and one's barrier waits hide under the other's work. A stage is the
// 64 weights of one Q4_K or Q5_K group or of two 32-weight blocks of Q8_0,
// the legacy and the codebook kinds (contiguous k), or for Q6_K, Q2_K and Q3_K
// positions 16h..16h+15 of the four 32-weight quarters of one 128-weight
// chunk (qg_quartered): the activation tile takes those same k columns, so
// the product is unchanged and each stage reads each wire byte once. Products are mma.sync m16n8k16
// bf16 x bf16 -> f32 with both operands read by ldmatrix from rows padded
// to 72 elements (conflict-free). Warps are 2 x 4, each a (BM/2) x 32 piece
// of the tile.
//
// Each weight is formed exactly as the plain torch dequant forms it —
// (d*sc)*q - dmin*m for Q4_K, Q5_K and Q2_K, (d*sc)*(q-32) for Q6_K, q*d for
// Q8_0, (q-8)*d and (q-16)*d for Q4_0 and Q5_0, q*d + m for Q4_1 and Q5_1,
// d*(sc-32)*(q-4 or q) for Q3_K, (scale*level)*sign for the codebook
// kinds (IQ1: (scale/8)*(8 level), the same product), (q-1)*d for the
// ternary kinds, each product and sum rounded once — and then rounded to bf16; the level
// plus a bias (Q8_0: the signed level, common.cuh::s8_level) becomes an
// exact f32 by one byte permute (common.cuh::level_plus), with no
// int->float conversion, and one fused multiply-add takes the bias off
// while it forms d*sc*q, exactly (the product needs at most 23 bits). Rows past B read as zero and are not written;
// weight rows past n repeat row n - 1 and are not written.
#pragma once

#include "common.cuh"

constexpr int QG_BN = 128;          // weight rows per block
constexpr int QG_BK = 64;           // K per stage: a quarter superblock
constexpr int QG_LDS = QG_BK + 8;   // bf16 row stride of the A and B tiles
constexpr int QG_X_STAGES = 3;      // activation tiles in the ring
constexpr int QG_THREADS = 2 * QG_BN;  // 8 warps; two threads dequantize a weight row

__host__ __device__ constexpr size_t qg_smem_bytes(int BM) {
    return ((size_t)QG_X_STAGES * BM + 2 * (size_t)QG_BN) * QG_LDS * 2;
}

// One thread's dequant of one stage: weight row r = tid / 2, slot i = 2q + g
// (g = tid % 2) of the stage's superblock, q its quarter (common.cuh's qmv
// slots: Q4_K group j = q, qs bytes 16i..; Q6_K chunk q / 2, positions
// 16(q % 2) + 8g..+7 of each quarter). Piece p (0..3) writes 8 weights.
template <int KIND>
struct QgStage;

template <>
struct QgStage<KIND_Q4_K> {
    uint32_t qs[4];
    float dl0, ml0, dl1, ml1;
    float n0, n1;  // -16 dl: d*sc (17 bits) times 16 + q is exact, so fma(dl, 16 + q, -16 dl) = dl*q
    int g;

    __device__ __forceinline__ QgStage(const Q4KRaw& r, int i) : g(i & 1) {
        const int j = i >> 1;
        const float d = f16_bits(r.h.x & 0xFFFF), dmin = f16_bits(r.h.x >> 16);
        int sc0, m0, sc1, m1;
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j, sc0, m0);
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j + 1, sc1, m1);
        dl0 = __fmul_rn(d, u23_f32(sc0));
        ml0 = __fmul_rn(dmin, u23_f32(m0));
        dl1 = __fmul_rn(d, u23_f32(sc1));
        ml1 = __fmul_rn(dmin, u23_f32(m1));
        n0 = -16.f * dl0;
        n1 = -16.f * dl1;
        qs[0] = r.q.x; qs[1] = r.q.y; qs[2] = r.q.z; qs[3] = r.q.w;
    }

    // (d*sc)*q - dmin*m rounded as the plain dequant rounds it: the product
    // is exact (at most 21 significant bits), then one rounded subtract
    __device__ __forceinline__ float w0(float lv) const { return __fsub_rn(__fmaf_rn(dl0, lv, n0), ml0); }
    __device__ __forceinline__ float w1(float lv) const { return __fsub_rn(__fmaf_rn(dl1, lv, n1), ml1); }

    // qs word p -> columns 16g + 4p.. (low nibbles, sub-block 2j) and
    // 32 + 16g + 4p.. (high nibbles, sub-block 2j + 1)
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        const uint32_t w = qs[p];
        // each nibble as 0x80 | q << 3: the high mantissa byte of 16 + q
        const uint32_t lo = ((w << 3) & 0x78787878u) | 0x80808080u;
        const uint32_t hi = ((w >> 1) & 0x78787878u) | 0x80808080u;
        const uint2 a = {pack_bf16x2(w0(level_plus<16, 0>(lo)), w0(level_plus<16, 1>(lo))),
                         pack_bf16x2(w0(level_plus<16, 2>(lo)), w0(level_plus<16, 3>(lo)))};
        const uint2 b = {pack_bf16x2(w1(level_plus<16, 0>(hi)), w1(level_plus<16, 1>(hi))),
                         pack_bf16x2(w1(level_plus<16, 2>(hi)), w1(level_plus<16, 3>(hi)))};
        *reinterpret_cast<uint2*>(row + 16 * g + 4 * p) = a;
        *reinterpret_cast<uint2*>(row + 32 + 16 * g + 4 * p) = b;
    }
};

template <>
struct QgStage<KIND_Q6_K> {
    uint32_t f[3][2];  // ql low, ql high, qh: 8 bytes each, shifted into place
    float dl[4];       // d * scale of quarter qt at these positions
    float n96[4];      // -96 dl: fma(dl, 64 + q, -96 dl) = dl*(q - 32) rounded once, as plain
    int g;

    __device__ __forceinline__ QgStage(const Q6KRaw& r, int i) : g(i & 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            f[k][0] = __funnelshift_r(r.w[k][0], r.w[k][1], r.shift);
            f[k][1] = __funnelshift_r(r.w[k][1], r.w[k][2], r.shift);
        }
        const float d = f16_bits(r.d);
        const int h = (i & 3) >> 1;  // which of the chunk's two 16-element scales
        const uint32_t s01 = __funnelshift_r(r.w[3][0], r.w[3][1], r.shift) >> (8 * h);
        const uint32_t s23 = __funnelshift_r(r.w[3][1], r.w[3][2], r.shift) >> (8 * h);
        dl[0] = __fmul_rn(d, s8_f32(s01 & 0xFF));
        dl[1] = __fmul_rn(d, s8_f32((s01 >> 16) & 0xFF));
        dl[2] = __fmul_rn(d, s8_f32(s23 & 0xFF));
        dl[3] = __fmul_rn(d, s8_f32((s23 >> 16) & 0xFF));
#pragma unroll
        for (int qt = 0; qt < 4; ++qt) n96[qt] = -96.f * dl[qt];
    }

    // quarter p, positions 8g..8g+7 of the stage's 16 -> columns 16p + 8g..
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t a = f[0][e], b = f[1][e], h = f[2][e];
            const uint32_t q = p == 0 ? (a & 0x0F0F0F0Fu) | ((h << 4) & 0x30303030u)
                             : p == 1 ? (b & 0x0F0F0F0Fu) | ((h << 2) & 0x30303030u)
                             : p == 2 ? ((a >> 4) & 0x0F0F0F0Fu) | (h & 0x30303030u)
                                      : ((b >> 4) & 0x0F0F0F0Fu) | ((h >> 2) & 0x30303030u);
            const uint32_t m = (q << 1) | 0x80808080u;  // high mantissa bytes of 64 + q
            v[2 * e] = pack_bf16x2(__fmaf_rn(dl[p], level_plus<64, 0>(m), n96[p]),
                                   __fmaf_rn(dl[p], level_plus<64, 1>(m), n96[p]));
            v[2 * e + 1] = pack_bf16x2(__fmaf_rn(dl[p], level_plus<64, 2>(m), n96[p]),
                                       __fmaf_rn(dl[p], level_plus<64, 3>(m), n96[p]));
        }
        *reinterpret_cast<uint4*>(row + 16 * p + 8 * g) = make_uint4(v[0], v[1], v[2], v[3]);
    }
};

template <>
struct QgStage<KIND_Q5_K> {
    uint32_t qs[4], qh[4];
    float dl0, ml0, dl1, ml1;
    float n0, n1;  // -32 dl: d*sc (17 bits) times 32 + q is exact, so fma(dl, 32 + q, -32 dl) = dl*q
    int g, j;

    __device__ __forceinline__ QgStage(const Q5KRaw& r, int i) : g(i & 1), j(i >> 1) {
        const float d = f16_bits(r.h.x & 0xFFFF), dmin = f16_bits(r.h.x >> 16);
        int sc0, m0, sc1, m1;
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j, sc0, m0);
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j + 1, sc1, m1);
        dl0 = __fmul_rn(d, u23_f32(sc0));
        ml0 = __fmul_rn(dmin, u23_f32(m0));
        dl1 = __fmul_rn(d, u23_f32(sc1));
        ml1 = __fmul_rn(dmin, u23_f32(m1));
        n0 = -32.f * dl0;
        n1 = -32.f * dl1;
        qs[0] = r.q.x; qs[1] = r.q.y; qs[2] = r.q.z; qs[3] = r.q.w;
        qh[0] = r.qh.x; qh[1] = r.qh.y; qh[2] = r.qh.z; qh[3] = r.qh.w;
    }

    __device__ __forceinline__ float w0(float lv) const { return __fsub_rn(__fmaf_rn(dl0, lv, n0), ml0); }
    __device__ __forceinline__ float w1(float lv) const { return __fsub_rn(__fmaf_rn(dl1, lv, n1), ml1); }

    // as Q4_K's piece, the fifth bits from qh word p
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        uint32_t lo, hi;
        q5k_bytes(qs[p], qh[p], j, lo, hi);
        const uint2 a = {pack_bf16x2(w0(level_plus<32, 0>(lo)), w0(level_plus<32, 1>(lo))),
                         pack_bf16x2(w0(level_plus<32, 2>(lo)), w0(level_plus<32, 3>(lo)))};
        const uint2 b = {pack_bf16x2(w1(level_plus<32, 0>(hi)), w1(level_plus<32, 1>(hi))),
                         pack_bf16x2(w1(level_plus<32, 2>(hi)), w1(level_plus<32, 3>(hi)))};
        *reinterpret_cast<uint2*>(row + 16 * g + 4 * p) = a;
        *reinterpret_cast<uint2*>(row + 32 + 16 * g + 4 * p) = b;
    }
};

// Q8_0: slot i = 2q + g is block i of the superblock, the stage's columns
// 32g..32g+31.
template <>
struct QgStage<KIND_Q8_0> {
    uint32_t qs[8];
    float d;
    int g;

    __device__ __forceinline__ QgStage(const Q80Raw& r, int i) : g(i & 1) {
        d = f16_bits(q80_d(r));
#pragma unroll
        for (int k = 0; k < 8; ++k) qs[k] = q80_qs(r, k) ^ 0x80808080u;
    }

    // q * d, one rounding, as the plain dequant; piece p -> columns 32g + 8p..
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t w = qs[2 * p + e];
            v[2 * e] = pack_bf16x2(__fmul_rn(s8_level<0>(w), d), __fmul_rn(s8_level<1>(w), d));
            v[2 * e + 1] = pack_bf16x2(__fmul_rn(s8_level<2>(w), d), __fmul_rn(s8_level<3>(w), d));
        }
        *reinterpret_cast<uint4*>(row + 32 * g + 8 * p) = make_uint4(v[0], v[1], v[2], v[3]);
    }
};

// The legacy kinds: slot i = 2q + g is block i of the superblock, the
// stage's columns 32g..32g+31, as Q8_0's.
template <int KIND>
struct QgLegacyStage {
    LegacyFields f;
    float d, m, nb;  // nb = -(B + offset) d: fma(d, B + q, nb) = d (q - offset), exact
    int g;

    __device__ __forceinline__ QgLegacyStage(const LegacyRaw<KIND>& r, int i)
        : f(legacy_fields<KIND>(r)), g(i & 1) {
        d = f16_bits(f.dm & 0xFFFF);
        m = legacy_has_min(KIND) ? f16_bits(f.dm >> 16) : 0.f;
        nb = -(legacy_bias<KIND>() + legacy_offset<KIND>()) * d;
    }

    // (q - 8) * d, (q - 16) * d or q * d + m, rounded as the plain dequant:
    // the product is exact (at most 16 significant bits), then one rounded add
    __device__ __forceinline__ float w(float lv) const {
        const float p = __fmaf_rn(d, lv, nb);
        return legacy_has_min(KIND) ? __fadd_rn(p, m) : p;
    }

    // piece p -> columns 32g + 8p..: elements 8p..8p+7 of the block, the low
    // nibbles of qs words 2p, 2p + 1 (p < 2) or the high nibbles of words
    // 2p - 4, 2p - 3
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        constexpr int B = legacy_5bit(KIND) ? 32 : 16;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            uint32_t lo, hi;
            legacy_bytes<KIND>(f, 2 * (p & 1) + e, lo, hi);
            const uint32_t b = p < 2 ? lo : hi;
            v[2 * e] = pack_bf16x2(w(level_plus<B, 0>(b)), w(level_plus<B, 1>(b)));
            v[2 * e + 1] = pack_bf16x2(w(level_plus<B, 2>(b)), w(level_plus<B, 3>(b)));
        }
        *reinterpret_cast<uint4*>(row + 32 * g + 8 * p) = make_uint4(v[0], v[1], v[2], v[3]);
    }
};

// Q2_K and Q3_K: Q6_K's stage (slot i = 2q + g: chunk q / 2, positions
// 16(q % 2) + 8g..+7 of each quarter), a quarter a piece.
template <int KIND>
struct QgLowKStage {
    uint32_t q[2], h[2];  // code and hmask bytes of the slot's 8 positions
    float dl[4], ml[4];   // each quarter's d * sc (Q3_K: d * (sc - 32)) and dmin * m
    float nn[4];          // -16 dl (Q3_K: -20 dl, the code's - 4 too): exact, as Q4_K's
    int c, g;

    __device__ __forceinline__ QgLowKStage(const QmvRaw<KIND>& r, int i) : c(i >> 2), g(i & 1) {
        low_k_fields<KIND>(r, q, h);
        low_k_scales<KIND>(r, i, dl, ml);
#pragma unroll
        for (int qt = 0; qt < 4; ++qt) nn[qt] = (KIND == KIND_Q2_K ? -16.f : -20.f) * dl[qt];
    }

    __device__ __forceinline__ float w(int p, float lv) const {
        const float x = __fmaf_rn(dl[p], lv, nn[p]);
        return KIND == KIND_Q2_K ? __fsub_rn(x, ml[p]) : x;
    }

    // quarter p, positions 8g..8g+7 of the stage's 16 -> columns 16p + 8g..
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t b = low_k_bytes<KIND>(q[e], h[e], c, p);
            v[2 * e] = pack_bf16x2(w(p, level_plus<16, 0>(b)), w(p, level_plus<16, 1>(b)));
            v[2 * e + 1] = pack_bf16x2(w(p, level_plus<16, 2>(b)), w(p, level_plus<16, 3>(b)));
        }
        *reinterpret_cast<uint4*>(row + 16 * p + 8 * g) = make_uint4(v[0], v[1], v[2], v[3]);
    }
};

// The codebook and ternary kinds: slot i = 2q + g is sub-block i of the
// superblock, the stage's columns 32g..32g+31, as Q8_0's. The constructor
// looks up the slot's 32 levels (common.cuh::iq_slot: the grid reads, the
// signs, the trits); each weight is scale * level, one rounding, as the
// plain dequant's (scale * grid) * sign (the sign is exact).
template <int KIND>
struct QgIQStage {
    uint32_t x80[8];  // word k: 128 + the levels of elements 4k..4k+3
    float sc[2];      // IQ2_S, IQ2_XS, IQ1_M: elements 0-15, 16-31; else both the one scale
    int g;

    __device__ __forceinline__ QgIQStage(const QmvRaw<KIND>& r, int i) : g(i & 1) {
        iq_slot<KIND>(r, i, x80, sc);
    }

    // piece p -> columns 32g + 8p..: elements 8p..8p+7, words 2p, 2p + 1
    __device__ __forceinline__ void piece(int p, __nv_bfloat16* row) const {
        const float d = sc[p >> 1];
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t w = x80[2 * p + e];
            v[2 * e] = pack_bf16x2(__fmul_rn(d, s8_level<0>(w)), __fmul_rn(d, s8_level<1>(w)));
            v[2 * e + 1] = pack_bf16x2(__fmul_rn(d, s8_level<2>(w)), __fmul_rn(d, s8_level<3>(w)));
        }
        *reinterpret_cast<uint4*>(row + 32 * g + 8 * p) = make_uint4(v[0], v[1], v[2], v[3]);
    }
};

#define QG_STAGE_OF(KIND, BASE)                                                 \
    template <>                                                                 \
    struct QgStage<KIND> : BASE<KIND> {                                         \
        __device__ __forceinline__ QgStage(const QmvRaw<KIND>& r, int i) : BASE<KIND>(r, i) {} \
    };
QG_STAGE_OF(KIND_Q4_0, QgLegacyStage)
QG_STAGE_OF(KIND_Q4_1, QgLegacyStage)
QG_STAGE_OF(KIND_Q5_0, QgLegacyStage)
QG_STAGE_OF(KIND_Q5_1, QgLegacyStage)
QG_STAGE_OF(KIND_Q2_K, QgLowKStage)
QG_STAGE_OF(KIND_Q3_K, QgLowKStage)
QG_STAGE_OF(KIND_IQ4_NL, QgIQStage)
QG_STAGE_OF(KIND_IQ4_XS, QgIQStage)
QG_STAGE_OF(KIND_IQ3_XXS, QgIQStage)
QG_STAGE_OF(KIND_IQ3_S, QgIQStage)
QG_STAGE_OF(KIND_IQ2_S, QgIQStage)
QG_STAGE_OF(KIND_IQ2_XXS, QgIQStage)
QG_STAGE_OF(KIND_IQ2_XS, QgIQStage)
QG_STAGE_OF(KIND_IQ1_S, QgIQStage)
QG_STAGE_OF(KIND_IQ1_M, QgIQStage)
QG_STAGE_OF(KIND_TQ1_0, QgIQStage)
QG_STAGE_OF(KIND_TQ2_0, QgIQStage)
#undef QG_STAGE_OF

// Whether a stage holds 16 positions of each quarter of a 128-weight chunk
// (Q6_K, Q2_K, Q3_K) rather than 64 contiguous weights.
template <int KIND>
__host__ __device__ constexpr bool qg_quartered() { return KIND == KIND_Q6_K || kind_low_k(KIND); }

// out[m0.., n0..] (row stride n) = x[m0..m0+BM-1, :K] @ bf16(dequant(wq rows
// n0..n0+127))^T for the [n, K] wire weight `wq` of KIND. Needs
// qg_smem_bytes(BM) of dynamic shared memory.
template <int BM, int KIND>
__device__ __forceinline__ void qgemm_tile(const uint8_t* __restrict__ wq, int n, int row_bytes,
                                           const __nv_bfloat16* __restrict__ x, int B, int K,
                                           int m0, int n0, float* __restrict__ out) {
    constexpr int WM = BM / 2;   // rows a warp
    constexpr int MT = WM / 16;  // m16 tiles a warp
    constexpr int NT = 4;        // n8 tiles a warp (32 weight rows)
    constexpr int bpb = kind_sb_bytes(KIND);
    extern __shared__ __align__(128) unsigned char qg_smem[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(qg_smem);  // [X_STAGES][BM][LDS]
    __nv_bfloat16* Bs = As + QG_X_STAGES * BM * QG_LDS;               // [2][BN][LDS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int n_st = K / QG_BK;
    // this thread's dequant: weight row r (row n - 1 again past n), slot parity g
    const int r = tid >> 1, g = tid & 1;
    const uint8_t* wrow = wq + (size_t)min(n0 + r, n - 1) * row_bytes;

    // activation columns of stage s: 64 in a row, or four runs of 16 (qg_quartered)
    auto load_x = [&](int s) {
        __nv_bfloat16* dst = As + (s % QG_X_STAGES) * BM * QG_LDS;
        const int q = s & 3;
        const int k0 = (s >> 2) * QK_K +
                       (!qg_quartered<KIND>() ? 64 * q : 128 * (q >> 1) + 16 * (q & 1));
        for (int i = tid; i < BM * (QG_BK / 8); i += QG_THREADS) {
            const int rr = i >> 3, ch = i & 7;
            const int m = m0 + rr;
            const bool ok = m < B;
            const int col = !qg_quartered<KIND>() ? 8 * ch : 32 * (ch >> 1) + 8 * (ch & 1);
            cp_async16(dst + rr * QG_LDS + 8 * ch, x + (size_t)(ok ? m : 0) * K + k0 + col, ok);
        }
    };
    auto load_raw = [&](int s) {
        return qmv_raw<KIND>(wrow + (size_t)(s >> 2) * bpb, 2 * (s & 3) + g);
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // prologue: activation stages 0 and 1 in flight, stage 0 dequantized,
    // the raw bytes of stage 1 in registers
    load_x(0);
    cp_async_commit();
    if (n_st > 1) load_x(1);
    cp_async_commit();
    QmvRaw<KIND> raw = load_raw(0);
    {
        const QgStage<KIND> dq(raw, 2 * 0 + g);
#pragma unroll
        for (int p = 0; p < 4; ++p) dq.piece(p, Bs + r * QG_LDS);
    }
    if (n_st > 1) raw = load_raw(1);

    for (int s = 0; s < n_st; ++s) {
        // landed: activations of stage s; the barrier also publishes the
        // weight tile of stage s and retires every read of the buffers
        // refilled below
        cp_async_wait<1>();
        __syncthreads();
        if (s + 2 < n_st) load_x(s + 2);
        cp_async_commit();
        const bool next = s + 1 < n_st;
        const QgStage<KIND> dq(raw, 2 * ((s + 1) & 3) + g);  // unused on the last stage
        if (s + 2 < n_st) raw = load_raw(s + 2);
        __nv_bfloat16* dst = Bs + ((s + 1) & 1) * QG_BN * QG_LDS + r * QG_LDS;
        const __nv_bfloat16* A = As + (s % QG_X_STAGES) * BM * QG_LDS + (wm * WM) * QG_LDS;
        const __nv_bfloat16* Bt = Bs + (s & 1) * QG_BN * QG_LDS + (wn * 32) * QG_LDS;
#pragma unroll
        for (int kk = 0; kk < QG_BK / 16; ++kk) {
            uint32_t a[MT][4], b[NT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i)
                ldsm_x4(a[i], A + (i * 16 + (lane & 15)) * QG_LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j2 = 0; j2 < NT / 2; ++j2) {
                uint32_t t[4];
                ldsm_x4(t, Bt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * QG_LDS + kk * 16 +
                               ((lane >> 3) & 1) * 8);
                b[2 * j2][0] = t[0];
                b[2 * j2][1] = t[1];
                b[2 * j2 + 1][0] = t[2];
                b[2 * j2 + 1][1] = t[3];
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
            if (next) dq.piece(kk, dst);
        }
    }

    // epilogue: fragments straight to the f32 output
    const int gq = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * WM + i * 16 + gq + 8 * h;
            if (m >= B) continue;
            float* o = out + (size_t)m * n;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int col = n0 + wn * 32 + j * 8 + t2;
                if (col < n) o[col] = acc[i][j][2 * h];
                if (col + 1 < n) o[col + 1] = acc[i][j][2 * h + 1];
            }
        }
    }
}

// qgemm_tile for a weight kind known only at run time (uniform per block)
// out of the set KSET (common.cuh: KS_Q4K_Q6K, KS_Q4KM, KS_ALL, KS_IQ,
// KS_IQ_LOW).
template <int BM, int KSET>
__device__ __forceinline__ void qgemm_tile_kind(const uint8_t* wq, int kind, int n, int row_bytes,
                                                const __nv_bfloat16* x, int B, int K, int m0,
                                                int n0, float* out) {
    if (kind == KIND_Q4_K) qgemm_tile<BM, KIND_Q4_K>(wq, n, row_bytes, x, B, K, m0, n0, out);
    else if (KSET == KS_Q4K_Q6K || kind == KIND_Q6_K)
        qgemm_tile<BM, KIND_Q6_K>(wq, n, row_bytes, x, B, K, m0, n0, out);
    else if constexpr (KSET == KS_Q4KM) {
        if (kind == KIND_Q8_0) qgemm_tile<BM, KIND_Q8_0>(wq, n, row_bytes, x, B, K, m0, n0, out);
        else qgemm_tile<BM, KIND_Q5_K>(wq, n, row_bytes, x, B, K, m0, n0, out);
    } else if constexpr (KSET == KS_ALL) {
        switch (kind) {
#define QG_CASE(KIND) \
    case KIND: qgemm_tile<BM, KIND>(wq, n, row_bytes, x, B, K, m0, n0, out); break;
            QG_CASE(KIND_Q8_0) QG_CASE(KIND_Q5_K) QG_CASE(KIND_Q4_0) QG_CASE(KIND_Q4_1)
            QG_CASE(KIND_Q5_0) QG_CASE(KIND_Q5_1) QG_CASE(KIND_Q2_K)
            default: qgemm_tile<BM, KIND_Q3_K>(wq, n, row_bytes, x, B, K, m0, n0, out); break;
        }
    } else if constexpr (KSET == KS_IQ) {
        switch (kind) {
            QG_CASE(KIND_Q8_0) QG_CASE(KIND_Q5_K) QG_CASE(KIND_IQ4_NL) QG_CASE(KIND_IQ4_XS)
            QG_CASE(KIND_IQ3_XXS) QG_CASE(KIND_IQ3_S)
            default: qgemm_tile<BM, KIND_IQ2_S>(wq, n, row_bytes, x, B, K, m0, n0, out); break;
        }
    } else if constexpr (KSET == KS_IQ_LOW) {
        switch (kind) {
            QG_CASE(KIND_Q8_0) QG_CASE(KIND_Q5_K) QG_CASE(KIND_IQ3_S) QG_CASE(KIND_IQ2_XXS)
            QG_CASE(KIND_IQ2_XS) QG_CASE(KIND_IQ1_S) QG_CASE(KIND_IQ1_M) QG_CASE(KIND_TQ1_0)
            default: qgemm_tile<BM, KIND_TQ2_0>(wq, n, row_bytes, x, B, K, m0, n0, out); break;
        }
    }
#undef QG_CASE
}

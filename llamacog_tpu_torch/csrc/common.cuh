// Shared helpers for the hand-written Hopper kernels of llamacog_tpu_torch.
//
// Every kernel source is compiled on its own into a shared library with a
// plain C interface (ops/cuda/build.py) and bound with ctypes. Each exported
// launcher queues its kernel on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LCG_EXPORT extern "C" __attribute__((visibility("default")))

// quantized weight kinds (GGUF wire format, ggml-common.h block_q4_K,
// block_q6_K, block_q8_0, block_q5_K, block_q4_0, block_q4_1, block_q5_0,
// block_q5_1, block_q2_K, block_q3_K, block_iq4_nl, block_iq4_xs,
// block_iq3_xxs, block_iq3_s, block_iq2_s, block_iq2_xxs, block_iq2_xs,
// block_iq1_s, block_iq1_m, block_tq1_0, block_tq2_0), numbered as qmm.py's
// _KIND_ID
enum { KIND_Q4_K = 0, KIND_Q6_K = 1, KIND_Q8_0 = 2, KIND_Q5_K = 3, KIND_Q4_0 = 4, KIND_Q4_1 = 5,
       KIND_Q5_0 = 6, KIND_Q5_1 = 7, KIND_Q2_K = 8, KIND_Q3_K = 9, KIND_IQ4_NL = 10,
       KIND_IQ4_XS = 11, KIND_IQ3_XXS = 12, KIND_IQ3_S = 13, KIND_IQ2_S = 14,
       KIND_IQ2_XXS = 15, KIND_IQ2_XS = 16, KIND_IQ1_S = 17, KIND_IQ1_M = 18, KIND_TQ1_0 = 19,
       KIND_TQ2_0 = 20 };
// The codebook kinds of 2.5 to 4.5 bits a weight (levels from a table:
// quant/iq_tables.py).
__host__ __device__ constexpr bool kind_iq(int kind) {
    return kind >= KIND_IQ4_NL && kind <= KIND_IQ2_S;
}
// The 1.5 to 2.3 bit codebook kinds and the ternary ones.
__host__ __device__ constexpr bool kind_iq_low(int kind) {
    return kind >= KIND_IQ2_XXS && kind <= KIND_TQ2_0;
}
// Every kind whose levels are small signed integers under a scale with no
// offset, looked up by common.cuh::iq_slot.
__host__ __device__ constexpr bool kind_signed(int kind) { return kind_iq(kind) || kind_iq_low(kind); }
// The kinds one instantiation of a weight kernel takes: a dense Q4_K_M
// llama's (Q4_K, Q6_K), a Q4_K_M file's (those and an 8-expert model's Q8_0
// attn_k/attn_v and Q5_K attn_output), every kind but the codebook and
// ternary ones (KS_ALL), the codebook kinds with the four of a Q4_K_M file,
// which they share launches with (an IQ preset's Q4_K or Q5_K attn_v, an
// 8-expert model's Q8_0 attn_k/attn_v), and the 1-2 bit and ternary kinds
// with those four and IQ3_S (KS_IQ_LOW: an IQ2_S preset's attn_v below four
// query heads a kv head). A kernel's register count is that of its widest
// kind, so the launches of the smaller sets keep instantiations that the
// other kinds do not widen. A launch whose kinds no one set holds is
// refused (the Python side splits it: ops/cuda/qmm.py::share_launch).
enum { KS_Q4K_Q6K = 0, KS_Q4KM = 1, KS_ALL = 2, KS_IQ = 3, KS_IQ_LOW = 4 };
__host__ __device__ constexpr bool kind_in_set(int kind, int set) {
    return set == KS_ALL ? !kind_signed(kind)
         : kind == KIND_Q4_K || kind == KIND_Q6_K ||
           (set != KS_Q4K_Q6K && (kind == KIND_Q8_0 || kind == KIND_Q5_K)) ||
           (set == KS_IQ && kind_iq(kind)) ||
           (set == KS_IQ_LOW && (kind_iq_low(kind) || kind == KIND_IQ3_S));
}
// The first of the sets a launcher compiled (`compiled`, a bit a set) that
// holds every one of the n kinds, in the order of the enum (a launch of
// Q4_K and Q6_K alone takes the narrowest compiled set); -1 when none does:
// the launch is refused. The one search every weight launcher makes.
inline int launch_set(const int* kinds, int n, unsigned compiled) {
    for (int set = KS_Q4K_Q6K; set <= KS_IQ_LOW; ++set) {
        if (!(compiled >> set & 1u)) continue;
        bool holds = true;
        for (int t = 0; t < n; ++t) holds = holds && kind_in_set(kinds[t], set);
        if (holds) return set;
    }
    return -1;
}
// element type of activations, caches and outputs
enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int QK_K = 256;        // weights per superblock
constexpr int Q4K_BYTES = 144;   // d f16, dmin f16, scales[12], qs[128]
constexpr int Q6K_BYTES = 210;   // ql[128], qh[64], scales[16] i8, d f16
constexpr int Q80_BYTES = 272;   // eight 34-byte blocks of 32: d f16, qs[32] i8
constexpr int Q5K_BYTES = 176;   // d f16, dmin f16, scales[12], qh[32], qs[128]
// the legacy kinds: eight blocks of 32 weights a QK_K run
constexpr int Q40_BYTES = 144;   // 18-byte blocks: d f16, qs[16]
constexpr int Q41_BYTES = 160;   // 20-byte blocks: d f16, m f16, qs[16]
constexpr int Q50_BYTES = 176;   // 22-byte blocks: d f16, qh u32, qs[16]
constexpr int Q51_BYTES = 192;   // 24-byte blocks: d f16, m f16, qh u32, qs[16]
constexpr int Q2K_BYTES = 84;    // scales[16] (4-bit scale | 4-bit min), qs[64], d f16, dmin f16
constexpr int Q3K_BYTES = 110;   // hmask[32], qs[64], scales[12] (6-bit), d f16
constexpr int IQ4NL_BYTES = 144;  // eight 18-byte blocks of 32: d f16, qs[16]
constexpr int IQ4XS_BYTES = 136;  // d f16, scales_h u16, scales_l[4], qs[128]
constexpr int IQ3XXS_BYTES = 98;  // d f16, qs[64] grid indices, 8 u32 (4 sign indices, scale)
constexpr int IQ3S_BYTES = 110;   // d f16, qs[64], qh[8], signs[32], scales[4]
constexpr int IQ2S_BYTES = 82;    // d f16, qs[32], signs[32], qh[8], scales[8]
constexpr int IQ2XXS_BYTES = 66;  // d f16, 8 x (u32 grid indices, u32 sign indices | scale)
constexpr int IQ2XS_BYTES = 74;   // d f16, qs[32] u16 (9-bit index | 7-bit sign index), scales[8]
constexpr int IQ1S_BYTES = 50;    // d f16, qs[32], qh[8] u16
constexpr int IQ1M_BYTES = 56;    // qs[32], qh[16], scales[4] u16 (d in their top nibbles)
constexpr int TQ10_BYTES = 54;    // qs[48] (5 trits a byte), qh[4] (4 trits), d f16
constexpr int TQ20_BYTES = 66;    // qs[64] (4 crumbs a byte), d f16

// Wire bytes of QK_K weights of `kind`, or 0 for a kind the kernels do not take.
__host__ __device__ constexpr int kind_sb_bytes(int kind) {
    return kind == KIND_Q4_K ? Q4K_BYTES : kind == KIND_Q6_K ? Q6K_BYTES
         : kind == KIND_Q8_0 ? Q80_BYTES : kind == KIND_Q5_K ? Q5K_BYTES
         : kind == KIND_Q4_0 ? Q40_BYTES : kind == KIND_Q4_1 ? Q41_BYTES
         : kind == KIND_Q5_0 ? Q50_BYTES : kind == KIND_Q5_1 ? Q51_BYTES
         : kind == KIND_Q2_K ? Q2K_BYTES : kind == KIND_Q3_K ? Q3K_BYTES
         : kind == KIND_IQ4_NL ? IQ4NL_BYTES : kind == KIND_IQ4_XS ? IQ4XS_BYTES
         : kind == KIND_IQ3_XXS ? IQ3XXS_BYTES : kind == KIND_IQ3_S ? IQ3S_BYTES
         : kind == KIND_IQ2_S ? IQ2S_BYTES : kind == KIND_IQ2_XXS ? IQ2XXS_BYTES
         : kind == KIND_IQ2_XS ? IQ2XS_BYTES : kind == KIND_IQ1_S ? IQ1S_BYTES
         : kind == KIND_IQ1_M ? IQ1M_BYTES : kind == KIND_TQ1_0 ? TQ10_BYTES
         : kind == KIND_TQ2_0 ? TQ20_BYTES : 0;
}

// The legacy kinds (Q4_0, Q4_1, Q5_0, Q5_1: 32-weight blocks with an f16
// scale, optionally an f16 min and a u32 of fifth bits) and the low-bit
// K-quants (Q2_K, Q3_K: 16-weight sub-blocks).
__host__ __device__ constexpr bool kind_legacy(int kind) {
    return kind == KIND_Q4_0 || kind == KIND_Q4_1 || kind == KIND_Q5_0 || kind == KIND_Q5_1;
}
__host__ __device__ constexpr bool kind_low_k(int kind) {
    return kind == KIND_Q2_K || kind == KIND_Q3_K;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Eight consecutive f32 or bf16 elements, 16-byte aligned, -> f32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
    if constexpr (sizeof(T) == 4) {
        const float4 a = reinterpret_cast<const float4*>(p)[0];
        const float4 b = reinterpret_cast<const float4*>(p)[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
            v[2 * i] = __low2float(h);
            v[2 * i + 1] = __high2float(h);
        }
    }
}

__device__ __forceinline__ float f16_bits(uint16_t h) {
    return __half2float(__ushort_as_half(h));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Q4_K 6-bit (scale, min) of sub-block j (0..7) from the 12 packed scale
// bytes held as three little-endian words s0 (bytes 0-3), s1 (4-7), s2
// (8-11) — decode_np._k4_scale_min. Shifts instead of byte indexing keep a
// lane-dependent j in registers.
__device__ __forceinline__ void q4k_scale_min(uint32_t s0, uint32_t s1, uint32_t s2, int j,
                                              int& sc, int& mn) {
    const int i = 8 * (j & 3);
    const int b0 = (s0 >> i) & 0xFF, b1 = (s1 >> i) & 0xFF;
    if (j < 4) {
        sc = b0 & 63;
        mn = b1 & 63;
    } else {
        const int b2 = (s2 >> i) & 0xFF;
        sc = (b2 & 0xF) | ((b0 >> 6) << 4);
        mn = (b2 >> 4) | ((b1 >> 6) << 4);
    }
}

// ---------------------------------------------------------------------------
// Asynchronous copies and bf16 tensor-core fragments (flash_attn_tile.cuh,
// qgemm_tile.cuh).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
// 4, 8 or 16 bytes global -> shared, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int bytes, bool ok) {
    if (bytes == 16)
        cp_async16(dst, src, ok);
    else if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Integers as exact f32 with no int->float conversion. I2F issues at 16 a
// clock per SM on compute capability 9.0, against 128 f32 adds, so a kernel
// that converts every weight is bound by it. OR-ing v < 2^23 into the
// mantissa of 2^23 gives the float 2^23 + v exactly; one full-rate add takes
// 2^23 off again, still exactly (the scales and mins).
__device__ __forceinline__ float u23_f32(uint32_t v) {
    return __int_as_float(0x4B000000u | v) - 8388608.f;
}

// BIAS + q as an exact f32 from byte B of w, where that byte holds
// e | q << s (BIAS = 2^(7-s), q < BIAS; e the low bit of BIAS's exponent,
// 0x80 for 16 and 64, 0 for 32): the byte is the float's high mantissa
// byte under BIAS's exponent — one byte permute, no add. The matvec dots
// these with x and folds BIAS into the offset term; the GEMM's dequant
// takes it off in the multiply-add that scales the level.
template <int BIAS, int B>
__device__ __forceinline__ float level_plus(uint32_t w) {
    static_assert(BIAS == 16 || BIAS == 32 || BIAS == 64, "exponent bytes for 16, 32, 64 only");
    return __int_as_float(__byte_perm(w, BIAS == 16 ? 0x41000000u : 0x42000000u, 0x7044 + (B << 8)));
}

// The signed byte B of w as an exact f32, w already XOR-ed with 0x80808080
// (so the byte is 128 + q): 2^23 + 128 + q by one byte permute into the low
// mantissa byte of 2^23, then one add. An 8-bit level has no room under a
// fixed exponent in the high mantissa byte (7 bits), so Q8_0 takes the add.
template <int B>
__device__ __forceinline__ float s8_level(uint32_t w_x80) {
    return __int_as_float(__byte_perm(w_x80, 0x4B000000u, 0x7540 + B)) - 8388736.f;
}

// A signed byte (two's complement, 0..255 as stored) -> exact f32.
__device__ __forceinline__ float s8_f32(uint32_t byte) {
    return u23_f32(byte ^ 0x80u) - 128.f;
}

// ---------------------------------------------------------------------------
// The matvec over wire blocks (qmv.cu, qmv_id.cu). Each warp owns R output
// rows and walks their superblocks QMV_SB_STEP at a time: eight lanes share
// a superblock, each lane holding a QMV_SLICE-weight slice. The slice is
// never formed as weights. As the TPU kernel (llamacog_tpu/ops/pallas/
// qmm.py, _tile_matvec), the lane takes the dot of the raw levels q with x
// for each sub-block part it holds, applies the part's scale once to that
// sum, and folds the part's offset into one product with the activation sum
// of the part:
//   sum_k x_k (sc q_k - mn) = sc * sum_k q_k x_k - mn * sum_k x_k
// (Q4_K, Q5_K: sc = d*scale, mn = dmin*min; Q6_K: sc = d*scale, mn = 32*sc
// for the levels' -32; Q8_0: sc = d, no offset). The levels carry a bias
// (16 + q, 32 + q, 64 + q: level_plus), which mn takes in too; Q8_0's are
// the signed q (s8_level). The sums of x depend on x alone: a lane forms them
// once a step and every row of the warp shares them. All of it is f32.
constexpr int QMV_WARPS = 4;
constexpr int QMV_SB_STEP = 4;   // superblocks per warp step (8 lanes each)
constexpr int QMV_SLICE = 32;    // weights per lane per superblock

// Rows a warp owns: 4 Q4_K rows at one activation row, where a row's
// levels are decoded and used at once; else 2 (the raw fields of Q6_K, Q5_K
// and Q8_0 take 14, 12 and 10 registers a row against Q4_K's 8, held twice
// by the walk; the kernel's register count is that of its widest kind, so
// the new kinds must not raise Q4_K's; at up to 8 activation rows the levels
// stay decoded across them).
template <int NB, int KIND>
__host__ __device__ constexpr int qmv_rows_per_warp() { return NB == 1 && KIND == KIND_Q4_K ? 4 : 2; }

// The raw bytes of lane slot i (0..7) of one superblock. Q4_K: the 16-byte
// header (d, dmin, 12 scale bytes) and qs bytes 16i..16i+15, i.e. group
// j = i/2 (64 weights), p = 16*(i%2): slice index k < 16 is the low nibble
// of byte k (element j*64 + p + k, sub-block 2j), k >= 16 the high nibble
// of byte k-16 (element j*64 + 32 + p + k-16, sub-block 2j+1).
struct Q4KRaw {
    uint4 h, q;
};

__device__ __forceinline__ Q4KRaw q4k_raw(const uint8_t* blk, int i) {
    return {*reinterpret_cast<const uint4*>(blk), *reinterpret_cast<const uint4*>(blk + 16 + 16 * i)};
}

// Q6_K: chunk c = i/4, positions lq..lq+7 of the chunk's 32 (lq = 8*(i%4))
// for all four quarters; slice index qt*8 + t is element c*128 + qt*32 +
// lq + t (sub-scale c*8 + qt*2 + lq/16). The 210-byte blocks are only
// 2-byte aligned, so each 8-byte field (ql low, ql high, qh, the chunk's 8
// scales) is read as three aligned words and shifted into place when it is
// used: the words stay raw while they are in flight.
struct Q6KRaw {
    uint32_t w[4][3];
    uint32_t d;
    int shift;  // 0 or 16: the block's offset from a 4-byte boundary, in bits
};

__device__ __forceinline__ Q6KRaw q6k_raw(const uint8_t* blk, int i) {
    const int c = i >> 2, lq = (i & 3) * 8;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(blk) & 2);
    const uint32_t* base = reinterpret_cast<const uint32_t*>(blk - mis);
    const int off[4] = {c * 64 + lq, c * 64 + 32 + lq, 128 + c * 32 + lq, 192 + c * 8};
    Q6KRaw r;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
        for (int e = 0; e < 2; ++e) r.w[f][e] = base[off[f] / 4 + e];
        // the third word only when the field straddles it (mis = 2): an
        // aligned block reads its second word again, and so never reads
        // past the block's last byte
        r.w[f][2] = base[off[f] / 4 + 1 + (mis >> 1)];
    }
    r.d = *reinterpret_cast<const unsigned short*>(blk + 208);
    r.shift = mis * 8;
    return r;
}

// Q8_0: the eight 34-byte blocks of 32 weights make one 272-byte
// superblock; slot i is block i (elements 32i..32i+31, one scale). The
// blocks are 2-byte aligned (every other one 4-byte aligned), so the lane
// reads the nine aligned words from 34i rounded down to 4: the block and
// two bytes of a neighbour, never past the superblock's last byte.
struct Q80Raw {
    uint32_t w[9];
    int shift;  // 16 when the block starts on a 4-byte boundary (qs two bytes in), else 32
};

__device__ __forceinline__ Q80Raw q80_raw(const uint8_t* sb, int i) {
    const int off = 34 * i, mis = off & 2;
    const uint32_t* base = reinterpret_cast<const uint32_t*>(sb + off - mis);
    Q80Raw r;
#pragma unroll
    for (int k = 0; k < 9; ++k) r.w[k] = base[k];
    r.shift = 16 + 8 * mis;
    return r;
}

// A Q8_0 block's d (f16 bits) and its 32 int8 as eight words, shifted into place.
__device__ __forceinline__ uint32_t q80_d(const Q80Raw& r) {
    return (r.w[0] >> (r.shift - 16)) & 0xFFFF;
}
__device__ __forceinline__ uint32_t q80_qs(const Q80Raw& r, int k) {
    return __funnelshift_rc(r.w[k], r.w[k + 1], r.shift);
}

// Q5_K: Q4_K's header and slots, plus the 16 qh bytes of the slot's 16
// positions (qh[p..p+15], p = 16*(i%2)): element j*64 + l takes bit 2j of
// qh[l % 32] as its fifth bit (bit 2j + 1 for the high nibbles).
struct Q5KRaw {
    uint4 h, qh, q;
};

__device__ __forceinline__ Q5KRaw q5k_raw(const uint8_t* blk, int i) {
    return {*reinterpret_cast<const uint4*>(blk), *reinterpret_cast<const uint4*>(blk + 16 + 16 * (i & 1)),
            *reinterpret_cast<const uint4*>(blk + 48 + 16 * i)};
}

// The fifth bits of one Q5_K qs word's nibbles: the low nibbles' levels
// as bytes q << 2 (level_plus<32>: 32 + q), and the high nibbles'. qh holds
// the four positions' qh bytes; j is the slot's 64-weight group.
__device__ __forceinline__ void q5k_bytes(uint32_t w, uint32_t qh, int j, uint32_t& lo,
                                          uint32_t& hi) {
    lo = ((w << 2) & 0x3C3C3C3Cu) | (((qh >> (2 * j)) & 0x01010101u) << 6);
    hi = ((w >> 2) & 0x3C3C3C3Cu) | (((qh >> (2 * j + 1)) & 0x01010101u) << 6);
}

// The legacy kinds: slot i is block i of the QK_K run (elements 32i..32i+31,
// one scale), as Q8_0's. Element j < 16 is the low nibble of qs byte j, 16 + j
// its high nibble; Q5_0 and Q5_1 take bit j of qh as the fifth bit of
// element j. Q4_1 blocks (20 bytes) are 4-byte aligned and Q5_1 blocks (24)
// 8-byte aligned; Q4_0 (18) and Q5_0 (22) blocks only 2-byte aligned, so the
// lane reads the aligned words from its block's start rounded down to 4 (up
// to two bytes of a neighbour, never past the run's last byte) and shifts.
__host__ __device__ constexpr int legacy_block_bytes(int kind) {
    return kind == KIND_Q4_0 ? 18 : kind == KIND_Q4_1 ? 20 : kind == KIND_Q5_0 ? 22 : 24;
}
__host__ __device__ constexpr bool legacy_has_min(int kind) {
    return kind == KIND_Q4_1 || kind == KIND_Q5_1;
}
__host__ __device__ constexpr bool legacy_5bit(int kind) {
    return kind == KIND_Q5_0 || kind == KIND_Q5_1;
}

template <int KIND>
struct LegacyRaw {
    uint32_t w[KIND == KIND_Q4_0 || KIND == KIND_Q4_1 ? 5 : 6];
    int shift;  // Q4_0, Q5_0: 16 when the block starts on a 4-byte boundary, else 32
};

template <int KIND>
__device__ __forceinline__ LegacyRaw<KIND> legacy_raw(const uint8_t* sb, int i) {
    const int off = legacy_block_bytes(KIND) * i, mis = off & 2;
    const uint32_t* base = reinterpret_cast<const uint32_t*>(sb + off - mis);
    LegacyRaw<KIND> r;
#pragma unroll
    for (int k = 0; k < (int)(sizeof(r.w) / 4); ++k) r.w[k] = base[k];
    r.shift = 16 + 8 * mis;
    return r;
}

// A legacy block's fields shifted into place: d (and m above it) in dm, the
// fifth bits in qh, the 16 code bytes in qs[4].
struct LegacyFields {
    uint32_t dm, qh, qs[4];
};

template <int KIND>
__device__ __forceinline__ LegacyFields legacy_fields(const LegacyRaw<KIND>& r) {
    LegacyFields f;
    f.qh = 0;
    if constexpr (KIND == KIND_Q4_1 || KIND == KIND_Q5_1) {  // aligned blocks
        constexpr int q0 = KIND == KIND_Q4_1 ? 1 : 2;
        f.dm = r.w[0];
        if constexpr (KIND == KIND_Q5_1) f.qh = r.w[1];
#pragma unroll
        for (int k = 0; k < 4; ++k) f.qs[k] = r.w[q0 + k];
    } else {
        constexpr int q0 = KIND == KIND_Q4_0 ? 0 : 1;  // the word before qs's first
        f.dm = (r.w[0] >> (r.shift - 16)) & 0xFFFF;
        if constexpr (KIND == KIND_Q5_0) f.qh = __funnelshift_rc(r.w[0], r.w[1], r.shift);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            f.qs[k] = __funnelshift_rc(r.w[q0 + k], r.w[q0 + k + 1], r.shift);
    }
    return f;
}

// Four bits t (bits 0..3) spread to the low bit of each byte.
__device__ __forceinline__ uint32_t spread4(uint32_t t) { return (t * 0x00204081u) & 0x01010101u; }

// The level bytes of qs word k of a legacy block: lo for elements 4k..4k+3
// (low nibbles), hi for 16 + 4k.. (high nibbles). 4-bit kinds: 0x80 | q << 3,
// the high mantissa byte of 16 + q (level_plus<16>); 5-bit kinds: q << 2, of
// 32 + q (level_plus<32>).
template <int KIND>
__device__ __forceinline__ void legacy_bytes(const LegacyFields& f, int k, uint32_t& lo,
                                             uint32_t& hi) {
    if constexpr (legacy_5bit(KIND)) {
        lo = ((f.qs[k] << 2) & 0x3C3C3C3Cu) | (spread4((f.qh >> (4 * k)) & 0xF) << 6);
        hi = ((f.qs[k] >> 2) & 0x3C3C3C3Cu) | (spread4((f.qh >> (16 + 4 * k)) & 0xF) << 6);
    } else {
        lo = ((f.qs[k] << 3) & 0x78787878u) | 0x80808080u;
        hi = ((f.qs[k] >> 1) & 0x78787878u) | 0x80808080u;
    }
}

// The bias of a legacy kind's levels (16 + q or 32 + q) and its own offset
// on the code (Q4_0 q - 8, Q5_0 q - 16; Q4_1, Q5_1 add m instead).
template <int KIND>
__host__ __device__ constexpr float legacy_bias() { return legacy_5bit(KIND) ? 32.f : 16.f; }
template <int KIND>
__host__ __device__ constexpr float legacy_offset() {
    return KIND == KIND_Q4_0 ? 8.f : KIND == KIND_Q5_0 ? 16.f : 0.f;
}

// Q2_K and Q3_K take Q6_K's slots: chunk c = i/4, positions lq..lq+7 of the
// chunk's 32 (lq = 8*(i%4)) for all four 2-bit planes (quarters); slice
// index qt*8 + t is element c*128 + qt*32 + lq + t, of sub-block c*8 + qt*2
// + lq/16. Q2_K: the code is bits 2qt, 2qt + 1 of qs byte c*32 + lq + t;
// sub-block g's scale byte holds the 4-bit scale (low) and min (high).
// Superblocks are 84 bytes, so 4-byte aligned: every field is read as words.
struct Q2KRaw {
    uint32_t q[2], s[2], dd;  // qs bytes, the chunk's 8 scale bytes, d and dmin
};

__device__ __forceinline__ Q2KRaw q2k_raw(const uint8_t* blk, int i) {
    const int c = i >> 2, lq = (i & 3) * 8;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(blk);
    return {{w[(16 + 32 * c + lq) / 4], w[(16 + 32 * c + lq) / 4 + 1]},
            {w[2 * c], w[2 * c + 1]}, w[20]};
}

// Q3_K: as Q2_K, and the third bit of element c*128 + qt*32 + l is bit
// 4c + qt of hmask[l] (set: the 2-bit code as it is; clear: the code - 4).
// The 6-bit scale of sub-block g is the low (g < 8) or high nibble of byte
// g % 8 of scales, with bits 2(g/4), +1 of byte 8 + g%4 on top, minus 32.
// The 110-byte superblocks are only 2-byte aligned: as Q6_K's, each 8-byte
// field (hmask, qs, scale bytes 0-7) is read as three aligned words, the
// 4-byte scale bytes 8-11 as two, and shifted into place when used.
struct Q3KRaw {
    uint32_t w[3][3];  // hmask, qs, scale bytes 0-7: 8 bytes each
    uint32_t s2[2];    // scale bytes 8-11
    uint32_t d;
    int shift;  // 0 or 16: the block's offset from a 4-byte boundary, in bits
};

__device__ __forceinline__ Q3KRaw q3k_raw(const uint8_t* blk, int i) {
    const int c = i >> 2, lq = (i & 3) * 8;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(blk) & 2);
    const uint32_t* base = reinterpret_cast<const uint32_t*>(blk - mis);
    const int off[3] = {lq, 32 + 32 * c + lq, 96};
    Q3KRaw r;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
        r.w[f][0] = base[off[f] / 4];
        r.w[f][1] = base[off[f] / 4 + 1];
        r.w[f][2] = base[off[f] / 4 + 1 + (mis >> 1)];  // a word again unless straddling
    }
    r.s2[0] = base[26];
    r.s2[1] = base[26 + (mis >> 1)];
    r.d = *reinterpret_cast<const unsigned short*>(blk + 108);
    r.shift = mis * 8;
    return r;
}

// The 8 code bytes of a Q2_K / Q3_K slot as two words (positions lq..lq+3,
// lq+4..lq+7), and for Q3_K the hmask bytes of the same positions.
template <int KIND, typename RAW>
__device__ __forceinline__ void low_k_fields(const RAW& r, uint32_t (&q)[2], uint32_t (&h)[2]) {
    if constexpr (KIND == KIND_Q2_K) {
        q[0] = r.q[0]; q[1] = r.q[1];
        h[0] = h[1] = 0;
    } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            h[e] = __funnelshift_r(r.w[0][e], r.w[0][e + 1], r.shift);
            q[e] = __funnelshift_r(r.w[1][e], r.w[1][e + 1], r.shift);
        }
    }
}

// Level bytes of quarter qt, four positions (code word q, hmask word h, c
// the chunk): 0x80 | v << 3, the high mantissa byte of 16 + v, where v is
// the 2-bit code, or for Q3_K the code with the hmask bit as bit 2 (the
// level's - 4 then folds into the offset).
template <int KIND>
__device__ __forceinline__ uint32_t low_k_bytes(uint32_t q, uint32_t h, int c, int qt) {
    uint32_t v = (q >> (2 * qt)) & 0x03030303u;
    if constexpr (KIND == KIND_Q3_K) v |= ((h >> (4 * c + qt)) & 0x01010101u) << 2;
    return (v << 3) | 0x80808080u;
}

// The scale dl (and for Q2_K the min ml) of each quarter's sub-block of slot
// i, each product rounded once as the plain dequant rounds it: Q2_K d * sc
// and dmin * m, Q3_K d * (sc - 32).
template <int KIND, typename RAW>
__device__ __forceinline__ void low_k_scales(const RAW& r, int i, float (&dl)[4], float (&ml)[4]) {
    const int c = i >> 2, h = (i & 3) >> 1;
    if constexpr (KIND == KIND_Q2_K) {
        const float d = f16_bits(r.dd & 0xFFFF), dmin = f16_bits(r.dd >> 16);
        const uint32_t s01 = r.s[0] >> (8 * h), s23 = r.s[1] >> (8 * h);
        const uint32_t b[4] = {s01 & 0xFF, (s01 >> 16) & 0xFF, s23 & 0xFF, (s23 >> 16) & 0xFF};
#pragma unroll
        for (int qt = 0; qt < 4; ++qt) {
            dl[qt] = __fmul_rn(d, u23_f32(b[qt] & 0xF));
            ml[qt] = __fmul_rn(dmin, u23_f32(b[qt] >> 4));
        }
    } else {
        const float d = f16_bits(r.d);
        const uint32_t l0 = __funnelshift_r(r.w[2][0], r.w[2][1], r.shift) >> (8 * h);
        const uint32_t l1 = __funnelshift_r(r.w[2][1], r.w[2][2], r.shift) >> (8 * h);
        const uint32_t hb = __funnelshift_r(r.s2[0], r.s2[1], r.shift) >> (8 * h);
        const uint32_t lo[4] = {l0, l0 >> 16, l1, l1 >> 16};
#pragma unroll
        for (int qt = 0; qt < 4; ++qt) {
            const uint32_t sc = ((lo[qt] >> (4 * c)) & 0xF) |
                                (((hb >> (16 * (qt & 1) + 4 * c + 2 * (qt >> 1))) & 3) << 4);
            dl[qt] = __fmul_rn(d, u23_f32(sc) - 32.f);
            ml[qt] = 0.f;
        }
    }
}

// The codebook kinds. Every level is a small signed integer (an entry of
// kvalues_iq4nl, or a grid byte times a sign), exact in f32 and in int8,
// under a scale with no offset: a lane's slot i is sub-block i (elements
// 32i..32i+31), as Q8_0's, and its levels go through s8_level as bytes
// 128 + level. The tables come from iq_tables.cuh, which ops/cuda/build.py
// writes from quant/iq_tables.py: the 16 IQ4 levels in four words held in
// registers and picked by byte permutes; the grids in global memory, read
// through L1 (__ldg). The sign byte of IQ3_XXS's 7-bit sign index
// (ksigns_iq2xs) is the index with its parity as bit 7, so it is computed.
//
// IQ4_NL blocks are Q4_0's (18 bytes: d, 16 nibble bytes), read as Q4_0's.
// IQ4_XS superblocks (136 bytes) are 8-byte aligned: the 8-byte header (d,
// scales_h, scales_l) and the slot's 16 qs bytes at 8 + 16i. IQ3_XXS (98),
// IQ3_S (110) and IQ2_S (82) superblocks are only 2-byte aligned: an 8-byte
// field (IQ3 grid indices, 2 + 8i) is read as Q6_K's, three aligned words
// shifted into place when used (no field of 8 ends a superblock); a 4-byte
// field as two halfwords, a byte field as the halfword that holds it, so
// nothing past a superblock's last byte is read.
//
// The 1-2 bit kinds and the ternary ones take the same slots and bytes.
// IQ1_S's and IQ1_M's levels grid + delta (grid -1, 0, 1; delta +-1/8) are
// not integers, but 8 (grid + delta) is: one of -9, -7, -1, 1, 7, 9, a byte
// 128 + 8 (grid + delta) that s8_level makes exact, under the scale / 8 (an
// exact f32 too), so each product rounds as the plain dequant's. The
// ternary kinds' levels are q - 1, the bytes 127 + q. IQ2_XXS (66 bytes),
// IQ2_XS (74), IQ1_S (50) superblocks are 2-byte aligned and read by
// halfwords; IQ1_M (56) superblocks are 8-byte aligned. TQ1_0 (54) and
// TQ2_0 (66) slots read 32 code bytes (TQ1_0's last three slots 20), all of
// one base-3 digit or 2-bit plane, as Q8_0's blocks: aligned words from
// the field's start rounded down to 4, never past the superblock's end.
#include "iq_tables.cuh"

struct IQ4XSRaw {
    uint2 h, q0, q1;  // d | scales_h << 16, scales_l; qs bytes 16i..16i+7, +8..+15
};

struct IQ3XXSRaw {
    uint32_t q[3];       // grid index bytes 8i..8i+7, as aligned words
    uint32_t s_lo, s_hi; // the slot's u32 of sign indices and scale, by halves
    uint32_t d;
    int shift;           // 16 when the superblock starts on a 4-byte boundary, else 0
};

struct IQ3SRaw {
    uint32_t q[3];    // grid index bytes 8i..8i+7, as aligned words
    uint32_t d, qh;   // qh: the halfword holding qh[i]
    uint32_t s_lo, s_hi;  // sign bytes 4i..4i+3, by halves
    uint32_t sc;      // the halfword holding the slot's scale nibble
    int shift;
};

struct IQ2SRaw {
    uint32_t d, q_lo, q_hi, s_lo, s_hi;  // grid index and sign bytes 4i..4i+3, by halves
    uint32_t qh, sc;                     // the halfwords holding qh[i], scales[i]
};

__device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
    return *reinterpret_cast<const unsigned short*>(p);
}

// The aligned words covering the 8 bytes at even address p: the third
// only when they straddle a word boundary, else the second again.
__device__ __forceinline__ void ld_words8(const uint8_t* p, uint32_t (&w)[3]) {
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 2);
    const uint32_t* a = reinterpret_cast<const uint32_t*>(p - mis);
    w[0] = a[0];
    w[1] = a[1];
    w[2] = a[1 + (mis >> 1)];
}

__device__ __forceinline__ IQ4XSRaw iq4xs_raw(const uint8_t* blk, int i) {
    const uint2* b = reinterpret_cast<const uint2*>(blk);
    return {b[0], b[1 + 2 * i], b[2 + 2 * i]};
}

__device__ __forceinline__ IQ3XXSRaw iq3xxs_raw(const uint8_t* blk, int i) {
    IQ3XXSRaw r;
    ld_words8(blk + 2 + 8 * i, r.q);
    r.s_lo = ld_u16(blk + 66 + 4 * i);
    r.s_hi = ld_u16(blk + 68 + 4 * i);
    r.d = ld_u16(blk);
    r.shift = 16 - 8 * static_cast<int>(reinterpret_cast<uintptr_t>(blk) & 2);
    return r;
}

__device__ __forceinline__ IQ3SRaw iq3s_raw(const uint8_t* blk, int i) {
    IQ3SRaw r;
    ld_words8(blk + 2 + 8 * i, r.q);
    r.d = ld_u16(blk);
    r.qh = ld_u16(blk + 66 + (i & ~1));
    r.s_lo = ld_u16(blk + 74 + 4 * i);
    r.s_hi = ld_u16(blk + 76 + 4 * i);
    r.sc = ld_u16(blk + 106 + 2 * (i >> 2));
    r.shift = 16 - 8 * static_cast<int>(reinterpret_cast<uintptr_t>(blk) & 2);
    return r;
}

__device__ __forceinline__ IQ2SRaw iq2s_raw(const uint8_t* blk, int i) {
    return {ld_u16(blk), ld_u16(blk + 2 + 4 * i), ld_u16(blk + 4 + 4 * i),
            ld_u16(blk + 34 + 4 * i), ld_u16(blk + 36 + 4 * i), ld_u16(blk + 66 + (i & ~1)),
            ld_u16(blk + 74 + (i & ~1))};
}

struct IQ2XXSRaw {
    uint32_t d, h[4];  // the slot's two u32 (grid index bytes; sign indices | scale) by halves
};

struct IQ2XSRaw {
    uint32_t d, h[4];  // the slot's four u16 (9-bit grid index | 7-bit sign index)
    uint32_t sc;       // the halfword holding scales[i]
};

struct IQ1SRaw {
    uint32_t d, q_lo, q_hi, qh;  // grid index bytes 4i..4i+3 by halves, qh[i]
};

struct IQ1MRaw {
    uint32_t q, qh;  // grid index bytes 4i..4i+3; qh[2i], qh[2i + 1]
    uint2 sc;        // the four u16 scale words
};

struct TQRaw {
    uint32_t w[9];  // aligned words covering the slot's code bytes
    uint32_t d;
    int shift;      // 16 when the code bytes start two bytes into w[0], else 0
};

__device__ __forceinline__ IQ2XXSRaw iq2xxs_raw(const uint8_t* blk, int i) {
    const uint8_t* p = blk + 2 + 8 * i;
    return {ld_u16(blk), {ld_u16(p), ld_u16(p + 2), ld_u16(p + 4), ld_u16(p + 6)}};
}

__device__ __forceinline__ IQ2XSRaw iq2xs_raw(const uint8_t* blk, int i) {
    const uint8_t* p = blk + 2 + 8 * i;
    return {ld_u16(blk), {ld_u16(p), ld_u16(p + 2), ld_u16(p + 4), ld_u16(p + 6)},
            ld_u16(blk + 66 + (i & ~1))};
}

__device__ __forceinline__ IQ1SRaw iq1s_raw(const uint8_t* blk, int i) {
    return {ld_u16(blk), ld_u16(blk + 2 + 4 * i), ld_u16(blk + 4 + 4 * i), ld_u16(blk + 34 + 2 * i)};
}

__device__ __forceinline__ IQ1MRaw iq1m_raw(const uint8_t* blk, int i) {
    return {*reinterpret_cast<const uint32_t*>(blk + 4 * i), ld_u16(blk + 32 + 2 * i),
            *reinterpret_cast<const uint2*>(blk + 48)};
}

// TQ1_0 slots 0-4 take qs[0:32] (base-3 digit i), slots 5-7 qs[32:48] and
// qh; TQ2_0 slot i qs[32 (i / 4)..+31] (2-bit plane i % 4). Words past the
// field's last repeat it.
template <int KIND>
__device__ __forceinline__ TQRaw tq_raw(const uint8_t* blk, int i) {
    const int off = KIND == KIND_TQ1_0 ? (i < 5 ? 0 : 32) : 32 * (i >> 2);
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(blk) & 2);
    const uint32_t* a = reinterpret_cast<const uint32_t*>(blk + off - mis);
    const int last = (KIND == KIND_TQ1_0 && i >= 5 ? 4 : 7) + (mis >> 1);
    TQRaw r;
#pragma unroll
    for (int k = 0; k < 9; ++k) r.w[k] = a[min(k, last)];
    r.d = ld_u16(blk + (KIND == KIND_TQ1_0 ? 52 : 64));
    r.shift = 8 * mis;
    return r;
}

// kvalues_iq4nl[q] + 128 for the four nibbles q of sel's low 16 bits
// (nibble n -> byte n): two byte permutes pick entry q & 7 of the low and
// of the high eight, a third takes the high one where bit 3 of q is set.
__device__ __forceinline__ uint32_t iq4_x80(uint32_t sel) {
    const uint32_t s = sel & 0x7777u;
    const uint32_t lo = __byte_perm(IQ4NL_X80_0, IQ4NL_X80_1, s);
    const uint32_t hi = __byte_perm(IQ4NL_X80_2, IQ4NL_X80_3, s);
    return __byte_perm(lo, hi, 0x3210u | ((sel & 0x8888u) >> 1));
}

// The levels + 128 of IQ4 qs word w: lo for its low nibbles (elements
// 4k..4k+3 of the 32 of word k), hi for its high nibbles (16 + 4k..).
__device__ __forceinline__ void iq4_bytes(uint32_t w, uint32_t& lo, uint32_t& hi) {
    const uint32_t a = iq4_x80(w & 0xFFFFu);  // bytes 0 lo, 0 hi, 1 lo, 1 hi
    const uint32_t b = iq4_x80(w >> 16);      // bytes 2 lo, 2 hi, 3 lo, 3 hi
    lo = __byte_perm(a, b, 0x6420u);
    hi = __byte_perm(a, b, 0x7531u);
}

// Four grid bytes (each below 128, never 0) with sign bits s (bit j: byte j
// negated) as the bytes 128 + level: 128 + g is g ^ 0x80, and 128 - g is
// (g ^ 0x7F) + 1; no byte carries into the next.
__device__ __forceinline__ uint32_t iq_signed_x80(uint32_t grid4, uint32_t s) {
    const uint32_t sp = spread4(s & 0xFu);
    return (grid4 ^ 0x80808080u ^ (sp * 0xFFu)) + sp;
}

// ksigns_iq2xs[s7]: the 7-bit sign index with its parity as bit 7
__device__ __forceinline__ uint32_t iq_ksigns(uint32_t s7) {
    return s7 | ((__popc(s7) & 1u) << 7);
}

// Four IQ1 levels 1 + grid (nibbles at bits 0, 8, 16, 24 of g, the rest
// clear) as the bytes 128 + 8 (grid + delta): 8 (1 + grid) + 120 + 8 delta.
__device__ __forceinline__ uint32_t iq1_x80(uint32_t g, bool neg) {
    return (g << 3) + (neg ? 0x77777777u : 0x79797979u);
}

// TQ1_0: base-3 digit j (0..4) of each byte of w, ((v * 3^j) mod 256) * 3
// >> 8 (llama.cpp's dequantize_row_tq1_0), as the bytes 127 + digit: bytes
// 0, 2 and 1, 3 in two 16-bit lanes each, where no product overflows its lane.
__device__ __forceinline__ uint32_t tq1_x80(uint32_t w, int j) {
    const uint32_t p = static_cast<uint32_t>(0x511B090301ull >> (8 * j)) & 0xFFu;
    const uint32_t e = ((w & 0x00FF00FFu) * p) & 0x00FF00FFu;
    const uint32_t o = (((w >> 8) & 0x00FF00FFu) * p) & 0x00FF00FFu;
    return ((((e * 3) >> 8) & 0x00030003u) | ((((o * 3) >> 8) & 0x00030003u) << 8)) + 0x7F7F7F7Fu;
}

// The 32 levels + 128 of a codebook or ternary kind's slot i (word k:
// elements 4k..4k+3) and its scales (IQ2_S, IQ2_XS, IQ1_M: elements 0-15,
// 16-31; else sc[0] = sc[1]), each scale formed as the plain dequant forms
// it (IQ1_S, IQ1_M: then / 8, exactly).
template <int KIND, typename RAW>
__device__ __forceinline__ void iq_slot(const RAW& r, int i, uint32_t (&x80)[8], float (&sc)[2]) {
    if constexpr (KIND == KIND_IQ4_NL) {
        const LegacyFields f = legacy_fields<KIND_Q4_0>(r);
        sc[0] = sc[1] = f16_bits(f.dm & 0xFFFF);
#pragma unroll
        for (int k = 0; k < 4; ++k) iq4_bytes(f.qs[k], x80[k], x80[4 + k]);
    } else if constexpr (KIND == KIND_IQ4_XS) {
        const uint32_t ls = ((r.h.y >> (4 * i)) & 0xF) | (((r.h.x >> (16 + 2 * i)) & 3) << 4);
        sc[0] = sc[1] = __fmul_rn(f16_bits(r.h.x & 0xFFFF), u23_f32(ls) - 32.f);
        const uint32_t w[4] = {r.q0.x, r.q0.y, r.q1.x, r.q1.y};
#pragma unroll
        for (int k = 0; k < 4; ++k) iq4_bytes(w[k], x80[k], x80[4 + k]);
    } else if constexpr (KIND == KIND_IQ3_XXS) {
        const uint32_t q[2] = {__funnelshift_r(r.q[0], r.q[1], r.shift),
                               __funnelshift_r(r.q[1], r.q[2], r.shift)};
        const uint32_t sas = r.s_lo | (r.s_hi << 16);
        sc[0] = sc[1] = __fmul_rn(__fmul_rn(f16_bits(r.d), 0.5f + u23_f32(sas >> 28)), 0.5f);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            const uint32_t s = iq_ksigns((sas >> (7 * l)) & 127);
            const uint32_t pair = q[l >> 1] >> (16 * (l & 1));
            x80[2 * l] = iq_signed_x80(__ldg(&IQ3XXS_GRID[pair & 0xFF]), s);
            x80[2 * l + 1] = iq_signed_x80(__ldg(&IQ3XXS_GRID[(pair >> 8) & 0xFF]), s >> 4);
        }
    } else if constexpr (KIND == KIND_IQ3_S) {
        const uint32_t q[2] = {__funnelshift_r(r.q[0], r.q[1], r.shift),
                               __funnelshift_r(r.q[1], r.q[2], r.shift)};
        const uint32_t qh = r.qh >> (8 * (i & 1)), signs = r.s_lo | (r.s_hi << 16);
        sc[0] = sc[1] = __fmul_rn(f16_bits(r.d), u23_f32(1 + 2 * ((r.sc >> (4 * (i & 3))) & 0xF)));
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const uint32_t idx = ((q[m >> 2] >> (8 * (m & 3))) & 0xFF) | (((qh >> m) & 1) << 8);
            x80[m] = iq_signed_x80(__ldg(&IQ3S_GRID[idx]), signs >> (4 * m));
        }
    } else if constexpr (KIND == KIND_IQ2_XXS) {
        const uint32_t a0 = r.h[0] | (r.h[1] << 16), a1 = r.h[2] | (r.h[3] << 16);
        sc[0] = sc[1] = __fmul_rn(__fmul_rn(f16_bits(r.d), 0.5f + u23_f32(a1 >> 28)), 0.25f);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            const uint2 g = __ldg(reinterpret_cast<const uint2*>(IQ2XXS_GRID) + ((a0 >> (8 * l)) & 0xFF));
            const uint32_t s = iq_ksigns((a1 >> (7 * l)) & 127);
            x80[2 * l] = iq_signed_x80(g.x, s);
            x80[2 * l + 1] = iq_signed_x80(g.y, s >> 4);
        }
    } else if constexpr (KIND == KIND_IQ2_XS) {
        const uint32_t scb = r.sc >> (8 * (i & 1));
        const float d = f16_bits(r.d);
        sc[0] = __fmul_rn(__fmul_rn(d, 0.5f + u23_f32(scb & 0xF)), 0.25f);
        sc[1] = __fmul_rn(__fmul_rn(d, 0.5f + u23_f32((scb >> 4) & 0xF)), 0.25f);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            const uint2 g = __ldg(reinterpret_cast<const uint2*>(IQ2XS_GRID) + (r.h[l] & 511));
            const uint32_t s = iq_ksigns(r.h[l] >> 9);
            x80[2 * l] = iq_signed_x80(g.x, s);
            x80[2 * l + 1] = iq_signed_x80(g.y, s >> 4);
        }
    } else if constexpr (KIND == KIND_IQ1_S) {
        const uint32_t qs = r.q_lo | (r.q_hi << 16);
        const bool neg = r.qh & 0x8000u;
        sc[0] = sc[1] = __fmul_rn(__fmul_rn(f16_bits(r.d), u23_f32(2 * ((r.qh >> 12) & 7) + 1)),
                                  0.125f);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            const uint32_t g = __ldg(&IQ1S_GRID[((qs >> (8 * l)) & 0xFF) | (((r.qh >> (3 * l)) & 7) << 8)]);
            x80[2 * l] = iq1_x80(g & 0x0F0F0F0Fu, neg);
            x80[2 * l + 1] = iq1_x80((g >> 4) & 0x0F0F0F0Fu, neg);
        }
    } else if constexpr (KIND == KIND_IQ1_M) {
        // the f16 d from the top nibbles of the four scale words; sub-block
        // i's two 3-bit scales at bits 6 (i % 2) (+ 3) of scale word i / 2
        const uint32_t d16 = ((r.sc.x >> 12) & 0xF) | ((r.sc.x >> 24) & 0xF0) |
                             ((r.sc.y >> 4) & 0xF00) | ((r.sc.y >> 16) & 0xF000);
        const float d = f16_bits(d16);
        const uint32_t s = ((i & 4) ? r.sc.y : r.sc.x) >> (16 * ((i >> 1) & 1) + 6 * (i & 1));
        sc[0] = __fmul_rn(__fmul_rn(d, u23_f32(2 * (s & 7) + 1)), 0.125f);
        sc[1] = __fmul_rn(__fmul_rn(d, u23_f32(2 * ((s >> 3) & 7) + 1)), 0.125f);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            // group l: the low (l even) or high nibble of qh[2i + l / 2],
            // three index bits and the delta's sign
            const uint32_t h = (r.qh >> (8 * (l >> 1) + 4 * (l & 1))) & 0xF;
            const uint32_t g = __ldg(&IQ1S_GRID[((r.q >> (8 * l)) & 0xFF) | ((h & 7) << 8)]);
            x80[2 * l] = iq1_x80(g & 0x0F0F0F0Fu, h & 8);
            x80[2 * l + 1] = iq1_x80((g >> 4) & 0x0F0F0F0Fu, h & 8);
        }
    } else if constexpr (KIND == KIND_TQ1_0 || KIND == KIND_TQ2_0) {
        sc[0] = sc[1] = f16_bits(r.d);
        uint32_t q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = __funnelshift_r(r.w[k], r.w[k + 1], r.shift);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if constexpr (KIND == KIND_TQ2_0) {
                x80[k] = ((q[k] >> (2 * (i & 3))) & 0x03030303u) + 0x7F7F7F7Fu;
            } else {
                // slots 0-4: digit i of qs[0:32]; 5, 6: digits 2 (i - 5), + 1
                // of qs[32:48]; 7: digit 4 of qs[32:48], then digits 0-3 of qh
                const uint32_t w = i < 5 ? q[k] : i == 7 && k >= 4 ? q[4] : q[k & 3];
                const int j = i < 5 ? i : i < 7 ? 2 * (i - 5) + (k >> 2) : k < 4 ? 4 : k - 4;
                x80[k] = tq1_x80(w, j);
            }
        }
    } else {
        static_assert(KIND == KIND_IQ2_S, "a codebook kind");
        const uint32_t qs = r.q_lo | (r.q_hi << 16), signs = r.s_lo | (r.s_hi << 16);
        const uint32_t qh = r.qh >> (8 * (i & 1)), scb = r.sc >> (8 * (i & 1));
        const float d = f16_bits(r.d);
        sc[0] = __fmul_rn(__fmul_rn(d, 0.5f + u23_f32(scb & 0xF)), 0.25f);
        sc[1] = __fmul_rn(__fmul_rn(d, 0.5f + u23_f32((scb >> 4) & 0xF)), 0.25f);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            const uint32_t idx = ((qs >> (8 * l)) & 0xFF) | (((qh >> (2 * l)) & 3) << 8);
            const uint2 g = __ldg(reinterpret_cast<const uint2*>(IQ2S_GRID) + idx);
            const uint32_t s = signs >> (8 * l);
            x80[2 * l] = iq_signed_x80(g.x, s);
            x80[2 * l + 1] = iq_signed_x80(g.y, s >> 4);
        }
    }
}

template <int KIND> struct KindRaw;
template <> struct KindRaw<KIND_Q4_K> { using type = Q4KRaw; };
template <> struct KindRaw<KIND_Q6_K> { using type = Q6KRaw; };
template <> struct KindRaw<KIND_Q8_0> { using type = Q80Raw; };
template <> struct KindRaw<KIND_Q5_K> { using type = Q5KRaw; };
template <> struct KindRaw<KIND_Q4_0> { using type = LegacyRaw<KIND_Q4_0>; };
template <> struct KindRaw<KIND_Q4_1> { using type = LegacyRaw<KIND_Q4_1>; };
template <> struct KindRaw<KIND_Q5_0> { using type = LegacyRaw<KIND_Q5_0>; };
template <> struct KindRaw<KIND_Q5_1> { using type = LegacyRaw<KIND_Q5_1>; };
template <> struct KindRaw<KIND_Q2_K> { using type = Q2KRaw; };
template <> struct KindRaw<KIND_Q3_K> { using type = Q3KRaw; };
template <> struct KindRaw<KIND_IQ4_NL> { using type = LegacyRaw<KIND_Q4_0>; };
template <> struct KindRaw<KIND_IQ4_XS> { using type = IQ4XSRaw; };
template <> struct KindRaw<KIND_IQ3_XXS> { using type = IQ3XXSRaw; };
template <> struct KindRaw<KIND_IQ3_S> { using type = IQ3SRaw; };
template <> struct KindRaw<KIND_IQ2_S> { using type = IQ2SRaw; };
template <> struct KindRaw<KIND_IQ2_XXS> { using type = IQ2XXSRaw; };
template <> struct KindRaw<KIND_IQ2_XS> { using type = IQ2XSRaw; };
template <> struct KindRaw<KIND_IQ1_S> { using type = IQ1SRaw; };
template <> struct KindRaw<KIND_IQ1_M> { using type = IQ1MRaw; };
template <> struct KindRaw<KIND_TQ1_0> { using type = TQRaw; };
template <> struct KindRaw<KIND_TQ2_0> { using type = TQRaw; };
template <int KIND>
using QmvRaw = typename KindRaw<KIND>::type;

template <int KIND>
__device__ __forceinline__ QmvRaw<KIND> qmv_raw(const uint8_t* blk, int i) {
    if constexpr (KIND == KIND_Q4_K) return q4k_raw(blk, i);
    else if constexpr (KIND == KIND_Q6_K) return q6k_raw(blk, i);
    else if constexpr (KIND == KIND_Q8_0) return q80_raw(blk, i);
    else if constexpr (KIND == KIND_Q5_K) return q5k_raw(blk, i);
    else if constexpr (kind_legacy(KIND)) return legacy_raw<KIND>(blk, i);
    else if constexpr (KIND == KIND_Q2_K) return q2k_raw(blk, i);
    else if constexpr (KIND == KIND_Q3_K) return q3k_raw(blk, i);
    else if constexpr (KIND == KIND_IQ4_NL) return legacy_raw<KIND_Q4_0>(blk, i);
    else if constexpr (KIND == KIND_IQ4_XS) return iq4xs_raw(blk, i);
    else if constexpr (KIND == KIND_IQ3_XXS) return iq3xxs_raw(blk, i);
    else if constexpr (KIND == KIND_IQ3_S) return iq3s_raw(blk, i);
    else if constexpr (KIND == KIND_IQ2_S) return iq2s_raw(blk, i);
    else if constexpr (KIND == KIND_IQ2_XXS) return iq2xxs_raw(blk, i);
    else if constexpr (KIND == KIND_IQ2_XS) return iq2xs_raw(blk, i);
    else if constexpr (KIND == KIND_IQ1_S) return iq1s_raw(blk, i);
    else if constexpr (KIND == KIND_IQ1_M) return iq1m_raw(blk, i);
    else return tq_raw<KIND>(blk, i);
}

// Parts of a lane's slice that share a scale: Q4_K, Q5_K, IQ2_S, IQ2_XS and
// IQ1_M 2 of 16; Q6_K, Q2_K and Q3_K 4 of 8; Q8_0, the legacy, the other
// codebook and the ternary kinds one of 32.
template <int KIND>
__host__ __device__ constexpr int qmv_parts() {
    return KIND == KIND_Q6_K || kind_low_k(KIND) ? 4
         : KIND == KIND_Q8_0 || kind_legacy(KIND) ||
                   (kind_signed(KIND) && KIND != KIND_IQ2_S && KIND != KIND_IQ2_XS &&
                    KIND != KIND_IQ1_M) ? 1
         : 2;
}

// Whether the kind's levels carry an offset folded against sums of x: Q8_0's
// and the codebook and ternary kinds' levels are signed integers
// themselves, with no bias and no min.
template <int KIND>
__host__ __device__ constexpr bool qmv_has_offset() { return KIND != KIND_Q8_0 && !kind_signed(KIND); }

// A lane's 32 levels plus their bias (exact f32: Q4_K, Q4_0, Q4_1, Q2_K
// and Q3_K 16 + q, Q5_K, Q5_0 and Q5_1 32 + q, Q6_K 64 + q; Q8_0 and the
// codebook and ternary kinds the signed level, IQ1_S and IQ1_M times 8, no
// bias) and its parts' scale sc and offset mn (the bias, the kind's own
// offset and min folded in; 0 for Q8_0, the codebook and ternary kinds).
template <int KIND>
__device__ __forceinline__ void qmv_levels(const QmvRaw<KIND>& r, int i, float (&lv)[QMV_SLICE],
                                           float (&sc)[qmv_parts<KIND>()],
                                           float (&mn)[qmv_parts<KIND>()]) {
    if constexpr (kind_signed(KIND)) {
        uint32_t x80[8];
        float s2[2];
        iq_slot<KIND>(r, i, x80, s2);
#pragma unroll
        for (int p = 0; p < qmv_parts<KIND>(); ++p) {
            sc[p] = s2[p];
            mn[p] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            lv[4 * k + 0] = s8_level<0>(x80[k]);
            lv[4 * k + 1] = s8_level<1>(x80[k]);
            lv[4 * k + 2] = s8_level<2>(x80[k]);
            lv[4 * k + 3] = s8_level<3>(x80[k]);
        }
    } else if constexpr (kind_legacy(KIND)) {
        const LegacyFields f = legacy_fields<KIND>(r);
        const float d = f16_bits(f.dm & 0xFFFF);
        sc[0] = d;
        // sum x (d q + m) = d sum (B + q) x - (B d - m) sum x; Q4_0, Q5_0 the
        // code's own - 8, - 16 as well
        mn[0] = legacy_has_min(KIND) ? fmaf(legacy_bias<KIND>(), d, -f16_bits(f.dm >> 16))
                                     : (legacy_bias<KIND>() + legacy_offset<KIND>()) * d;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            uint32_t lo, hi;
            legacy_bytes<KIND>(f, k, lo, hi);
            if constexpr (legacy_5bit(KIND)) {
                lv[4 * k + 0] = level_plus<32, 0>(lo);
                lv[4 * k + 1] = level_plus<32, 1>(lo);
                lv[4 * k + 2] = level_plus<32, 2>(lo);
                lv[4 * k + 3] = level_plus<32, 3>(lo);
                lv[16 + 4 * k + 0] = level_plus<32, 0>(hi);
                lv[16 + 4 * k + 1] = level_plus<32, 1>(hi);
                lv[16 + 4 * k + 2] = level_plus<32, 2>(hi);
                lv[16 + 4 * k + 3] = level_plus<32, 3>(hi);
            } else {
                lv[4 * k + 0] = level_plus<16, 0>(lo);
                lv[4 * k + 1] = level_plus<16, 1>(lo);
                lv[4 * k + 2] = level_plus<16, 2>(lo);
                lv[4 * k + 3] = level_plus<16, 3>(lo);
                lv[16 + 4 * k + 0] = level_plus<16, 0>(hi);
                lv[16 + 4 * k + 1] = level_plus<16, 1>(hi);
                lv[16 + 4 * k + 2] = level_plus<16, 2>(hi);
                lv[16 + 4 * k + 3] = level_plus<16, 3>(hi);
            }
        }
    } else if constexpr (kind_low_k(KIND)) {
        float ml[4];
        low_k_scales<KIND>(r, i, sc, ml);
#pragma unroll
        for (int qt = 0; qt < 4; ++qt)  // the levels' +16 (Q3_K: and the code's -4) folded in
            mn[qt] = KIND == KIND_Q2_K ? fmaf(16.f, sc[qt], ml[qt]) : 20.f * sc[qt];
        uint32_t q[2], h[2];
        low_k_fields<KIND>(r, q, h);
        const int c = i >> 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int qt = 0; qt < 4; ++qt) {
                const uint32_t m = low_k_bytes<KIND>(q[e], h[e], c, qt);
                lv[qt * 8 + 4 * e + 0] = level_plus<16, 0>(m);
                lv[qt * 8 + 4 * e + 1] = level_plus<16, 1>(m);
                lv[qt * 8 + 4 * e + 2] = level_plus<16, 2>(m);
                lv[qt * 8 + 4 * e + 3] = level_plus<16, 3>(m);
            }
        }
    } else if constexpr (KIND == KIND_Q8_0) {
        sc[0] = f16_bits(q80_d(r));
        mn[0] = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const uint32_t w = q80_qs(r, k) ^ 0x80808080u;
            lv[4 * k + 0] = s8_level<0>(w);
            lv[4 * k + 1] = s8_level<1>(w);
            lv[4 * k + 2] = s8_level<2>(w);
            lv[4 * k + 3] = s8_level<3>(w);
        }
    } else if constexpr (KIND == KIND_Q5_K) {
        const int j = i >> 1;
        const float d = f16_bits(r.h.x & 0xFFFF), dmin = f16_bits(r.h.x >> 16);
        int sc0, m0, sc1, m1;
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j, sc0, m0);
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j + 1, sc1, m1);
        sc[0] = d * u23_f32(sc0);
        sc[1] = d * u23_f32(sc1);
        mn[0] = fmaf(32.f, sc[0], dmin * u23_f32(m0));  // the levels' +32 folded in
        mn[1] = fmaf(32.f, sc[1], dmin * u23_f32(m1));
        const uint32_t w[4] = {r.q.x, r.q.y, r.q.z, r.q.w};
        const uint32_t h[4] = {r.qh.x, r.qh.y, r.qh.z, r.qh.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            uint32_t lo, hi;
            q5k_bytes(w[k], h[k], j, lo, hi);
            lv[4 * k + 0] = level_plus<32, 0>(lo);
            lv[4 * k + 1] = level_plus<32, 1>(lo);
            lv[4 * k + 2] = level_plus<32, 2>(lo);
            lv[4 * k + 3] = level_plus<32, 3>(lo);
            lv[16 + 4 * k + 0] = level_plus<32, 0>(hi);
            lv[16 + 4 * k + 1] = level_plus<32, 1>(hi);
            lv[16 + 4 * k + 2] = level_plus<32, 2>(hi);
            lv[16 + 4 * k + 3] = level_plus<32, 3>(hi);
        }
    } else if constexpr (KIND == KIND_Q4_K) {
        const int j = i >> 1;
        const float d = f16_bits(r.h.x & 0xFFFF), dmin = f16_bits(r.h.x >> 16);
        int sc0, m0, sc1, m1;
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j, sc0, m0);
        q4k_scale_min(r.h.y, r.h.z, r.h.w, 2 * j + 1, sc1, m1);
        sc[0] = d * u23_f32(sc0);
        sc[1] = d * u23_f32(sc1);
        mn[0] = fmaf(16.f, sc[0], dmin * u23_f32(m0));  // the levels' +16 folded in
        mn[1] = fmaf(16.f, sc[1], dmin * u23_f32(m1));
        const uint32_t w[4] = {r.q.x, r.q.y, r.q.z, r.q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // each nibble as 0x80 | q << 3: the high mantissa byte of 16 + q
            const uint32_t lo = ((w[k] << 3) & 0x78787878u) | 0x80808080u;
            const uint32_t hi = ((w[k] >> 1) & 0x78787878u) | 0x80808080u;
            lv[4 * k + 0] = level_plus<16, 0>(lo);
            lv[4 * k + 1] = level_plus<16, 1>(lo);
            lv[4 * k + 2] = level_plus<16, 2>(lo);
            lv[4 * k + 3] = level_plus<16, 3>(lo);
            lv[16 + 4 * k + 0] = level_plus<16, 0>(hi);
            lv[16 + 4 * k + 1] = level_plus<16, 1>(hi);
            lv[16 + 4 * k + 2] = level_plus<16, 2>(hi);
            lv[16 + 4 * k + 3] = level_plus<16, 3>(hi);
        }
    } else {
        uint32_t f[4][2];  // ql low, ql high, qh, scales: 8 bytes each
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            f[k][0] = __funnelshift_r(r.w[k][0], r.w[k][1], r.shift);
            f[k][1] = __funnelshift_r(r.w[k][1], r.w[k][2], r.shift);
        }
        const float d = f16_bits(r.d);
        const int g = (i & 3) >> 1;  // which of the chunk's two 16-element scales
        const uint32_t s01 = f[3][0] >> (8 * g), s23 = f[3][1] >> (8 * g);
        sc[0] = d * s8_f32(s01 & 0xFF);
        sc[1] = d * s8_f32((s01 >> 16) & 0xFF);
        sc[2] = d * s8_f32(s23 & 0xFF);
        sc[3] = d * s8_f32((s23 >> 16) & 0xFF);
#pragma unroll
        for (int qt = 0; qt < 4; ++qt) mn[qt] = 96.f * sc[qt];  // the level's -32, and +64
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t a = f[0][e], b = f[1][e], h = f[2][e];
            const uint32_t q[4] = {
                (a & 0x0F0F0F0Fu) | ((h << 4) & 0x30303030u),
                (b & 0x0F0F0F0Fu) | ((h << 2) & 0x30303030u),
                ((a >> 4) & 0x0F0F0F0Fu) | (h & 0x30303030u),
                ((b >> 4) & 0x0F0F0F0Fu) | ((h >> 2) & 0x30303030u),
            };
#pragma unroll
            for (int qt = 0; qt < 4; ++qt) {
                const uint32_t m = (q[qt] << 1) | 0x80808080u;  // high mantissa bytes of 64 + q
                lv[qt * 8 + 4 * e + 0] = level_plus<64, 0>(m);
                lv[qt * 8 + 4 * e + 1] = level_plus<64, 1>(m);
                lv[qt * 8 + 4 * e + 2] = level_plus<64, 2>(m);
                lv[qt * 8 + 4 * e + 3] = level_plus<64, 3>(m);
            }
        }
    }
}

__device__ __forceinline__ int q4k_x_offset(int i, int part) {  // part 0: k<16, 1: k>=16
    return (i >> 1) * 64 + (i & 1) * 16 + part * 32;
}

// The 32 activation values matching a lane's slice, for one row of x.
template <int KIND, typename TX>
__device__ __forceinline__ void x_slice(const TX* xsb, int i, float* xv) {
    if constexpr (KIND == KIND_Q8_0 || kind_legacy(KIND) || kind_signed(KIND)) {
#pragma unroll
        for (int k = 0; k < 4; ++k) load8(xsb + 32 * i + 8 * k, xv + 8 * k);
    } else if constexpr (KIND == KIND_Q4_K || KIND == KIND_Q5_K) {
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

// acc += the folded dot of one row's levels with one row of x, part by part
template <int KIND>
__device__ __forceinline__ float qmv_fold(const float (&lv)[QMV_SLICE], const float* xv,
                                          const float (&sc)[qmv_parts<KIND>()],
                                          const float (&mn)[qmv_parts<KIND>()],
                                          const float (&sx)[qmv_parts<KIND>()], float acc) {
    constexpr int P = qmv_parts<KIND>(), L = QMV_SLICE / P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) dot = fmaf(lv[p * L + k], xv[p * L + k], dot);
        acc = qmv_has_offset<KIND>() ? fmaf(sc[p], dot, fmaf(-mn[p], sx[p], acc))
                                     : fmaf(sc[p], dot, acc);
    }
    return acc;
}

// The sums of x over each part of a lane's slice (none for Q8_0).
template <int KIND>
__device__ __forceinline__ void x_part_sums(const float* xv, float (&sx)[qmv_parts<KIND>()]) {
    constexpr int P = qmv_parts<KIND>(), L = QMV_SLICE / P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        sx[p] = 0.f;
        if constexpr (qmv_has_offset<KIND>()) {
#pragma unroll
            for (int k = 0; k < L; ++k) sx[p] += xv[p * L + k];
        }
    }
}

// One warp's walk over the row groups g, g + gstep, ... (< groups) of the
// [n, K] wire weight `wq`: group g is rows gR..gR+R-1 (rows past n re-read
// row n - 1 and are not written), each against the first B (<= NB) rows of
// x [B, K]; out [B, n] gets the sums. The walk is one flat sequence of
// items, a group's step of QMV_SB_STEP superblocks: the next item's raw
// bytes are loaded into registers before this item's arithmetic, also
// across the end of a group.
template <int KIND, int NB, int R, typename TX>
__device__ void qmv_walk(const uint8_t* __restrict__ wq, int n, int row_bytes,
                         const TX* __restrict__ x, int B, int K, int g, int gstep, int groups,
                         float* __restrict__ out) {
    constexpr int P = qmv_parts<KIND>();
    constexpr int bpb = kind_sb_bytes(KIND);
    const int lane = threadIdx.x & 31;
    const int sub = lane >> 3;  // which of the step's four superblocks
    const int i = lane & 7;     // slice slot within the superblock
    const int nsb = K / QK_K;
    const int steps = (nsb + QMV_SB_STEP - 1) / QMV_SB_STEP;
    if (g >= groups) return;
    // row r's block of group gg at step st (a lane past the last superblock
    // re-reads it and drops its sums)
    auto load = [&](int gg, int st, QmvRaw<KIND> (&raw)[R]) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            raw[r] = qmv_raw<KIND>(wq + (size_t)min(gg * R + r, n - 1) * row_bytes +
                                       (size_t)min(st * QMV_SB_STEP + sub, nsb - 1) * bpb, i);
    };
    QmvRaw<KIND> cur[R];
    load(g, 0, cur);
    float acc[R][NB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;
    int st = 0;
    while (true) {
        int gn = g, sn = st + 1;
        if (sn == steps) {
            sn = 0;
            gn += gstep;
        }
        const bool more = gn < groups;
        QmvRaw<KIND> nxt[R];
        if (more) load(gn, sn, nxt);
        const int sb = st * QMV_SB_STEP + sub;
        if (sb < nsb) {
            if constexpr (NB == 1) {
                float xv[QMV_SLICE], sx[P];
                x_slice<KIND>(x + (size_t)sb * QK_K, i, xv);
                x_part_sums<KIND>(xv, sx);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    float lv[QMV_SLICE], sc[P], mn[P];
                    qmv_levels<KIND>(cur[r], i, lv, sc, mn);
                    acc[r][0] = qmv_fold<KIND>(lv, xv, sc, mn, sx, acc[r][0]);
                }
            } else {
                float lv[R][QMV_SLICE], sc[R][P], mn[R][P];
#pragma unroll
                for (int r = 0; r < R; ++r) qmv_levels<KIND>(cur[r], i, lv[r], sc[r], mn[r]);
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    if (b >= B) break;
                    float xv[QMV_SLICE], sx[P];
                    x_slice<KIND>(x + (size_t)b * K + (size_t)sb * QK_K, i, xv);
                    x_part_sums<KIND>(xv, sx);
#pragma unroll
                    for (int r = 0; r < R; ++r)
                        acc[r][b] = qmv_fold<KIND>(lv[r], xv, sc[r], mn[r], sx, acc[r][b]);
                }
            }
        }
        if (sn == 0) {  // the group's last step: reduce across the warp and store
            const int row0 = g * R;
#pragma unroll
            for (int r = 0; r < R; ++r) {
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    const float s = warp_sum(acc[r][b]);
                    if (lane == 0 && b < B && row0 + r < n) out[(size_t)b * n + row0 + r] = s;
                    acc[r][b] = 0.f;
                }
            }
        }
        if (!more) break;
#pragma unroll
        for (int r = 0; r < R; ++r) cur[r] = nxt[r];
        g = gn;
        st = sn;
    }
}

// One weight of a QK_K run of any kind but Q4_K and Q6_K, formed as the
// plain dequant (quant/wire.py) forms it, each product and sum rounded once:
// element c (0..255) of the run at `sb`, read byte by byte (the run may lie
// at any even address). qgemm_id.cu's generic dequant reads its raw ring
// through this.
__device__ __forceinline__ uint32_t u16_at(const uint8_t* p) { return p[0] | (p[1] << 8); }

template <int KIND>
__device__ __forceinline__ float wire_weight(const uint8_t* sb, int c) {
    if constexpr (KIND == KIND_Q8_0) {
        const uint8_t* b = sb + 34 * (c >> 5);
        return __fmul_rn((float)(int8_t)b[2 + (c & 31)], f16_bits(u16_at(b)));
    } else if constexpr (kind_legacy(KIND)) {
        constexpr int QH = KIND == KIND_Q5_0 ? 2 : 4, QS = KIND == KIND_Q4_0 ? 2
                         : KIND == KIND_Q4_1 ? 4 : KIND == KIND_Q5_0 ? 6 : 8;
        const uint8_t* b = sb + legacy_block_bytes(KIND) * (c >> 5);
        const int j = c & 31;
        int q = (b[QS + (j & 15)] >> (4 * (j >> 4))) & 0xF;
        if constexpr (legacy_5bit(KIND)) q |= ((b[QH + (j >> 3)] >> (j & 7)) & 1) << 4;
        const float d = f16_bits(u16_at(b));
        if constexpr (legacy_has_min(KIND))
            return __fadd_rn(__fmul_rn((float)q, d), f16_bits(u16_at(b + 2)));
        else
            return __fmul_rn((float)(q - (int)legacy_offset<KIND>()), d);
    } else if constexpr (kind_low_k(KIND)) {
        const int l = c & 31, g = c >> 4;
        const int qs = (KIND == KIND_Q2_K ? 16 : 32) + 32 * (c >> 7) + l;
        const int q2 = (sb[qs] >> (2 * ((c >> 5) & 3))) & 3;
        if constexpr (KIND == KIND_Q2_K) {
            const int s = sb[g];
            const float dl = __fmul_rn(f16_bits(u16_at(sb + 80)), (float)(s & 0xF));
            const float ml = __fmul_rn(f16_bits(u16_at(sb + 82)), (float)(s >> 4));
            return __fsub_rn(__fmul_rn(dl, (float)q2), ml);
        } else {
            const int lo = (sb[96 + (g & 7)] >> (4 * (g >> 3))) & 0xF;
            const int hi = (sb[104 + (g & 3)] >> (2 * (g >> 2))) & 3;
            const float dl = __fmul_rn(f16_bits(u16_at(sb + 108)), (float)((lo | (hi << 4)) - 32));
            const int hbit = (sb[l] >> (c >> 5)) & 1;
            return __fmul_rn(dl, (float)(q2 - (hbit ? 0 : 4)));
        }
    } else if constexpr (KIND == KIND_IQ4_NL || KIND == KIND_IQ4_XS) {
        const int ib = c >> 5, j = c & 31;
        const uint8_t* qs = KIND == KIND_IQ4_NL ? sb + 18 * ib + 2 : sb + 8 + 16 * ib;
        const uint32_t q = (qs[j & 15] >> (4 * (j >> 4))) & 0xF;
        const uint32_t b = __byte_perm(q & 8 ? IQ4NL_X80_2 : IQ4NL_X80_0,
                                       q & 8 ? IQ4NL_X80_3 : IQ4NL_X80_1, q & 7) & 0xFF;
        const float level = (float)(int)b - 128.f;
        if constexpr (KIND == KIND_IQ4_NL) return __fmul_rn(level, f16_bits(u16_at(sb + 18 * ib)));
        const int ls = ((sb[4 + (ib >> 1)] >> (4 * (ib & 1))) & 0xF) |
                       (((u16_at(sb + 2) >> (2 * ib)) & 3) << 4);
        return __fmul_rn(__fmul_rn(f16_bits(u16_at(sb)), (float)(ls - 32)), level);
    } else if constexpr (kind_iq(KIND)) {
        // a grid byte g, its sign, and the sub-block's scale dl: (dl * g) * sign
        const int ib = c >> 5, j = c & 31;
        const float d = f16_bits(u16_at(sb));
        uint32_t g, neg;
        float dl;
        if constexpr (KIND == KIND_IQ3_XXS) {
            const int l = j >> 3, e = j & 7;
            const uint32_t sas = u16_at(sb + 66 + 4 * ib) | (u16_at(sb + 68 + 4 * ib) << 16);
            g = __ldg(&IQ3XXS_GRID[sb[2 + 8 * ib + 2 * l + (e >> 2)]]) >> (8 * (e & 3));
            neg = iq_ksigns((sas >> (7 * l)) & 127) >> e;
            dl = __fmul_rn(__fmul_rn(d, 0.5f + (float)(sas >> 28)), 0.5f);
        } else if constexpr (KIND == KIND_IQ3_S) {
            const int m = j >> 2, e = j & 3;
            g = __ldg(&IQ3S_GRID[sb[2 + 8 * ib + m] | (((sb[66 + ib] >> m) & 1) << 8)]) >> (8 * e);
            neg = sb[74 + 4 * ib + (m >> 1)] >> (4 * (m & 1) + e);
            dl = __fmul_rn(d, (float)(1 + 2 * ((sb[106 + (ib >> 1)] >> (4 * (ib & 1))) & 0xF)));
        } else {
            const int l = j >> 3, e = j & 7;
            const int idx = sb[2 + 4 * ib + l] | (((sb[66 + ib] >> (2 * l)) & 3) << 8);
            g = __ldg(&IQ2S_GRID[2 * idx + (e >> 2)]) >> (8 * (e & 3));
            neg = sb[34 + 4 * ib + l] >> e;
            const int s = sb[74 + ib];
            dl = __fmul_rn(__fmul_rn(d, 0.5f + (float)(l < 2 ? s & 0xF : s >> 4)), 0.25f);
        }
        const float w = __fmul_rn(dl, (float)(g & 0xFF));
        return neg & 1 ? -w : w;
    } else if constexpr (KIND == KIND_IQ2_XXS || KIND == KIND_IQ2_XS) {
        // a grid byte g, its sign, and the scale dl: (dl * g) * sign
        const int ib = c >> 5, l = (c & 31) >> 3, e = c & 7;
        const float d = f16_bits(u16_at(sb));
        uint32_t idx, s;
        float dl;
        if constexpr (KIND == KIND_IQ2_XXS) {
            const uint32_t a1 = u16_at(sb + 6 + 8 * ib) | (u16_at(sb + 8 + 8 * ib) << 16);
            idx = sb[2 + 8 * ib + l];
            s = iq_ksigns((a1 >> (7 * l)) & 127);
            dl = __fmul_rn(__fmul_rn(d, 0.5f + (float)(a1 >> 28)), 0.25f);
        } else {
            const uint32_t q = u16_at(sb + 2 + 8 * ib + 2 * l);
            const int sc = sb[66 + ib];
            idx = q & 511;
            s = iq_ksigns(q >> 9);
            dl = __fmul_rn(__fmul_rn(d, 0.5f + (float)(l < 2 ? sc & 0xF : sc >> 4)), 0.25f);
        }
        const uint32_t* grid = KIND == KIND_IQ2_XXS ? &IQ2XXS_GRID[0] : &IQ2XS_GRID[0];
        const uint32_t g = __ldg(&grid[2 * idx + (e >> 2)]) >> (8 * (e & 3));
        const float w = __fmul_rn(dl, (float)(g & 0xFF));
        return (s >> e) & 1 ? -w : w;
    } else if constexpr (KIND == KIND_IQ1_S || KIND == KIND_IQ1_M) {
        // the scale dl times (grid + delta)
        const int ib = c >> 5, l = (c & 31) >> 3, e = c & 7;
        uint32_t idx, neg;
        float dl;
        if constexpr (KIND == KIND_IQ1_S) {
            const uint32_t qh = u16_at(sb + 34 + 2 * ib);
            idx = sb[2 + 4 * ib + l] | (((qh >> (3 * l)) & 7) << 8);
            neg = qh >> 15;
            dl = __fmul_rn(f16_bits(u16_at(sb)), (float)(2 * ((qh >> 12) & 7) + 1));
        } else {
            const uint32_t h = (sb[32 + 2 * ib + (l >> 1)] >> (4 * (l & 1))) & 0xF;
            const uint32_t d16 = (u16_at(sb + 48) >> 12) | ((u16_at(sb + 50) >> 8) & 0xF0) |
                                 ((u16_at(sb + 52) >> 4) & 0xF00) | (u16_at(sb + 54) & 0xF000);
            const uint32_t s = u16_at(sb + 48 + 2 * (ib >> 1)) >> (6 * (ib & 1) + 3 * (l >> 1));
            idx = sb[4 * ib + l] | ((h & 7) << 8);
            neg = h >> 3;
            dl = __fmul_rn(f16_bits(d16), (float)(2 * (s & 7) + 1));
        }
        const uint32_t g = (__ldg(&IQ1S_GRID[idx]) >> (8 * (e & 3) + 4 * (e >> 2))) & 0xF;
        return __fmul_rn(dl, __fadd_rn((float)g - 1.f, neg & 1 ? -0.125f : 0.125f));
    } else if constexpr (KIND == KIND_TQ1_0 || KIND == KIND_TQ2_0) {
        // (q - 1) * d; TQ1_0's element c is base-3 digit j of byte b: 32
        // bytes a digit below 160, 16 below 240, 4 after
        int q;
        if constexpr (KIND == KIND_TQ2_0) {
            q = (sb[32 * (c >> 7) + (c & 31)] >> (2 * ((c >> 5) & 3))) & 3;
        } else {
            const int b = c < 160 ? c & 31 : c < 240 ? 32 + ((c - 160) & 15) : 48 + (c & 3);
            const int j = c < 160 ? c >> 5 : c < 240 ? (c - 160) >> 4 : (c - 240) >> 2;
            q = (((sb[b] * (int)((0x511B090301ull >> (8 * j)) & 0xFF)) & 0xFF) * 3) >> 8;
        }
        return __fmul_rn((float)(q - 1), f16_bits(u16_at(sb + (KIND == KIND_TQ1_0 ? 52 : 64))));
    } else {
        static_assert(KIND == KIND_Q5_K, "Q4_K and Q6_K have tuned dequants of their own");
        const int j = c >> 5, r = j & 3;  // the 32-weight sub-block and its scale bytes
        const int sc = j < 4 ? sb[4 + j] & 63 : (sb[12 + r] & 0xF) | ((sb[4 + r] >> 6) << 4);
        const int mn = j < 4 ? sb[8 + j] & 63 : (sb[12 + r] >> 4) | ((sb[8 + r] >> 6) << 4);
        const int q = ((sb[48 + 32 * (c >> 6) + (c & 31)] >> (4 * ((c >> 5) & 1))) & 0xF) |
                      (((sb[16 + (c & 31)] >> j) & 1) << 4);
        const float dl = __fmul_rn(f16_bits(u16_at(sb)), (float)sc);
        const float ml = __fmul_rn(f16_bits(u16_at(sb + 2)), (float)mn);
        return __fsub_rn(__fmul_rn(dl, (float)q), ml);
    }
}

// Softcap and masking constants shared by both attention kernels: masked
// scores sit at -1e30 (never -inf, so exp of a difference stays finite) and
// contribute probability exactly 0.
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float softcap_score(float s, float softcap) {
    return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// ---------------------------------------------------------------------------
// Quantized KV cache planes (runtime/kv_cache.py). One layer of one tensor
// is up to four planes, each [B, S, Hkv*W] row-major: q (int8 [D] for q8_0,
// nibble-packed uint8 [D/2] for the 4/5-bit kinds, f16/bf16 [D] for the
// dense kinds), s (f32 scale [G]), m (f32 min [G], q4_1/q5_1), h (int32
// 5th-bit pack [G], q5_0/q5_1). Head columns are stored group-strided:
// stored column c holds natural element kv_nat(c) (groups of KV_GS).
// Numbered as KV_KIND_ID in ops/cuda/build.py.
enum { KV_Q8_0 = 0, KV_Q4_0 = 1, KV_Q4_1 = 2, KV_Q5_0 = 3, KV_Q5_1 = 4, KV_F16 = 5,
       KV_BF16 = 6 };
constexpr int KV_GS = 32;  // elements a group (the launchers take D % 32 == 0)

struct KVPlanes {
    const void* q;
    const float* s;
    const float* m;
    const int* h;
};

// One head's row of the planes at row index `row` = (b * S + pos) * Hkv + hk.
struct KVRow {
    const uint8_t* q;
    const float* s;
    const float* m;
    const int* h;
};

template <int KIND>
__device__ __forceinline__ KVRow kv_row(const KVPlanes& p, size_t row, int D, int G) {
    constexpr bool nib = KIND == KV_Q4_0 || KIND == KV_Q4_1 || KIND == KV_Q5_0 || KIND == KV_Q5_1;
    constexpr bool dense = KIND == KV_F16 || KIND == KV_BF16;
    const size_t qbytes = dense ? 2 * (size_t)D : nib ? (size_t)D / 2 : (size_t)D;
    return {static_cast<const uint8_t*>(p.q) + row * qbytes, p.s + row * G, p.m + row * G,
            p.h + row * G};
}

// stored (group-strided) column c -> natural head-dim index
__device__ __forceinline__ int kv_nat(int c, int G) { return (c % G) * KV_GS + c / G; }

// The value of stored column c from its raw level `lvl`, in the f32
// operation order of kv_dequant_planes: (lvl [+ 16*bit] [- 8 | - 16]) * s
// [+ m]. The integer steps are exact; the product and the sum are rounded
// once each (no fused multiply-add), so the value is bit-exact.
template <int KIND>
__device__ __forceinline__ float kv_level(int lvl, const KVRow& r, int c, int G) {
    const int g = c % G;
    float v = (float)lvl;
    if constexpr (KIND == KV_Q5_0 || KIND == KV_Q5_1)
        v = __fadd_rn(v, 16.f * (float)((r.h[g] >> (c / G)) & 1));
    if constexpr (KIND == KV_Q4_0) v = __fsub_rn(v, 8.f);
    if constexpr (KIND == KV_Q5_0) v = __fsub_rn(v, 16.f);
    float out = __fmul_rn(v, r.s[g]);
    if constexpr (KIND == KV_Q4_1 || KIND == KV_Q5_1) out = __fadd_rn(out, r.m[g]);
    return out;
}

// Stored column c of a row, dequantized to f32.
template <int KIND>
__device__ __forceinline__ float kv_deq1(const KVRow& r, int c, int D, int G) {
    if constexpr (KIND == KV_F16) {
        return __half2float(reinterpret_cast<const __half*>(r.q)[c]);
    } else if constexpr (KIND == KV_BF16) {
        return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(r.q)[c]);
    } else if constexpr (KIND == KV_Q8_0) {
        return kv_level<KIND>(reinterpret_cast<const int8_t*>(r.q)[c], r, c, G);
    } else {
        const int half = D >> 1;
        const int byte = r.q[c < half ? c : c - half];
        return kv_level<KIND>(c < half ? (byte & 0xF) : (byte >> 4), r, c, G);
    }
}

// Stored columns c0 .. c0+7 of an f16 or bf16 row (c0 % 8 == 0) as f32, by
// one 16-byte load (flash_decode_quant.cu reads the quantized kinds itself).
template <int KIND>
__device__ __forceinline__ void kv_deq8(const KVRow& r, int c0, float* out) {
    static_assert(KIND == KV_F16 || KIND == KV_BF16, "the dense kinds only");
    const uint4 u = *reinterpret_cast<const uint4*>(r.q + 2 * (size_t)c0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if constexpr (KIND == KV_F16) {
            const __half2 h = *reinterpret_cast<const __half2*>(&w[i]);
            out[2 * i] = __low2float(h);
            out[2 * i + 1] = __high2float(h);
        } else {
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
            out[2 * i] = __low2float(h);
            out[2 * i + 1] = __high2float(h);
        }
    }
}

// Where one staging slot in shared memory holds the plane rows of `rows`
// positions of one layer's K and V (flash_decode_quant.cu: a warp's round;
// flash_prefill_quant.cu: a 64-position tile): plane j (K q, s, m, h; V q,
// s, m, h) at off[j], rowb[j] bytes a row (0: the kind has no such plane).
// The kind decides only how many bytes a row has: flash_decode_quant.cu
// copies the planes kind-blind by cp.async in units of unit[j] bytes;
// flash_prefill_quant.cu compiles its copy per kind and reads src, off and
// bytes. Set on the host from the kinds and head dims (kv_stage).
constexpr int KV_STAGE_PLANES = 8;
struct KVStage {
    const uint8_t* src[KV_STAGE_PLANES];  // the layer's planes
    int rowb[KV_STAGE_PLANES];
    int off[KV_STAGE_PLANES];
    int unit[KV_STAGE_PLANES];
    int per_log2[KV_STAGE_PLANES];  // log2 of rowb / unit where a power of two, else -1
    int bytes;    // a slot
    int rows;     // positions a slot holds
    int q_bytes;  // flash_decode_quant.cu: the staged q ahead of the rings
};

// The slot layout of one launch: each plane's row bytes by kind, each
// plane's rows 16-byte aligned in the slot.
static inline KVStage kv_stage(int kind_k, int kind_v, const KVPlanes& kp, const KVPlanes& vp,
                               int Dk, int Dv, int rows) {
    KVStage st{};
    st.rows = rows;
    int off = 0;
    const int kinds[2] = {kind_k, kind_v}, dims[2] = {Dk, Dv};
    const KVPlanes* planes[2] = {&kp, &vp};
    for (int t = 0; t < 2; ++t) {
        const int kind = kinds[t], D = dims[t], gb = 4 * (D / KV_GS);
        const bool dense = kind == KV_F16 || kind == KV_BF16;
        const int rowb[4] = {dense ? 2 * D : kind == KV_Q8_0 ? D : D / 2, dense ? 0 : gb,
                             kind == KV_Q4_1 || kind == KV_Q5_1 ? gb : 0,
                             kind == KV_Q5_0 || kind == KV_Q5_1 ? gb : 0};
        const void* src[4] = {planes[t]->q, planes[t]->s, planes[t]->m, planes[t]->h};
        for (int i = 0; i < 4; ++i) {
            const int j = 4 * t + i;
            st.src[j] = static_cast<const uint8_t*>(src[i]);
            st.rowb[j] = rowb[i];
            st.unit[j] = rowb[i] % 16 == 0 ? 16 : rowb[i] % 8 == 0 ? 8 : 4;
            const int per = rowb[i] / st.unit[j];
            st.per_log2[j] = per > 0 && (per & (per - 1)) == 0 ? __builtin_ctz(per) : -1;
            st.off[j] = off;
            off += (st.rows * rowb[i] + 15) / 16 * 16;
        }
    }
    st.bytes = off;
    return st;
}

// Calls FN<kind>(args...) for a kind known only at run time; the switch is
// uniform across a launch.
#define KV_DISPATCH(kind, FN, ...)                                   \
    switch (kind) {                                                  \
        case KV_Q8_0: FN<KV_Q8_0>(__VA_ARGS__); break;               \
        case KV_Q4_0: FN<KV_Q4_0>(__VA_ARGS__); break;               \
        case KV_Q4_1: FN<KV_Q4_1>(__VA_ARGS__); break;               \
        case KV_Q5_0: FN<KV_Q5_0>(__VA_ARGS__); break;               \
        case KV_Q5_1: FN<KV_Q5_1>(__VA_ARGS__); break;               \
        case KV_F16: FN<KV_F16>(__VA_ARGS__); break;                 \
        default: FN<KV_BF16>(__VA_ARGS__); break;                    \
    }

__host__ __device__ inline bool kv_kind_ok(int kind) { return kind >= KV_Q8_0 && kind <= KV_BF16; }

LCG_EXPORT const char* lcg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

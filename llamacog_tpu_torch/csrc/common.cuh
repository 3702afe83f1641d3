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

// quantized weight kinds (GGUF wire format, ggml-common.h block_q4_K/q6_K)
enum { KIND_Q4_K = 0, KIND_Q6_K = 1 };
// element type of activations, caches and outputs
enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int QK_K = 256;        // weights per superblock
constexpr int Q4K_BYTES = 144;   // d f16, dmin f16, scales[12], qs[128]
constexpr int Q6K_BYTES = 210;   // ql[128], qh[64], scales[16] i8, d f16

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

// One dequantized weight, rounded exactly as the plain torch dequant
// (quant/wire.py): (d*sc)*q - dmin*m with no fused multiply-add.
__device__ __forceinline__ float q4k_weight(float dl, float ml, int q) {
    return __fsub_rn(__fmul_rn(dl, (float)q), ml);
}

// ---------------------------------------------------------------------------
// The matvec over wire blocks (qmv.cu, qmv_id.cu). Each warp owns QMV_ROWS
// output rows and walks their superblocks QMV_SB_STEP at a time: eight lanes
// share a superblock, each lane decoding a QMV_SLICE-weight slice.
constexpr int QMV_WARPS = 4;
constexpr int QMV_ROWS = 2;                               // rows per warp
constexpr int QMV_BLOCK_ROWS = QMV_WARPS * QMV_ROWS;      // rows per block
constexpr int QMV_SB_STEP = 4;   // superblocks per warp step (8 lanes each)
constexpr int QMV_SLICE = 32;    // weights per lane per superblock

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

// One warp's QMV_ROWS output rows row0.. of the [n, K] wire weight `wq`
// against the first B (<= NB) rows of x [B, K]: acc[r][b] gets this lane's
// partial sum (the caller reduces with warp_sum). Rows past n re-read row
// n - 1; the caller drops them.
template <int KIND, int NB, typename TX>
__device__ void qmv_rows(const uint8_t* wq, int n, int row_bytes, const TX* x, int B, int K,
                         int row0, float (&acc)[QMV_ROWS][NB]) {
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
            const int row = min(row0 + r, n - 1);  // a spare row re-reads the last
            const uint8_t* blk = wq + (size_t)row * row_bytes + (size_t)sb * bpb;
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

// Stored columns c0 .. c0+7 of a row (c0 % 8 == 0), dequantized to f32,
// with one 8-byte (16-byte for the dense kinds) load of the q plane.
template <int KIND>
__device__ __forceinline__ void kv_deq8(const KVRow& r, int c0, int D, int G, float* out) {
    if constexpr (KIND == KV_F16 || KIND == KV_BF16) {
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
    } else {
        const int half = D >> 1;
        const bool hi = KIND != KV_Q8_0 && c0 >= half;
        const uint2 u = *reinterpret_cast<const uint2*>(r.q + (hi ? c0 - half : c0));
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int byte = ((e < 4 ? u.x : u.y) >> (8 * (e & 3))) & 0xFF;
            int lvl;
            if constexpr (KIND == KV_Q8_0)
                lvl = (int)(int8_t)byte;
            else
                lvl = hi ? byte >> 4 : byte & 0xF;
            out[e] = kv_level<KIND>(lvl, r, c0 + e, G);
        }
    }
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

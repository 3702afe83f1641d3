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

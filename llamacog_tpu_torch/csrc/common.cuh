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

LCG_EXPORT const char* lcg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Split-S decode attention (flash-decoding): the split rule and the combine
// kernel, shared by the decode kernels that split a row's cache positions
// across blocks.
//
// A decode row attends positions [0, n_end), n_end = min(seq_len, s_eff),
// and with a window only positions >= lo = seq_len - window + 1. The host
// picks n_split and split_len from s_eff alone (ops/cuda/flash_q8.py::
// choose_splits), so a launch never reads seq_len on the host. Split sp
// covers [sp * split_len, (sp + 1) * split_len); it is live when it holds a
// position of [lo, n_end). A live split writes its partial result to the
// workspace ws [B, Hkv, n_split, rep, Dv + 2] (f32): the unnormalised
// o[Dv] = sum_p exp(s_p - m) v_p, then m and l = sum_p exp(s_p - m). A split
// that is not live exits at once and writes nothing; the combine skips it
// by the same rule, so its stale workspace is never read.
//
// The combine kernel (one block per (query head, kv head, batch row))
// merges the live splits with the current step's k_cur/v_cur (the deferred
// KV write) and writes out [B, H, Dv] in the input type. No
// weight is formed from two masked maxima (exp(MASKED - MASKED) = 1): the
// current token's score is always finite and enters every maximum.
#pragma once

#include "common.cuh"

constexpr int SPLIT_MAX_REP = 16;  // query heads a split block reduces (a head group)
constexpr int SPLIT_MAX = 512;         // splits a launch may have
constexpr int COMBINE_THREADS = 128;
constexpr int COMBINE_UNROLL = 8;      // splits read at once by a thread

__device__ __forceinline__ int split_window_lo(int n, int window) {
    return window > 0 ? max(0, n - window + 1) : 0;
}

__device__ __forceinline__ bool split_live(int sp, int split_len, int n_end, int lo) {
    const int s0 = sp * split_len;
    return min(s0 + split_len, n_end) > max(s0, lo);
}

// Programmatic dependent launch (sm_90): the split kernel lets the combine
// kernel's blocks start early; the combine waits for the splits to finish
// (and their writes to be visible) before it reads the workspace. Without
// the launch attribute both are no-ops and the stream orders the kernels.
__device__ __forceinline__ void split_launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void split_wait_prerequisites() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Block-wide reduction of one value per thread (max or sum), COMBINE_THREADS
// threads; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float combine_reduce(float v, float* scratch) {
    v = MAX ? warp_max(v) : warp_sum(v);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // scratch free
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
#pragma unroll
    for (int w = 1; w < COMBINE_THREADS / 32; ++w)
        v = MAX ? fmaxf(v, scratch[w]) : v + scratch[w];
    return v;
}

// One block per (query head r of the kv head, kv head, batch row).
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
split_combine_kernel(const float* __restrict__ ws, const T* __restrict__ q,
                     const T* __restrict__ kc, const T* __restrict__ vc,
                     const int* __restrict__ seq_len, T* __restrict__ out, int H, int Hkv,
                     int Dk, int Dv, int s_eff, int n_split, int split_len, float scale,
                     float softcap, int window) {
    __shared__ float wgt[SPLIT_MAX];  // each live split's weight exp(m - m_tot), else 0
    __shared__ float scratch[COMBINE_THREADS / 32];
    const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int rep = H / Hkv;
    const int tid = threadIdx.x;
    const int n = seq_len[b];
    const int n_end = min(n, s_eff);
    const int lo = split_window_lo(n, window);
    const int ld = Dv + 2;
    const float* wsr = ws + ((size_t)b * Hkv + hk) * n_split * rep * ld + (size_t)r * ld;
    const size_t sp_stride = (size_t)rep * ld;

    // the current token's score, then the maximum over it and the live
    // splits, each live split's weight and the denominator
    const T* qr = q + ((size_t)b * H + hk * rep + r) * Dk;
    const T* kr = kc + ((size_t)b * Hkv + hk) * Dk;
    float s = 0.f;
    for (int d = tid; d < Dk; d += COMBINE_THREADS) s = fmaf(to_f32(qr[d]), to_f32(kr[d]), s);
    const float s_cur = softcap_score(combine_reduce<false>(s, scratch) * scale, softcap);
    split_wait_prerequisites();
    float mt = s_cur;
    for (int sp = tid; sp < n_split; sp += COMBINE_THREADS)
        if (split_live(sp, split_len, n_end, lo)) mt = fmaxf(mt, wsr[sp * sp_stride + Dv]);
    mt = combine_reduce<true>(mt, scratch);
    float l = 0.f;
    for (int sp = tid; sp < n_split; sp += COMBINE_THREADS) {
        float w = 0.f;
        if (split_live(sp, split_len, n_end, lo)) {
            w = __expf(wsr[sp * sp_stride + Dv] - mt);
            l += wsr[sp * sp_stride + Dv + 1] * w;
        }
        wgt[sp] = w;
    }
    const float w_cur = __expf(s_cur - mt);
    const float inv = 1.f / (combine_reduce<false>(l, scratch) + w_cur);  // syncs wgt too
    const T* vr = vc + ((size_t)b * Hkv + hk) * Dv;
    T* orow = out + ((size_t)b * H + hk * rep + r) * Dv;
    for (int d = tid; d < Dv; d += COMBINE_THREADS) {
        float o = w_cur * to_f32(vr[d]);
        // COMBINE_UNROLL splits' loads in flight at once; a split that is
        // not live (weight 0) is not read
        for (int sp0 = 0; sp0 < n_split; sp0 += COMBINE_UNROLL) {
            float part[COMBINE_UNROLL], w[COMBINE_UNROLL];
#pragma unroll
            for (int u = 0; u < COMBINE_UNROLL; ++u) {
                const int sp = sp0 + u;
                w[u] = sp < n_split ? wgt[sp] : 0.f;
                part[u] = w[u] != 0.f ? wsr[sp * sp_stride + d] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < COMBINE_UNROLL; ++u) o = fmaf(part[u], w[u], o);
        }
        orow[d] = from_f32<T>(o * inv);
    }
}

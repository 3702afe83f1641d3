// flash_decode_dense — T=1 attention straight out of the stacked dense cache.
//
// Replaces llamacog_tpu/ops/pallas/flash_q8.py::_flash_decode_stacked_dense
// (_decode_flat_dense_kernel): q [B, H, Dk] against layer `il` of the
// stacked cache k/v [L, B, S, Hkv, D], each row stopping at its own
// seq_len, with softcap and sliding window, and the current step's
// k_cur/v_cur [B, Hkv, D] folded in last (the deferred KV write: the cache
// holds only old tokens). Out [B, H, Dv] in the input type.
//
// Bound on this card: bytes — every cached K and V row of the attended
// prefix is read once (2 * seq_len * Hkv * D elements per layer) for a few
// flops per byte. Design: one block per (kv head, batch row) serves the
// kv head's `rep` query heads (q head h reads kv head h / rep), so each K/V
// row is read once for all of them. The block walks the prefix in tiles of
// DEC_TS positions: thread j scores position j against every query head
// (K read by stride from layer il of the stacked cache — no copy), the
// tile's softmax statistics are reduced per head with warp shuffles, and
// thread d accumulates output dimension d over the tile (V reads coalesced
// along D). Online softmax in f32 across tiles. At B = 1, Hkv = 8 this is 8
// blocks on 132 SMs: splitting S across blocks (flash-decoding) is later
// work.
#include "common.cuh"

constexpr int DEC_TS = 128;        // positions per tile = threads per block
constexpr int DEC_MAX_REP = 16;    // query heads per kv head
constexpr int DEC_MAX_D = 256;
constexpr int DEC_DPT = DEC_MAX_D / DEC_TS;  // output dims per thread

template <typename T>
__global__ void __launch_bounds__(DEC_TS)
flash_decode_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ kc,
                          const T* __restrict__ vc, const int* __restrict__ seq_len,
                          T* __restrict__ out, int S, int H, int Hkv, int Dk, int Dv,
                          int s_eff, float scale, float softcap, int window) {
    __shared__ float qs[DEC_MAX_REP * DEC_MAX_D];
    __shared__ float ps[DEC_MAX_REP * DEC_TS];
    __shared__ float m_s[DEC_MAX_REP], l_s[DEC_MAX_REP], a_s[DEC_MAX_REP], c_s[DEC_MAX_REP];

    const int hk = blockIdx.x, b = blockIdx.y;
    const int rep = H / Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = seq_len[b];
    const int n_end = min(n, s_eff);
    const size_t row_stride = (size_t)Hkv * Dk;   // elements between positions
    const size_t vrow_stride = (size_t)Hkv * Dv;
    const T* kb = k + (size_t)b * S * row_stride + (size_t)hk * Dk;
    const T* vb = v + (size_t)b * S * vrow_stride + (size_t)hk * Dv;

    for (int i = tid; i < rep * Dk; i += DEC_TS) {
        const int r = i / Dk, d = i % Dk;
        qs[r * DEC_MAX_D + d] = to_f32(q[((size_t)b * H + hk * rep + r) * Dk + d]);
    }
    if (tid < DEC_MAX_REP) {
        m_s[tid] = MASKED;
        l_s[tid] = 0.f;
    }
    float acc[DEC_MAX_REP][DEC_DPT];
#pragma unroll
    for (int r = 0; r < DEC_MAX_REP; ++r)
#pragma unroll
        for (int e = 0; e < DEC_DPT; ++e) acc[r][e] = 0.f;
    __syncthreads();

    for (int t0 = 0; t0 < n_end; t0 += DEC_TS) {
        const int pos = t0 + tid;
        const bool valid = pos < n_end && (window <= 0 || pos > n - window);
        float s[DEC_MAX_REP];
#pragma unroll
        for (int r = 0; r < DEC_MAX_REP; ++r) s[r] = 0.f;
        if (valid) {
            const T* kp = kb + (size_t)pos * row_stride;
#pragma unroll 4
            for (int d = 0; d < Dk; d += 8) {
                float kv8[8];
                load8(kp + d, kv8);
#pragma unroll
                for (int r = 0; r < DEC_MAX_REP; ++r) {
                    if (r < rep) {
                        const float* qr = qs + r * DEC_MAX_D + d;
#pragma unroll
                        for (int e = 0; e < 8; ++e) s[r] = fmaf(qr[e], kv8[e], s[r]);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < DEC_MAX_REP; ++r)
            if (r < rep) ps[r * DEC_TS + tid] = valid ? softcap_score(s[r] * scale, softcap) : MASKED;
        __syncthreads();
        // per-head tile statistics: warp w reduces heads w, w+4, ...
        for (int r = warp; r < rep; r += DEC_TS / 32) {
            float sv[DEC_TS / 32];
            float mx = MASKED;
#pragma unroll
            for (int i = 0; i < DEC_TS / 32; ++i) {
                sv[i] = ps[r * DEC_TS + lane + 32 * i];
                mx = fmaxf(mx, sv[i]);
            }
            mx = warp_max(mx);
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < DEC_TS / 32; ++i) {
                const float p = sv[i] > 0.5f * MASKED ? __expf(sv[i] - m_new) : 0.f;
                ps[r * DEC_TS + lane + 32 * i] = p;
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = __expf(m_old - m_new);
                a_s[r] = alpha;
                m_s[r] = m_new;
                l_s[r] = l_s[r] * alpha + sum;
            }
        }
        __syncthreads();
        const int cnt = min(DEC_TS, n_end - t0);
#pragma unroll
        for (int e = 0; e < DEC_DPT; ++e) {
            const int d = tid + e * DEC_TS;
            if (d < Dv) {
#pragma unroll
                for (int r = 0; r < DEC_MAX_REP; ++r)
                    if (r < rep) acc[r][e] *= a_s[r];
                // unrolled so several V rows are in flight per thread
#pragma unroll 8
                for (int j = 0; j < cnt; ++j) {
                    const float vv = to_f32(vb[(size_t)(t0 + j) * vrow_stride + d]);
#pragma unroll
                    for (int r = 0; r < DEC_MAX_REP; ++r)
                        if (r < rep) acc[r][e] = fmaf(ps[r * DEC_TS + j], vv, acc[r][e]);
                }
            }
        }
        __syncthreads();
    }

    // the current step's key/value, always attended
    const T* kcur = kc + ((size_t)b * Hkv + hk) * Dk;
    const T* vcur = vc + ((size_t)b * Hkv + hk) * Dv;
    for (int r = warp; r < rep; r += DEC_TS / 32) {
        float s = 0.f;
        for (int d = lane; d < Dk; d += 32) s = fmaf(qs[r * DEC_MAX_D + d], to_f32(kcur[d]), s);
        s = warp_sum(s);
        if (lane == 0) c_s[r] = softcap_score(s * scale, softcap);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < DEC_DPT; ++e) {
        const int d = tid + e * DEC_TS;
        if (d >= Dv) continue;
        const float vv = to_f32(vcur[d]);
#pragma unroll
        for (int r = 0; r < DEC_MAX_REP; ++r) {
            if (r < rep) {
                const float m_new = fmaxf(m_s[r], c_s[r]);
                const float alpha = __expf(m_s[r] - m_new);
                const float e_cur = __expf(c_s[r] - m_new);
                const float o = (acc[r][e] * alpha + e_cur * vv) / (l_s[r] * alpha + e_cur);
                out[((size_t)b * H + hk * rep + r) * Dv + d] = from_f32<T>(o);
            }
        }
    }
}

// q [B, H, Dk]; k_stack/v_stack [L, B, S, Hkv, D] (layer il is read in
// place); kc/vc [B, Hkv, D]; seq_len [B] int32; out [B, H, Dv]. All of the
// element type `dtype`, contiguous.
LCG_EXPORT int lcg_flash_decode_dense(int dtype, const void* q, const void* k_stack,
                                      const void* v_stack, int il, int B, int S, int H,
                                      int Hkv, int Dk, int Dv, const void* kc, const void* vc,
                                      const int* seq_len, void* out, int s_eff, float scale,
                                      float softcap, int window, void* stream) {
    if (Hkv < 1 || H % Hkv || H / Hkv > DEC_MAX_REP || Dk > DEC_MAX_D || Dv > DEC_MAX_D ||
        Dk % 8 || s_eff > S)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t k_layer = (size_t)il * B * S * Hkv * Dk;
    const size_t v_layer = (size_t)il * B * S * Hkv * Dv;
    const dim3 grid(Hkv, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DT_BF16) {
        using T = __nv_bfloat16;
        flash_decode_dense_kernel<T><<<grid, DEC_TS, 0, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_stack) + k_layer,
            static_cast<const T*>(v_stack) + v_layer, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, H, Hkv, Dk, Dv,
            s_eff, scale, softcap, window);
    } else {
        using T = float;
        flash_decode_dense_kernel<T><<<grid, DEC_TS, 0, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_stack) + k_layer,
            static_cast<const T*>(v_stack) + v_layer, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, H, Hkv, Dk, Dv,
            s_eff, scale, softcap, window);
    }
    return static_cast<int>(cudaGetLastError());
}

// flash_prefill — attention of a T-token block over the old cache plus the
// causal current block.
//
// Replaces llamacog_tpu/ops/pallas/flash_prefill.py::flash_prefill_attention
// (_kernel): q [B, T, H, Dk] attends to the old cache k/v [B, S, Hkv, D]
// (positions below seq_len, the write offset) and then to the block's own
// k_cur/v_cur [B, T, Hkv, D] causally, with softcap and sliding window.
// Query row r of kv head h is token r / rep, query head h*rep + r % rep
// (GQA rows T*rep, as the Pallas kernel). Out [B, T, H, Dv].
//
// Bound on this card: operations at long blocks and deep caches (4 flops
// per query row, key and head dimension), bytes otherwise. Design: one
// block per (query-row tile of PF_BR rows, kv head, batch row) streams the
// old K/V prefix in tiles of PF_BC positions through shared memory —
// reading [B, S, Hkv, D] by stride, without the head-major transposes of
// the TPU version — and then the current block, with an online softmax in
// f32. Any S is taken (the Pallas kernel's S % 512 rule is a TPU tiling
// rule). Scores and the PV product are f32 FMAs from shared memory: tensor
// cores are later work.
#include "common.cuh"

constexpr int PF_BR = 32;        // query rows per block
constexpr int PF_BC = 32;        // key positions per tile
constexpr int PF_THREADS = 128;  // 4 threads per query row
constexpr int PF_MAX_D = 256;
constexpr int PF_ACC = PF_MAX_D / 4;

template <typename T>
__global__ void __launch_bounds__(PF_THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                     const T* __restrict__ kc, const T* __restrict__ vc,
                     const int* __restrict__ seq_len, T* __restrict__ out, int T_, int H,
                     int Hkv, int Dk, int Dv, int s_eff, float scale, float softcap,
                     int window) {
    extern __shared__ float sm[];
    const int ldq = Dk + 1, ldv = Dv + 1;
    float* Qs = sm;                       // [PF_BR][Dk+1]
    float* Ks = Qs + PF_BR * ldq;         // [PF_BC][Dk+1]
    float* Vs = Ks + PF_BC * ldq;         // [PF_BC][Dv+1]
    float* Ps = Vs + PF_BC * ldv;         // [PF_BR][PF_BC+1]

    const int hk = blockIdx.y, b = blockIdx.z;
    const int rep = H / Hkv;
    const int R = T_ * rep;
    const int r0 = blockIdx.x * PF_BR;
    const int tid = threadIdx.x;
    const int i = tid >> 2, cg = tid & 3;  // query row in tile, column group
    const int n = seq_len[b];
    const int n_old = min(n, s_eff);

    const int r = r0 + i;
    const bool row_ok = r < R;
    const int t_row = row_ok ? r / rep : 0;
    const int pos_q = n + t_row;

    for (int idx = tid; idx < PF_BR * Dk; idx += PF_THREADS) {
        const int ii = idx / Dk, d = idx % Dk;
        const int rr = r0 + ii;
        float val = 0.f;
        if (rr < R) {
            const int t = rr / rep, h = hk * rep + rr % rep;
            val = to_f32(q[(((size_t)b * T_ + t) * H + h) * Dk + d]);
        }
        Qs[ii * ldq + d] = val;
    }

    float m_i = MASKED, l_i = 0.f;
    float acc[PF_ACC];
#pragma unroll
    for (int e = 0; e < PF_ACC; ++e) acc[e] = 0.f;

    // phase 0: old cache positions [0, n_old); phase 1: the current block
    const int t_last = min(T_ - 1, (min(r0 + PF_BR, R) - 1) / rep);
    for (int phase = 0; phase < 2; ++phase) {
        const int len = phase == 0 ? n_old : t_last + 1;
        for (int c0 = 0; c0 < len; c0 += PF_BC) {
            __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
            for (int idx = tid; idx < PF_BC * Dk; idx += PF_THREADS) {
                const int c = idx / Dk, d = idx % Dk;
                const int pos = c0 + c;
                float val = 0.f;
                if (pos < len)
                    val = phase == 0
                        ? to_f32(k[(size_t)b * k_sb + (size_t)pos * k_ss + (size_t)hk * Dk + d])
                        : to_f32(kc[(((size_t)b * T_ + pos) * Hkv + hk) * Dk + d]);
                Ks[c * ldq + d] = val;
            }
            for (int idx = tid; idx < PF_BC * Dv; idx += PF_THREADS) {
                const int c = idx / Dv, d = idx % Dv;
                const int pos = c0 + c;
                float val = 0.f;
                if (pos < len)
                    val = phase == 0
                        ? to_f32(v[(size_t)b * v_sb + (size_t)pos * v_ss + (size_t)hk * Dv + d])
                        : to_f32(vc[(((size_t)b * T_ + pos) * Hkv + hk) * Dv + d]);
                Vs[c * ldv + d] = val;
            }
            __syncthreads();
            // scores: thread (i, cg) owns columns cg + 4u
            float s[PF_BC / 4];
            float mx = MASKED;
#pragma unroll
            for (int u = 0; u < PF_BC / 4; ++u) {
                const int c = cg + 4 * u;
                const int pos = c0 + c;
                bool ok = row_ok && pos < len;
                if (phase == 0) {
                    if (window > 0) ok = ok && pos > pos_q - window;
                } else {
                    ok = ok && pos <= t_row;
                    if (window > 0) ok = ok && pos > t_row - window;
                }
                float acc_s = 0.f;
                if (ok) {
                    const float* qr = Qs + i * ldq;
                    const float* kr = Ks + c * ldq;
                    for (int d = 0; d < Dk; ++d) acc_s = fmaf(qr[d], kr[d], acc_s);
                    acc_s = softcap_score(acc_s * scale, softcap);
                } else {
                    acc_s = MASKED;
                }
                s[u] = acc_s;
                mx = fmaxf(mx, acc_s);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_i, mx);
            const float alpha = __expf(m_i - m_new);
            float psum = 0.f;
#pragma unroll
            for (int u = 0; u < PF_BC / 4; ++u) {
                const float p = s[u] > 0.5f * MASKED ? __expf(s[u] - m_new) : 0.f;
                Ps[i * (PF_BC + 1) + cg + 4 * u] = p;
                psum += p;
            }
            psum += __shfl_xor_sync(0xffffffffu, psum, 1);
            psum += __shfl_xor_sync(0xffffffffu, psum, 2);
            l_i = l_i * alpha + psum;
            m_i = m_new;
            __syncwarp();  // the row's four threads share Ps row i
            const int cnt = min(PF_BC, len - c0);
#pragma unroll
            for (int e = 0; e < PF_ACC; ++e) {
                const int d = cg + 4 * e;
                if (d < Dv) {
                    float a = acc[e] * alpha;
                    for (int c = 0; c < cnt; ++c)
                        a = fmaf(Ps[i * (PF_BC + 1) + c], Vs[c * ldv + d], a);
                    acc[e] = a;
                }
            }
        }
    }
    if (row_ok) {
        const int h = hk * rep + r % rep;
        const float inv = 1.f / fmaxf(l_i, 1e-30f);
        T* o = out + (((size_t)b * T_ + t_row) * H + h) * Dv;
#pragma unroll
        for (int e = 0; e < PF_ACC; ++e) {
            const int d = cg + 4 * e;
            if (d < Dv) o[d] = from_f32<T>(acc[e] * inv);
        }
    }
}

// q [B, T, H, Dk] and kc/vc [B, T, Hkv, D] contiguous; k/v [B, S, Hkv, D]
// with batch stride k_sb/v_sb and position stride k_ss/v_ss (elements; the
// head and dimension axes contiguous); seq_len [B] int32; out [B, T, H, Dv].
LCG_EXPORT int lcg_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                 long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                                 const void* kc, const void* vc, const int* seq_len, void* out,
                                 int B, int T_, int H, int Hkv, int Dk, int Dv, int s_eff,
                                 float scale, float softcap, int window, void* stream) {
    if (Hkv < 1 || H % Hkv || Dk > PF_MAX_D || Dv > PF_MAX_D || T_ < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) *
        ((size_t)PF_BR * (Dk + 1) + (size_t)PF_BC * (Dk + 1) + (size_t)PF_BC * (Dv + 1) +
         (size_t)PF_BR * (PF_BC + 1));
    const int R = T_ * (H / Hkv);
    const dim3 grid((R + PF_BR - 1) / PF_BR, Hkv, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == DT_BF16) {
        using T = __nv_bfloat16;
        err = cudaFuncSetAttribute(flash_prefill_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_prefill_kernel<T><<<grid, PF_THREADS, smem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), k_sb,
            k_ss, v_sb, v_ss, static_cast<const T*>(kc), static_cast<const T*>(vc), seq_len,
            static_cast<T*>(out), T_, H, Hkv, Dk, Dv, s_eff, scale, softcap, window);
    } else {
        using T = float;
        err = cudaFuncSetAttribute(flash_prefill_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_prefill_kernel<T><<<grid, PF_THREADS, smem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), k_sb,
            k_ss, v_sb, v_ss, static_cast<const T*>(kc), static_cast<const T*>(vc), seq_len,
            static_cast<T*>(out), T_, H, Hkv, Dk, Dv, s_eff, scale, softcap, window);
    }
    return static_cast<int>(cudaGetLastError());
}

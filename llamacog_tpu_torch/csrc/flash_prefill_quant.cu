// flash_prefill_quant — attention of a T-token block over the quantized old
// cache plus the causal current block.
//
// Replaces llamacog_tpu/ops/pallas/flash_q8.py::flash_prefill_q8
// (_prefill_kernel): q [B, T, H, Dk] (natural order) attends to one layer of
// the quantized K and V planes [B, S, Hkv*W] (runtime/kv_cache.py; K and V
// kinds independent), positions below seq_len (the write offset) and kv_cap,
// and then to the block's own k_cur/v_cur [B, T, Hkv, D] causally, with
// softcap and sliding window. Query row r of kv head h is token r / rep,
// query head h*rep + r % rep (GQA rows T*rep, as the Pallas kernel). Out
// [B, T, H, Dv] in natural order.
//
// Bound on this card: operations at long blocks and deep caches (4 flops
// per query row, key and head dimension), bytes otherwise. Design: that of
// flash_prefill.cu — one block per (query-row tile of PQ_BR rows, kv head,
// batch row) streams the old cache in tiles of PQ_BC positions through
// shared memory and then the current block, with an online softmax in f32 —
// except that each old-cache tile is read in place from the planes and
// dequantized (common.cuh's kv_deq1, bit-exact against kv_dequant_planes)
// straight to its natural head-dim column in shared memory, so nothing is
// permuted or transposed outside the kernel (the Pallas version unflattens,
// transposes and permutes q, the planes and the output with XLA ops). The
// kind is a launch argument switched on once per tile load (KV_DISPATCH).
// Scores and the PV product are f32 FMAs from shared memory: tensor cores
// are later work.
#include "common.cuh"

constexpr int PQ_BR = 32;        // query rows per block
constexpr int PQ_BC = 32;        // key positions per tile
constexpr int PQ_THREADS = 128;  // 4 threads per query row
constexpr int PQ_MAX_D = 256;
constexpr int PQ_ACC = PQ_MAX_D / 4;

// Old-cache positions [p0, p0 + PQ_BC) of one head -> dst[pos - p0][natural
// column] (row pitch ld); positions >= len read as 0.
template <int KIND>
__device__ __forceinline__ void load_tile(float* dst, int ld, const KVPlanes& p, size_t row0,
                                          int Hkv, int p0, int len, int D, int tid) {
    const int G = D / KV_GS;
    for (int idx = tid; idx < PQ_BC * D; idx += PQ_THREADS) {
        const int i = idx / D, c = idx % D;
        const int pos = p0 + i;
        float val = 0.f;
        if (pos < len) val = kv_deq1<KIND>(kv_row<KIND>(p, row0 + (size_t)pos * Hkv, D, G), c, D, G);
        dst[i * ld + kv_nat(c, G)] = val;
    }
}

// The current block's positions [p0, p0 + PQ_BC) of one head (natural
// order, [B, T, Hkv, D]) -> dst; positions >= len read as 0.
template <typename T>
__device__ __forceinline__ void load_cur_tile(float* dst, int ld, const T* cur, int b, int T_,
                                              int Hkv, int hk, int p0, int len, int D, int tid) {
    for (int idx = tid; idx < PQ_BC * D; idx += PQ_THREADS) {
        const int i = idx / D, d = idx % D;
        const int pos = p0 + i;
        dst[i * ld + d] =
            pos < len ? to_f32(cur[(((size_t)b * T_ + pos) * Hkv + hk) * D + d]) : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(PQ_THREADS)
flash_prefill_quant_kernel(const T* __restrict__ q, KVPlanes kp, KVPlanes vp, int kind_k,
                           int kind_v, const T* __restrict__ kc, const T* __restrict__ vc,
                           const int* __restrict__ seq_len, T* __restrict__ out, int S, int T_,
                           int H, int Hkv, int Dk, int Dv, int s_eff, float scale,
                           float softcap, int window) {
    extern __shared__ float sm[];
    const int ldq = Dk + 1, ldv = Dv + 1;
    float* Qs = sm;                       // [PQ_BR][Dk+1]
    float* Ks = Qs + PQ_BR * ldq;         // [PQ_BC][Dk+1]
    float* Vs = Ks + PQ_BC * ldq;         // [PQ_BC][Dv+1]
    float* Ps = Vs + PQ_BC * ldv;         // [PQ_BR][PQ_BC+1]

    const int hk = blockIdx.y, b = blockIdx.z;
    const int rep = H / Hkv;
    const int R = T_ * rep;
    const int r0 = blockIdx.x * PQ_BR;
    const int tid = threadIdx.x;
    const int i = tid >> 2, cg = tid & 3;  // query row in tile, column group
    const int n = seq_len[b];
    const int n_old = min(n, s_eff);
    const size_t row0 = (size_t)b * S * Hkv + hk;  // plane row of (b, position 0, hk)

    const int r = r0 + i;
    const bool row_ok = r < R;
    const int t_row = row_ok ? r / rep : 0;
    const int pos_q = n + t_row;

    for (int idx = tid; idx < PQ_BR * Dk; idx += PQ_THREADS) {
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
    float acc[PQ_ACC];
#pragma unroll
    for (int e = 0; e < PQ_ACC; ++e) acc[e] = 0.f;

    // phase 0: old cache positions [0, n_old); phase 1: the current block
    const int t_last = min(T_ - 1, (min(r0 + PQ_BR, R) - 1) / rep);
    for (int phase = 0; phase < 2; ++phase) {
        const int len = phase == 0 ? n_old : t_last + 1;
        for (int c0 = 0; c0 < len; c0 += PQ_BC) {
            __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
            if (phase == 0) {
                KV_DISPATCH(kind_k, load_tile, Ks, ldq, kp, row0, Hkv, c0, len, Dk, tid)
                KV_DISPATCH(kind_v, load_tile, Vs, ldv, vp, row0, Hkv, c0, len, Dv, tid)
            } else {
                load_cur_tile(Ks, ldq, kc, b, T_, Hkv, hk, c0, len, Dk, tid);
                load_cur_tile(Vs, ldv, vc, b, T_, Hkv, hk, c0, len, Dv, tid);
            }
            __syncthreads();
            // scores: thread (i, cg) owns columns cg + 4u
            float s[PQ_BC / 4];
            float mx = MASKED;
#pragma unroll
            for (int u = 0; u < PQ_BC / 4; ++u) {
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
            for (int u = 0; u < PQ_BC / 4; ++u) {
                const float p = s[u] > 0.5f * MASKED ? __expf(s[u] - m_new) : 0.f;
                Ps[i * (PQ_BC + 1) + cg + 4 * u] = p;
                psum += p;
            }
            psum += __shfl_xor_sync(0xffffffffu, psum, 1);
            psum += __shfl_xor_sync(0xffffffffu, psum, 2);
            l_i = l_i * alpha + psum;
            m_i = m_new;
            __syncwarp();  // the row's four threads share Ps row i
            const int cnt = min(PQ_BC, len - c0);
#pragma unroll
            for (int e = 0; e < PQ_ACC; ++e) {
                const int d = cg + 4 * e;
                if (d < Dv) {
                    float a = acc[e] * alpha;
                    for (int c = 0; c < cnt; ++c)
                        a = fmaf(Ps[i * (PQ_BC + 1) + c], Vs[c * ldv + d], a);
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
        for (int e = 0; e < PQ_ACC; ++e) {
            const int d = cg + 4 * e;
            if (d < Dv) o[d] = from_f32<T>(acc[e] * inv);
        }
    }
}

// q [B, T, H, Dk] and kc/vc [B, T, Hkv, D] contiguous, of the element type
// `dtype`; K and V planes of one layer, each [B, S, Hkv*W] contiguous (m/h
// null where the kind has none); seq_len [B] int32; s_eff the attended
// bound (<= S); out [B, T, H, Dv].
LCG_EXPORT int lcg_flash_prefill_quant(int dtype, int kind_k, int kind_v, const void* q,
                                       const void* kq, const void* ks, const void* km,
                                       const void* kh, const void* vq, const void* vs,
                                       const void* vm, const void* vh, int B, int S, int T_,
                                       int H, int Hkv, int Dk, int Dv, const void* kc,
                                       const void* vc, const int* seq_len, void* out,
                                       int s_eff, float scale, float softcap, int window,
                                       void* stream) {
    if (Hkv < 1 || H % Hkv || Dk > PQ_MAX_D || Dv > PQ_MAX_D || Dk % KV_GS || Dv % KV_GS ||
        T_ < 1 || s_eff > S || !kv_kind_ok(kind_k) || !kv_kind_ok(kind_v))
        return static_cast<int>(cudaErrorInvalidValue);
    const KVPlanes kp{kq, static_cast<const float*>(ks), static_cast<const float*>(km),
                      static_cast<const int*>(kh)};
    const KVPlanes vp{vq, static_cast<const float*>(vs), static_cast<const float*>(vm),
                      static_cast<const int*>(vh)};
    const size_t smem = sizeof(float) *
        ((size_t)PQ_BR * (Dk + 1) + (size_t)PQ_BC * (Dk + 1) + (size_t)PQ_BC * (Dv + 1) +
         (size_t)PQ_BR * (PQ_BC + 1));
    const int R = T_ * (H / Hkv);
    const dim3 grid((R + PQ_BR - 1) / PQ_BR, Hkv, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == DT_BF16) {
        using T = __nv_bfloat16;
        err = cudaFuncSetAttribute(flash_prefill_quant_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_prefill_quant_kernel<T><<<grid, PQ_THREADS, smem, st>>>(
            static_cast<const T*>(q), kp, vp, kind_k, kind_v, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, T_, H, Hkv, Dk, Dv,
            s_eff, scale, softcap, window);
    } else {
        using T = float;
        err = cudaFuncSetAttribute(flash_prefill_quant_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_prefill_quant_kernel<T><<<grid, PQ_THREADS, smem, st>>>(
            static_cast<const T*>(q), kp, vp, kind_k, kind_v, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, T_, H, Hkv, Dk, Dv,
            s_eff, scale, softcap, window);
    }
    return static_cast<int>(cudaGetLastError());
}

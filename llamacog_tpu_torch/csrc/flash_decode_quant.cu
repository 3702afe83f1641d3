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
// the S-tiled Pallas variants are one kernel here: the tile loop below.
//
// Bound on this card: bytes — every plane byte of the attended prefix is
// read once (q8_0 about half of a bf16 cache, q4_0 about a third) for a few
// flops per byte. Design: as flash_decode_dense.cu, one block per (kv head,
// batch row) serves the kv head's `rep` query heads, so each K/V row is read
// once for all of them; thread j scores position j with 8-byte loads of its
// K row, thread d accumulates stored V column d. Each element is
// dequantized by common.cuh's kv_deq (bit-exact against kv_dequant_planes)
// straight to its place: q is staged in shared memory in K's group-strided
// column order and the output is written back to natural order by index, so
// q, k_cur, v_cur and the output need no permute outside the kernel. The
// kind is a launch argument, switched on once per tile (KV_DISPATCH),
// uniform across the launch: one instantiation per activation type instead
// of 49 kind pairs. At B = 1, Hkv = 8 this is 8 blocks on 132 SMs:
// splitting S across blocks (flash-decoding) is later work.
#include "common.cuh"

constexpr int DQ_TS = 128;        // positions per tile = threads per block
constexpr int DQ_MAX_REP = 16;    // query heads per kv head
constexpr int DQ_MAX_D = 256;
constexpr int DQ_DPT = DQ_MAX_D / DQ_TS;  // stored V columns per thread

// s[r] += q_r . k_row for the rep query heads (qs in K's stored order).
template <int KIND>
__device__ __forceinline__ void score_row(const KVPlanes& kp, size_t row, int D, int G,
                                          const float* qs, int rep, float (&s)[DQ_MAX_REP]) {
    const KVRow kr = kv_row<KIND>(kp, row, D, G);
#pragma unroll 2
    for (int c0 = 0; c0 < D; c0 += 8) {
        float kv8[8];
        kv_deq8<KIND>(kr, c0, D, G, kv8);
#pragma unroll
        for (int r = 0; r < DQ_MAX_REP; ++r) {
            if (r < rep) {
                const float* qr = qs + r * DQ_MAX_D + c0;
#pragma unroll
                for (int e = 0; e < 8; ++e) s[r] = fmaf(qr[e], kv8[e], s[r]);
            }
        }
    }
}

// acc[r][e] = acc[r][e] * alpha_r + sum_j p_rj * v_j[c_e] over the tile's
// cnt positions, for this thread's stored V columns c_e = tid + e * DQ_TS.
template <int KIND>
__device__ __forceinline__ void accum_v(const KVPlanes& vp, size_t row0, size_t row_step, int cnt,
                                        int D, int G, int tid, const float* ps,
                                        const float* a_s, int rep,
                                        float (&acc)[DQ_MAX_REP][DQ_DPT]) {
#pragma unroll
    for (int e = 0; e < DQ_DPT; ++e) {
        const int c = tid + e * DQ_TS;
        if (c >= D) continue;
#pragma unroll
        for (int r = 0; r < DQ_MAX_REP; ++r)
            if (r < rep) acc[r][e] *= a_s[r];
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
            const float vv = kv_deq1<KIND>(kv_row<KIND>(vp, row0 + j * row_step, D, G), c, D, G);
#pragma unroll
            for (int r = 0; r < DQ_MAX_REP; ++r)
                if (r < rep) acc[r][e] = fmaf(ps[r * DQ_TS + j], vv, acc[r][e]);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(DQ_TS)
flash_decode_quant_kernel(const T* __restrict__ q, KVPlanes kp, KVPlanes vp, int kind_k,
                          int kind_v, const T* __restrict__ kc, const T* __restrict__ vc,
                          const int* __restrict__ seq_len, T* __restrict__ out, int S, int H,
                          int Hkv, int Dk, int Dv, int s_eff, float scale, float softcap,
                          int window) {
    __shared__ float qs[DQ_MAX_REP * DQ_MAX_D];  // q in K's stored column order
    __shared__ float ps[DQ_MAX_REP * DQ_TS];
    __shared__ float m_s[DQ_MAX_REP], l_s[DQ_MAX_REP], a_s[DQ_MAX_REP], c_s[DQ_MAX_REP];

    const int hk = blockIdx.x, b = blockIdx.y;
    const int rep = H / Hkv;
    const int Gk = Dk / KV_GS, Gv = Dv / KV_GS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = seq_len[b];
    const int n_end = min(n, s_eff);
    const size_t row0 = (size_t)b * S * Hkv + hk;  // row of (b, position 0, hk)

    for (int i = tid; i < rep * Dk; i += DQ_TS) {
        const int r = i / Dk, c = i % Dk;
        qs[r * DQ_MAX_D + c] = to_f32(q[((size_t)b * H + hk * rep + r) * Dk + kv_nat(c, Gk)]);
    }
    if (tid < DQ_MAX_REP) {
        m_s[tid] = MASKED;
        l_s[tid] = 0.f;
    }
    float acc[DQ_MAX_REP][DQ_DPT];
#pragma unroll
    for (int r = 0; r < DQ_MAX_REP; ++r)
#pragma unroll
        for (int e = 0; e < DQ_DPT; ++e) acc[r][e] = 0.f;
    __syncthreads();

    for (int t0 = 0; t0 < n_end; t0 += DQ_TS) {
        const int pos = t0 + tid;
        const bool valid = pos < n_end && (window <= 0 || pos > n - window);
        float s[DQ_MAX_REP];
#pragma unroll
        for (int r = 0; r < DQ_MAX_REP; ++r) s[r] = 0.f;
        if (valid) {
            const size_t row = row0 + (size_t)pos * Hkv;
            KV_DISPATCH(kind_k, score_row, kp, row, Dk, Gk, qs, rep, s)
        }
#pragma unroll
        for (int r = 0; r < DQ_MAX_REP; ++r)
            if (r < rep) ps[r * DQ_TS + tid] = valid ? softcap_score(s[r] * scale, softcap) : MASKED;
        __syncthreads();
        // per-head tile statistics: warp w reduces heads w, w+4, ...
        for (int r = warp; r < rep; r += DQ_TS / 32) {
            float sv[DQ_TS / 32];
            float mx = MASKED;
#pragma unroll
            for (int i = 0; i < DQ_TS / 32; ++i) {
                sv[i] = ps[r * DQ_TS + lane + 32 * i];
                mx = fmaxf(mx, sv[i]);
            }
            mx = warp_max(mx);
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < DQ_TS / 32; ++i) {
                const float p = sv[i] > 0.5f * MASKED ? __expf(sv[i] - m_new) : 0.f;
                ps[r * DQ_TS + lane + 32 * i] = p;
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
        const int cnt = min(DQ_TS, n_end - t0);
        const size_t vrow0 = row0 + (size_t)t0 * Hkv;
        KV_DISPATCH(kind_v, accum_v, vp, vrow0, (size_t)Hkv, cnt, Dv, Gv, tid, ps, a_s, rep, acc)
        __syncthreads();
    }

    // the current step's key/value (natural order), always attended
    const T* kcur = kc + ((size_t)b * Hkv + hk) * Dk;
    const T* vcur = vc + ((size_t)b * Hkv + hk) * Dv;
    for (int r = warp; r < rep; r += DQ_TS / 32) {
        float s = 0.f;
        for (int c = lane; c < Dk; c += 32)
            s = fmaf(qs[r * DQ_MAX_D + c], to_f32(kcur[kv_nat(c, Gk)]), s);
        s = warp_sum(s);
        if (lane == 0) c_s[r] = softcap_score(s * scale, softcap);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < DQ_DPT; ++e) {
        const int c = tid + e * DQ_TS;
        if (c >= Dv) continue;
        const int d = kv_nat(c, Gv);  // this thread's stored V column, in natural order
        const float vv = to_f32(vcur[d]);
#pragma unroll
        for (int r = 0; r < DQ_MAX_REP; ++r) {
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

// q [B, H, Dk], kc/vc [B, Hkv, D], out [B, H, Dv]: contiguous, of the
// element type `dtype`. K and V planes of one layer, each [B, S, Hkv*W]
// contiguous (m/h null where the kind has none); seq_len [B] int32; s_eff
// the attended bound (<= S).
LCG_EXPORT int lcg_flash_decode_quant(int dtype, int kind_k, int kind_v, const void* q,
                                      const void* kq, const void* ks, const void* km,
                                      const void* kh, const void* vq, const void* vs,
                                      const void* vm, const void* vh, int B, int S, int H,
                                      int Hkv, int Dk, int Dv, const void* kc, const void* vc,
                                      const int* seq_len, void* out, int s_eff, float scale,
                                      float softcap, int window, void* stream) {
    if (Hkv < 1 || H % Hkv || H / Hkv > DQ_MAX_REP || Dk > DQ_MAX_D || Dv > DQ_MAX_D ||
        Dk % KV_GS || Dv % KV_GS || s_eff > S || !kv_kind_ok(kind_k) || !kv_kind_ok(kind_v))
        return static_cast<int>(cudaErrorInvalidValue);
    const KVPlanes kp{kq, static_cast<const float*>(ks), static_cast<const float*>(km),
                      static_cast<const int*>(kh)};
    const KVPlanes vp{vq, static_cast<const float*>(vs), static_cast<const float*>(vm),
                      static_cast<const int*>(vh)};
    const dim3 grid(Hkv, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == DT_BF16) {
        using T = __nv_bfloat16;
        flash_decode_quant_kernel<T><<<grid, DQ_TS, 0, st>>>(
            static_cast<const T*>(q), kp, vp, kind_k, kind_v, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, H, Hkv, Dk, Dv, s_eff,
            scale, softcap, window);
    } else {
        using T = float;
        flash_decode_quant_kernel<T><<<grid, DQ_TS, 0, st>>>(
            static_cast<const T*>(q), kp, vp, kind_k, kind_v, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, H, Hkv, Dk, Dv, s_eff,
            scale, softcap, window);
    }
    return static_cast<int>(cudaGetLastError());
}

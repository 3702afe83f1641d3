// flash_prefill — attention of a T-token block over the old cache plus the
// causal current block.
//
// Replaces llamacog_tpu/ops/pallas/flash_prefill.py::flash_prefill_attention
// (_kernel): q [B, T, H, Dk] attends to the old cache k/v [B, S, Hkv, D]
// (positions below min(seq_len, s_eff), the write offset) and then to the
// block's own k_cur/v_cur [B, T, Hkv, D] causally, with softcap and sliding
// window. Query row r of kv head h is token r / rep, query head
// h*rep + r % rep (GQA rows T*rep, as the Pallas kernel). Out [B, T, H, Dv].
//
// Bound on this card: operations at long blocks and deep caches (4 flops
// per query row, key and head dimension), bytes otherwise; a 512-token
// prefill of the 8B model is ~2.1 GFLOP a layer. The first version of
// this kernel computed scores and PV as f32 FMAs from shared memory, with
// element-wise K/V loads: 1.39 ms at T=512 (H100 80GB HBM3, 700 W).
//
// Design, bf16 (what the Engine runs): the tile loop of flash_attn_tile.cuh
// on tensor cores — one block per (tile of 16*NW GQA rows, kv head, batch
// row), Q fragments in registers, S and PV by mma.sync m16n8k16, K/V tiles
// of 64 positions double-buffered by cp.async 16-byte copies that read the
// old cache by its batch and position strides (a kv_cap slice of a stacked
// layer needs no copy) and then k_cur/v_cur through the same loop. NW is 4
// when 64-row tiles fill the card's 132 SMs, else 2 (T=128: 128 blocks);
// above head dim 128 it is always 2. The mask runs only on tiles it can
// cut, as two bounds a row. Head dims Dk == Dv, any multiple of 16 up to
// 256, and Dk = 192 with Dv = 128 (deepseek2); rows 16-byte aligned.
//
// The SIMT body below (one block per 32 query rows, f32 FMAs from shared
// memory, any Dk, Dv <= 256) takes f32 — the exact path of the -m cuda
// tests at 1e-5 — and, in bf16, exactly the calls the tiles do not take:
// head dims outside the tile list (8, 40, 72, ...) and rows that are not
// 16-byte aligned. The C entry picks the route from the dtype, the head
// dims and the alignment, before any launch; nothing is tried and retried.
//
// Measured (tools/attn_compare.py, 8B heads, bf16, device time alone — the
// card held busy past the host's enqueue; NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6): T=128 at write offset 0 0.0144 ms (SDPA 0.0236), at 896
// 0.0408 (SDPA 0.0446), T=512 at 0 0.0332 (SDPA 0.0359), against
// 0.22-1.47 ms for the first version at the same shapes in the same run.
#include "flash_attn_tile.cuh"

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile loop over the dense cache

// K/V tiles by cp.async: phase 0 from the old cache by stride, phase 1 from
// the current block.
struct DenseKVLoader {
    static constexpr bool LANDS = false;
    const bf16* k;      // old cache at (b, position 0, hk)
    const bf16* v;
    long long k_ss, v_ss;  // position strides (elements)
    const bf16* kc;     // current block at (b, token 0, hk)
    const bf16* vc;
    long long kc_ss, vc_ss;  // Hkv * Dk, Hkv * Dv

    template <int DK, int DV, int NT>
    __device__ __forceinline__ void load(bf16* ks, bf16* vs, int phase, int c0, int len, int,
                                         int tid) const {
        fa_copy_kv<DK, DV, NT>(ks, vs, phase == 0 ? k : kc, phase == 0 ? v : vc,
                               phase == 0 ? k_ss : kc_ss, phase == 0 ? v_ss : vc_ss, c0, len,
                               tid);
    }
};

template <int DK, int DV, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, long long k_sb, long long k_ss,
                         long long v_sb, long long v_ss, const bf16* __restrict__ kc,
                         const bf16* __restrict__ vc, const int* __restrict__ seq_len,
                         bf16* __restrict__ out, int T_, int H, int Hkv, int s_eff, float scale,
                         float softcap, int window) {
    const int hk = blockIdx.y, b = blockIdx.z;
    const int n = seq_len[b];
    const size_t cur = (size_t)b * T_ * Hkv + hk;  // (b, token 0, hk) in rows
    const DenseKVLoader ld{k + (size_t)b * k_sb + (size_t)hk * DK,
                           v + (size_t)b * v_sb + (size_t)hk * DV, k_ss, v_ss, kc + cur * DK,
                           vc + cur * DV, (long long)Hkv * DK, (long long)Hkv * DV};
    prefill_attn_tiles<DK, DV, NW>(ld, q, out, b, hk, T_, H, H / Hkv, n, min(n, s_eff), scale,
                                   softcap, window);
}

template <int DK, int DV, int NW>
static cudaError_t launch_mma(const void* q, const void* k, const void* v, long long k_sb,
                              long long k_ss, long long v_sb, long long v_ss, const void* kc,
                              const void* vc, const int* seq_len, void* out, int B, int T_,
                              int H, int Hkv, int s_eff, float scale, float softcap, int window,
                              cudaStream_t s) {
    static bool attr_set = false;  // once per instantiation, not per launch
    const size_t smem = fa_smem_bytes(DK, DV);
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_prefill_mma_kernel<DK, DV, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
        attr_set = true;
    }
    const int R = T_ * (H / Hkv);
    const dim3 grid((R + 16 * NW - 1) / (16 * NW), Hkv, B);
    flash_prefill_mma_kernel<DK, DV, NW><<<grid, 32 * NW, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        k_sb, k_ss, v_sb, v_ss, static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
        seq_len, static_cast<bf16*>(out), T_, H, Hkv, s_eff, scale, softcap, window);
    return cudaGetLastError();
}

template <int DK, int DV>
static cudaError_t launch_mma_d(const void* q, const void* k, const void* v, long long k_sb,
                                long long k_ss, long long v_sb, long long v_ss, const void* kc,
                                const void* vc, const int* seq_len, void* out, int B, int T_,
                                int H, int Hkv, int s_eff, float scale, float softcap,
                                int window, cudaStream_t s) {
    // 4 warps (64 rows) a block once that gives a wave on 132 SMs, else 2;
    // above head dim 128 always 2 (one instantiation a width)
    if constexpr (DK <= 128 && DV <= 128) {
        const long long blocks4 = (long long)((T_ * (H / Hkv) + 63) / 64) * Hkv * B;
        if (blocks4 >= 132)
            return launch_mma<DK, DV, 4>(q, k, v, k_sb, k_ss, v_sb, v_ss, kc, vc, seq_len, out,
                                         B, T_, H, Hkv, s_eff, scale, softcap, window, s);
    }
    return launch_mma<DK, DV, 2>(q, k, v, k_sb, k_ss, v_sb, v_ss, kc, vc, seq_len, out, B, T_,
                                 H, Hkv, s_eff, scale, softcap, window, s);
}

// ---------------------------------------------------------------------------
// f32, and bf16 outside the tiles: the SIMT body (T the element type;
// shared memory and arithmetic in f32)

constexpr int PF_BR = 32;        // query rows per block
constexpr int PF_BC = 32;        // key positions per tile
constexpr int PF_THREADS = 128;  // 4 threads per query row
constexpr int PF_MAX_D = 256;
constexpr int PF_ACC = PF_MAX_D / 4;

template <typename T>
__global__ void __launch_bounds__(PF_THREADS)
flash_prefill_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, long long k_sb, long long k_ss,
                          long long v_sb, long long v_ss, const T* __restrict__ kc,
                          const T* __restrict__ vc, const int* __restrict__ seq_len,
                          T* __restrict__ out, int T_, int H, int Hkv, int Dk, int Dv,
                          int s_eff, float scale, float softcap, int window) {
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
                    val = to_f32(phase == 0
                        ? k[(size_t)b * k_sb + (size_t)pos * k_ss + (size_t)hk * Dk + d]
                        : kc[(((size_t)b * T_ + pos) * Hkv + hk) * Dk + d]);
                Ks[c * ldq + d] = val;
            }
            for (int idx = tid; idx < PF_BC * Dv; idx += PF_THREADS) {
                const int c = idx / Dv, d = idx % Dv;
                const int pos = c0 + c;
                float val = 0.f;
                if (pos < len)
                    val = to_f32(phase == 0
                        ? v[(size_t)b * v_sb + (size_t)pos * v_ss + (size_t)hk * Dv + d]
                        : vc[(((size_t)b * T_ + pos) * Hkv + hk) * Dv + d]);
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

template <typename T>
static cudaError_t launch_simt(const void* q, const void* k, const void* v, long long k_sb,
                               long long k_ss, long long v_sb, long long v_ss, const void* kc,
                               const void* vc, const int* seq_len, void* out, int B, int T_,
                               int H, int Hkv, int Dk, int Dv, int s_eff, float scale,
                               float softcap, int window, cudaStream_t s) {
    static int attr_bytes = 0;  // the largest size set so far, per element type
    const size_t smem = sizeof(float) *
        ((size_t)PF_BR * (Dk + 1) + (size_t)PF_BC * (Dk + 1) + (size_t)PF_BC * (Dv + 1) +
         (size_t)PF_BR * (PF_BC + 1));
    if ((int)smem > attr_bytes) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_prefill_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        attr_bytes = (int)smem;
    }
    const int R = T_ * (H / Hkv);
    const dim3 grid((R + PF_BR - 1) / PF_BR, Hkv, B);
    flash_prefill_simt_kernel<T><<<grid, PF_THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), k_sb, k_ss,
        v_sb, v_ss, static_cast<const T*>(kc), static_cast<const T*>(vc), seq_len,
        static_cast<T*>(out), T_, H, Hkv, Dk, Dv, s_eff, scale, softcap, window);
    return cudaGetLastError();
}

// q [B, T, H, Dk] and kc/vc [B, T, Hkv, D] contiguous; k/v [B, S, Hkv, D]
// with batch stride k_sb/v_sb and position stride k_ss/v_ss (elements; the
// head and dimension axes contiguous); seq_len [B] int32; out [B, T, H, Dv].
// Any Dk, Dv <= 256 in both types. bf16 runs the tensor-core tiles where
// Dk == Dv is a multiple of 16 up to 256, or Dk = 192 with Dv = 128, and
// every row is 16-byte aligned; its other calls, and f32, run the SIMT body.
// *simt is set to 1 when the SIMT body is launched, 0 for the tiles (the
// wrapper counts the two bodies apart).
LCG_EXPORT int lcg_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                 long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                                 const void* kc, const void* vc, const int* seq_len, void* out,
                                 int B, int T_, int H, int Hkv, int Dk, int Dv, int s_eff,
                                 float scale, float softcap, int window, int* simt,
                                 void* stream) {
    if (Hkv < 1 || H % Hkv || Dk > PF_MAX_D || Dv > PF_MAX_D || T_ < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    *simt = 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(kc) |
                           reinterpret_cast<uintptr_t>(vc);
    const bool rows16 = ptrs % 16 == 0 && (k_ss | v_ss | k_sb | v_sb) % 8 == 0 &&
                        Dk % 8 == 0 && Dv % 8 == 0;
#define LCG_PREFILL_D(DK_, DV_)                                                              \
    if (Dk == DK_ && Dv == DV_)                                                              \
        return static_cast<int>(launch_mma_d<DK_, DV_>(q, k, v, k_sb, k_ss, v_sb, v_ss, kc,  \
                                                       vc, seq_len, out, B, T_, H, Hkv,      \
                                                       s_eff, scale, softcap, window, s));
    if (dtype == DT_BF16 && rows16) {
        LCG_PREFILL_D(16, 16) LCG_PREFILL_D(32, 32) LCG_PREFILL_D(48, 48) LCG_PREFILL_D(64, 64)
        LCG_PREFILL_D(80, 80) LCG_PREFILL_D(96, 96) LCG_PREFILL_D(112, 112)
        LCG_PREFILL_D(128, 128) LCG_PREFILL_D(144, 144) LCG_PREFILL_D(160, 160)
        LCG_PREFILL_D(176, 176) LCG_PREFILL_D(192, 192) LCG_PREFILL_D(208, 208)
        LCG_PREFILL_D(224, 224) LCG_PREFILL_D(240, 240) LCG_PREFILL_D(256, 256)
        LCG_PREFILL_D(192, 128)
    }
#undef LCG_PREFILL_D
    *simt = 1;
    if (dtype == DT_BF16)
        return static_cast<int>(launch_simt<__nv_bfloat16>(q, k, v, k_sb, k_ss, v_sb, v_ss, kc,
                                                           vc, seq_len, out, B, T_, H, Hkv, Dk,
                                                           Dv, s_eff, scale, softcap, window, s));
    return static_cast<int>(launch_simt<float>(q, k, v, k_sb, k_ss, v_sb, v_ss, kc, vc, seq_len,
                                               out, B, T_, H, Hkv, Dk, Dv, s_eff, scale, softcap,
                                               window, s));
}

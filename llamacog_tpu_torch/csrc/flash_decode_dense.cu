// flash_decode_dense — T=1 attention straight out of the stacked dense cache.
//
// Replaces llamacog_tpu/ops/pallas/flash_q8.py::_flash_decode_stacked_dense
// (_decode_flat_dense_kernel): q [B, H, Dk] against layer `il` of the
// stacked cache k/v [L, B, S, Hkv, D], each row stopping at
// min(seq_len[b], s_eff), with softcap and sliding window, and the current
// step's k_cur/v_cur [B, Hkv, D] folded in last (the deferred KV write: the
// cache holds only old tokens). Out [B, H, Dv] in the input type. The
// per-layer entry (K9, llamacog_tpu/ops/pallas/flash_decode.py) launches the
// same kernels on one layer.
//
// Bound on this card: bytes — every cached K and V row of the attended
// prefix is read once (2 * seq_len * Hkv * D elements per layer) for a few
// flops per byte. The first version of this kernel gave one block to each
// (kv head, batch row), 8 blocks on 132 SMs at B = 1, and read V one
// element per thread: 0.18 ms at depth 1000 (H100 80GB HBM3, 700 W).
//
// Design: split-S flash-decoding. The host picks n_split and split_len from
// s_eff (the kv_cap bucket, constant over a decode loop; never from the
// device seq_len, so a launch makes no host sync): about two waves of blocks
// (16 splits of 64 positions at s_eff 1024, 33 of 1008 at 32768 for the 8B
// heads). Grid (n_split, Hkv, B): each block walks its split's positions
// once, 8 warps side by side. A row group of lpr lanes reads a K and a V
// row with one 16-byte load a lane (8 elements; 16 lanes a row for D=128 in
// bf16), U rows a round; the rep query heads' scores are reduced by
// shuffles within the group, and one online-softmax step a round folds the
// U rows' P.V in, in f32 registers. The groups of a warp merge by shuffles,
// the warps in shared memory, and the split writes (o, m, l) to the
// workspace; the combine kernel of flash_split.cuh, launched from the same
// entry as a programmatic dependent launch, merges the splits and the
// current token. Splits past seq_len (or wholly before the window) exit at
// once. rep > 8 (RB = 16) spills registers.
//
// Measured (tools/attn_compare.py, 8B heads, bf16, device time alone — the
// card held busy past the host's enqueue; NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6): depth 1000 0.0188 ms (SDPA 0.0148; first version 0.1820 in
// the same run), depth 32765 0.0822 (49% of the 0.0401 ms bytes bound;
// SDPA 0.0661; first version 5.7334).
#include "flash_split.cuh"

constexpr int DS_WARPS = 8;
constexpr int DS_THREADS = 32 * DS_WARPS;
constexpr int DS_MAX_D = 256;
constexpr int DS_VEC = 8;  // elements a lane reads of a row
constexpr size_t DS_SMEM_MAX =
    sizeof(float) * DS_WARPS * SPLIT_MAX_REP * (DS_MAX_D + 2);

// 8 consecutive elements of one row, as loaded (16 bytes bf16, 32 bytes f32)
template <typename T>
struct RowChunk {
    uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ RowChunk<T> load_chunk(const T* p, bool ok) {
    RowChunk<T> c;
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
        c.w[i] = ok ? reinterpret_cast<const uint4*>(p)[i] : make_uint4(0u, 0u, 0u, 0u);
    return c;
}

template <typename T>
__device__ __forceinline__ void unpack_chunk(const RowChunk<T>& c, float* f) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            f[4 * i] = __uint_as_float(c.w[i].x);
            f[4 * i + 1] = __uint_as_float(c.w[i].y);
            f[4 * i + 2] = __uint_as_float(c.w[i].z);
            f[4 * i + 3] = __uint_as_float(c.w[i].w);
        }
    } else {
        const uint32_t w[4] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
            f[2 * i] = __low2float(h);
            f[2 * i + 1] = __high2float(h);
        }
    }
}

// One split of one (kv head, batch row): partial (o, m, l) of each of the
// rep <= RB query heads into the workspace. k/v point at the layer.
template <typename T, int RB>
__global__ void __launch_bounds__(DS_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ seq_len, float* __restrict__ ws, int S, int H,
                    int Hkv, int Dk, int Dv, int s_eff, int n_split, int split_len, float scale,
                    float softcap, int window) {
    constexpr int U = 2;  // rows a group reads per round
    extern __shared__ float red[];             // o [W][rep][Dv], m [W][rep], l [W][rep]
    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int rep = H / Hkv;
    const int n = seq_len[b];
    const int n_end = min(n, s_eff);
    const int lo = split_window_lo(n, window);
    split_launch_dependents();
    if (!split_live(sp, split_len, n_end, lo)) return;
    const int start = max(sp * split_len, lo);
    const int stop = min(sp * split_len + split_len, n_end);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int lpr = 1;  // lanes a row: a power of two covering the wider head dim
    while (lpr * DS_VEC < max(Dk, Dv)) lpr <<= 1;
    const int ch = lane & (lpr - 1), grp = lane / lpr, rpw = 32 / lpr;
    const bool k_on = ch * DS_VEC < Dk, v_on = ch * DS_VEC < Dv;
    const size_t krow = (size_t)Hkv * Dk, vrow = (size_t)Hkv * Dv;
    const T* kb = k + (size_t)b * S * krow + (size_t)hk * Dk + ch * DS_VEC;
    const T* vb = v + (size_t)b * S * vrow + (size_t)hk * Dv + ch * DS_VEC;

    float qv[RB][DS_VEC], acc[RB][DS_VEC], m[RB], l[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        const bool on = r < rep && k_on;
        const T* qp = q + ((size_t)b * H + hk * rep + min(r, rep - 1)) * Dk + ch * DS_VEC;
        unpack_chunk<T>(load_chunk<T>(qp, on), qv[r]);
        m[r] = MASKED;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < DS_VEC; ++e) acc[r][e] = 0.f;
    }

    const int step = DS_WARPS * rpw;  // positions the block covers a round
    for (int base = start + warp * rpw; base < stop; base += U * step) {
        RowChunk<T> kr[U], vr[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int pos = base + grp + u * step;
            ok[u] = pos < stop;
            kr[u] = load_chunk<T>(kb + (size_t)pos * krow, ok[u] && k_on);
            vr[u] = load_chunk<T>(vb + (size_t)pos * vrow, ok[u] && v_on);
        }
        // the U rows' scores for every head, reduced over the row's lanes
        float sc[U][RB], vf[U][DS_VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float kf[DS_VEC];
            unpack_chunk<T>(kr[u], kf);
            unpack_chunk<T>(vr[u], vf[u]);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                sc[u][r] = 0.f;
#pragma unroll
                for (int e = 0; e < DS_VEC; ++e) sc[u][r] = fmaf(qv[r][e], kf[e], sc[u][r]);
            }
        }
        for (int off = 1; off < lpr; off <<= 1)
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int r = 0; r < RB; ++r)
                    sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
        // one online-softmax step for the U rows: one rescale per head
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            float x[U];
            float m_new = m[r];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                x[u] = ok[u] ? softcap_score(sc[u][r] * scale, softcap) : MASKED;
                m_new = fmaxf(m_new, x[u]);
            }
            const float alpha = __expf(m[r] - m_new);
            float p[U], psum = 0.f;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                p[u] = ok[u] ? __expf(x[u] - m_new) : 0.f;
                psum += p[u];
            }
            l[r] = l[r] * alpha + psum;
#pragma unroll
            for (int e = 0; e < DS_VEC; ++e) {
                float a = acc[r][e] * alpha;
#pragma unroll
                for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
                acc[r][e] = a;
            }
            m[r] = m_new;
        }
    }

    // merge the row groups of the warp (lanes of one chunk, lpr apart); a
    // group that saw no position has m = MASKED, l = 0, acc = 0
    for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
            const float mn = fmaxf(m[r], mo);
            const float a = __expf(m[r] - mn), c = __expf(mo - mn);
            l[r] = l[r] * a + lo_ * c;
#pragma unroll
            for (int e = 0; e < DS_VEC; ++e)
                acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * c;
            m[r] = mn;
        }
    }
    float* red_o = red;
    float* red_m = red + DS_WARPS * rep * Dv;
    float* red_l = red_m + DS_WARPS * rep;
    if (grp == 0) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            if (r >= rep) break;
            if (v_on)
#pragma unroll
                for (int e = 0; e < DS_VEC; ++e)
                    red_o[(warp * rep + r) * Dv + ch * DS_VEC + e] = acc[r][e];
            if (ch == 0) {
                red_m[warp * rep + r] = m[r];
                red_l[warp * rep + r] = l[r];
            }
        }
    }
    __syncthreads();
    // merge the warps; the split is live, so some warp holds a real maximum
    const int ld = Dv + 2;
    float* wsp = ws + (((size_t)b * Hkv + hk) * n_split + sp) * rep * ld;
    for (int i = tid; i < rep * Dv; i += DS_THREADS) {
        const int r = i / Dv, d = i - r * Dv;
        float mt = MASKED;
#pragma unroll
        for (int w = 0; w < DS_WARPS; ++w) mt = fmaxf(mt, red_m[w * rep + r]);
        float o = 0.f, lt = 0.f;
#pragma unroll
        for (int w = 0; w < DS_WARPS; ++w) {
            const float mw = red_m[w * rep + r];
            const float wgt = mw > 0.5f * MASKED ? __expf(mw - mt) : 0.f;
            o += red_o[(w * rep + r) * Dv + d] * wgt;
            lt += red_l[w * rep + r] * wgt;
        }
        wsp[r * ld + d] = o;
        if (d == 0) {
            wsp[r * ld + Dv] = mt;
            wsp[r * ld + Dv + 1] = lt;
        }
    }
}

template <typename T, int RB>
static cudaError_t launch_split(const T* q, const T* k, const T* v, const int* seq_len,
                                float* ws, int B, int S, int H, int Hkv, int Dk, int Dv,
                                int s_eff, int n_split, int split_len, float scale,
                                float softcap, int window, cudaStream_t s) {
    static bool attr_set = false;  // once per instantiation, not per launch
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            decode_split_kernel<T, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)DS_SMEM_MAX);
        if (err != cudaSuccess) return err;
        attr_set = true;
    }
    const int rep = H / Hkv;
    const size_t smem = sizeof(float) * DS_WARPS * rep * (Dv + 2);
    decode_split_kernel<T, RB><<<dim3(n_split, Hkv, B), DS_THREADS, smem, s>>>(
        q, k, v, seq_len, ws, S, H, Hkv, Dk, Dv, s_eff, n_split, split_len, scale, softcap,
        window);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_decode(const void* q_, const void* k_stack, const void* v_stack,
                                 int il, int B, int S, int H, int Hkv, int Dk, int Dv,
                                 const void* kc, const void* vc, const int* seq_len, void* out,
                                 int s_eff, float scale, float softcap, int window, float* ws,
                                 int n_split, int split_len, cudaStream_t s) {
    const T* q = static_cast<const T*>(q_);
    const T* k = static_cast<const T*>(k_stack) + (size_t)il * B * S * Hkv * Dk;
    const T* v = static_cast<const T*>(v_stack) + (size_t)il * B * S * Hkv * Dv;
    const int rep = H / Hkv;
    cudaError_t err;
#define LCG_SPLIT(RB) launch_split<T, RB>(q, k, v, seq_len, ws, B, S, H, Hkv, Dk, Dv, s_eff, \
                                          n_split, split_len, scale, softcap, window, s)
    if (rep <= 1) err = LCG_SPLIT(1);
    else if (rep <= 2) err = LCG_SPLIT(2);
    else if (rep <= 4) err = LCG_SPLIT(4);
    else if (rep <= 8) err = LCG_SPLIT(8);
    else err = LCG_SPLIT(16);
#undef LCG_SPLIT
    if (err != cudaSuccess) return err;
    // the combine is a programmatic dependent launch: its blocks start
    // while the splits run and wait for them in griddepcontrol.wait
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rep, Hkv, B);
    cfg.blockDim = dim3(COMBINE_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, split_combine_kernel<T>, (const float*)ws, q,
                             static_cast<const T*>(kc), static_cast<const T*>(vc), seq_len,
                             static_cast<T*>(out), H, Hkv, Dk, Dv, s_eff, n_split, split_len,
                             scale, softcap, window);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// q [B, H, Dk]; k_stack/v_stack [L, B, S, Hkv, D] (layer il is read in
// place); kc/vc [B, Hkv, D]; seq_len [B] int32; out [B, H, Dv]. All of the
// element type `dtype`, contiguous, 16-byte aligned. ws: f32 workspace
// [B, Hkv, n_split, H / Hkv, Dv + 2]; n_split * split_len >= s_eff.
LCG_EXPORT int lcg_flash_decode_dense(int dtype, const void* q, const void* k_stack,
                                      const void* v_stack, int il, int B, int S, int H,
                                      int Hkv, int Dk, int Dv, const void* kc, const void* vc,
                                      const int* seq_len, void* out, int s_eff, float scale,
                                      float softcap, int window, void* ws, int n_split,
                                      int split_len, void* stream) {
    if (Hkv < 1 || H % Hkv || H / Hkv > SPLIT_MAX_REP || Dk > DS_MAX_D || Dv > DS_MAX_D ||
        Dk % DS_VEC || Dv % DS_VEC || s_eff > S || n_split < 1 || n_split > SPLIT_MAX ||
        split_len < 1 ||
        (long long)n_split * split_len < s_eff)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* w = static_cast<float*>(ws);
    const cudaError_t err =
        dtype == DT_BF16
            ? launch_decode<__nv_bfloat16>(q, k_stack, v_stack, il, B, S, H, Hkv, Dk, Dv, kc, vc,
                                           seq_len, out, s_eff, scale, softcap, window, w,
                                           n_split, split_len, s)
            : launch_decode<float>(q, k_stack, v_stack, il, B, S, H, Hkv, Dk, Dv, kc, vc,
                                   seq_len, out, s_eff, scale, softcap, window, w, n_split,
                                   split_len, s);
    return static_cast<int>(err);
}

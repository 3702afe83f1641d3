// flash_prefill_quant — attention of a T-token block over the quantized old
// cache plus the causal current block.
//
// Replaces llamacog_tpu/ops/pallas/flash_q8.py::flash_prefill_q8
// (_prefill_kernel): q [B, T, H, Dk] (natural order) attends to one layer of
// the quantized K and V planes [B, S, Hkv*W] (runtime/kv_cache.py; K and V
// kinds independent: q8_0, q4_0, q4_1, q5_0, q5_1, f16, bf16), positions
// below seq_len (the write offset) and kv_cap, and then to the block's own
// k_cur/v_cur [B, T, Hkv, D] causally, with softcap and sliding window.
// Query row r of kv head h is token r / rep, query head h*rep + r % rep
// (GQA rows T*rep, as the Pallas kernel). Out [B, T, H, Dv] in natural
// order.
//
// Bound on this card: operations at long blocks and deep caches (4 flops
// per query row, key and head dimension), bytes otherwise. The first
// version of this kernel computed scores and PV as f32 FMAs from shared
// memory (the SIMT body below), dequantizing each old-cache element on its
// own with an integer divide and modulo: q8_0 at T=128 0.2319 ms from write
// offset 0 and 2.0947 ms from 896, 0.1-0.4% of its bound (NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md §6).
//
// Design, bf16 (what the Engine runs): the tensor-core tile loop of
// flash_attn_tile.cuh, as K5 (flash_prefill.cu) runs it, with a loader that
// dequantizes. Phase 1 (the current block) copies bf16 rows by cp.async
// with K5's code (fa_copy_kv). Phase 0 (the old cache) stages the raw plane
// bytes of tile j + 1 — levels, f32 scales, mins and high bits, each plane's
// rows of the tile's 64 positions in the layout common.cuh::kv_stage gives
// (K6's) — by cp.async into one of two slots while tile j is used; after
// the loop's wait and barrier, the land step turns the landed slot into the
// bf16 K and V tiles, and one more barrier hands them to mma.sync. Both the
// copy and the land are compiled per kind and head dim (the kind switched
// once a tile): with a plane's row bytes a launch argument, the copy's
// address arithmetic cost as much as the land at T=128 (a grid of two
// warps an SM, where every instruction's latency shows). Every
// value is formed in f32 exactly as kv_dequant_planes forms it (the level an
// exact f32 by a byte permute or an OR into 2^23's mantissa, one rounded
// product, one rounded sum of the min) and rounded once to bf16; the f32
// accumulation, the online softmax and P in bf16 are K5's. The kinds stay
// launch arguments, switched once a tile in the copy and the land step:
// one instantiation per head-dim pair, not 49 kind pairs a pair.
//
// Column order: the planes store the head dim group-strided (stored column
// c holds natural element (c % G) * 32 + c / G, G = D / 32), and the land
// step writes natural columns, so Q, k_cur, v_cur and O keep the natural
// order and phase 1 shares K5's copy. A thread takes one unit of a row:
// the elements j0..j0+7 of every group (8G consecutive stored columns; the
// nibble kinds take j0 and j0+16 at once, the low and high nibbles of the
// same bytes) and writes, per group, one 16-byte chunk of 8 natural columns.
// The 8 threads of a shared-memory phase take rows U apart (U units a row),
// which puts their chunks on 8 distinct 16-byte bank groups for every head
// dim (the row pitch in chunks, D / 8 + 1, is odd): no bank conflict.
//
// Bodies: bf16 runs the tiles at Dk == Dv in 32..256 (multiples of 32) and
// Dk = 192 with Dv = 128 where q, k_cur and v_cur are 16-byte aligned and
// the tiles and both staging slots fit the block's shared memory (every
// pair but f16/bf16 planes at head dim 256). f32, and bf16 outside that,
// run the SIMT body (one block per 32 query rows, f32 FMAs from shared
// memory). The C entry picks the body before any launch and reports it.
//
// Measured (tools/attn_compare.py --only prefill_quant, 8B heads, q8_0,
// device span, K5 over a dense cache of the same values beside it; NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md §6): T=128 from offset 0 0.0148 ms (K5
// 0.0140), from 896 0.0568 (K5 0.0405); T=2048 from 0 0.2379 (K5 0.2437),
// from 2048 0.7340 (K5 0.5863), against 0.16-40.2 ms for the first version.
// From head dim 192 up the tiles spill (60-472 bytes; K5's spill at 256).
#include "flash_attn_tile.cuh"

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile loop over the quantized planes

constexpr size_t PQ_SMEM_MAX = 232448;  // dynamic shared memory a block may opt into (sm_90)

// N words of staged bytes from shared memory: 16-byte reads where N % 4 ==
// 0, else 8-byte reads (N even) or words (the callers' offsets are aligned so).
template <int N>
__device__ __forceinline__ void smem_words(const void* p, uint32_t (&w)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const uint4 a = reinterpret_cast<const uint4*>(p)[i];
            w[4 * i] = a.x;
            w[4 * i + 1] = a.y;
            w[4 * i + 2] = a.z;
            w[4 * i + 3] = a.w;
        }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const uint2 a = reinterpret_cast<const uint2*>(p)[i];
            w[2 * i] = a.x;
            w[2 * i + 1] = a.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    }
}

template <int D, int NT>
struct TileDims {};

// One landed slot's planes of one tensor (rows of the tile's 64 positions,
// q [64][QB], s/m/h [64][G]) -> the bf16 tile dst [64][D + FA_PAD] in
// natural column order. Thread i takes unit i % U of row
// (i / 8U) * 8 + (i / 8) % U + U * ((i / U) % (8 / U)) (see the note above).
template <int KIND, int D, int NT>
__device__ __forceinline__ void deq_tile(TileDims<D, NT>, bf16* __restrict__ dst,
                                         const uint8_t* __restrict__ q,
                                         const float* __restrict__ s,
                                         const float* __restrict__ m,
                                         const int* __restrict__ h, int tid) {
    constexpr int G = D / KV_GS;
    constexpr bool dense = KIND == KV_F16 || KIND == KV_BF16;
    constexpr bool nib = !dense && KIND != KV_Q8_0;
    constexpr bool with_min = KIND == KV_Q4_1 || KIND == KV_Q5_1;
    constexpr bool five = KIND == KV_Q5_0 || KIND == KV_Q5_1;
    constexpr int U = nib ? 2 : 4;                           // units a row
    constexpr int QB = dense ? 2 * D : nib ? D / 2 : D;      // staged q bytes a row
    constexpr int UW = QB / U / 4;                           // q words a unit
    constexpr int LD = D + FA_PAD;
#pragma unroll 1
    for (int i = tid; i < FA_BC * U; i += NT) {
        const int k = i % U;
        const int row = (i / (8 * U)) * 8 + (i / 8) % U + U * ((i / U) % (8 / U));
        uint32_t w[UW];
        smem_words(q + row * QB + k * (4 * UW), w);
        bf16* drow = dst + row * LD;
        if constexpr (dense) {
            // element t (0..7) of group g: stored half t * G + g of the unit
#pragma unroll
            for (int g = 0; g < G; ++g) {
                uint32_t o[4];
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    float v[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int hx = (2 * p + e) * G + g;
                        const uint32_t bits = (w[hx >> 1] >> (16 * (hx & 1))) & 0xFFFFu;
                        v[e] = KIND == KV_F16 ? __half2float(__ushort_as_half((unsigned short)bits))
                                              : __uint_as_float(bits << 16);
                    }
                    o[p] = pack_bf16x2(v[0], v[1]);
                }
                *reinterpret_cast<uint4*>(drow + g * KV_GS + 8 * k) =
                    make_uint4(o[0], o[1], o[2], o[3]);
            }
        } else {
            uint32_t sw[G], mw[G], hw[G];
            smem_words(s + row * G, sw);
            if constexpr (with_min) smem_words(m + row * G, mw);
            if constexpr (five) smem_words(h + row * G, hw);
            if constexpr (KIND == KV_Q8_0) {
                // element t of group g: byte t * G + g of the unit, its
                // signed level 2^23 + 128 + q by one byte permute, less the
                // constant (s8_level), times the scale
#pragma unroll
                for (int x = 0; x < UW; ++x) w[x] ^= 0x80808080u;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    uint32_t o[4];
#pragma unroll
                    for (int p = 0; p < 4; ++p) {
                        float v[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int bx = (2 * p + e) * G + g;
                            const float lvl = __int_as_float(__byte_perm(
                                w[bx >> 2], 0x4B000000u, 0x7540 + (bx & 3))) - 8388736.f;
                            v[e] = __fmul_rn(lvl, __uint_as_float(sw[g]));
                        }
                        o[p] = pack_bf16x2(v[0], v[1]);
                    }
                    *reinterpret_cast<uint4*>(drow + g * KV_GS + 8 * k) =
                        make_uint4(o[0], o[1], o[2], o[3]);
                }
            } else {
                // element t of group g: the low (elements j0 = 8k ..) or the
                // high (16 + 8k ..) nibble of byte t * G + g of the unit;
                // the fifth bit is bit j of the group's high-bit word; the
                // level's offset (q4_0: -8, q5_0: -16) taken off with 2^23
                constexpr float off =
                    8388608.f + (KIND == KV_Q4_0 ? 8.f : KIND == KV_Q5_0 ? 16.f : 0.f);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    uint32_t hb = 0u;  // bits 8k.. of the group's high-bit word
                    if constexpr (five) hb = hw[g] >> (8 * k);
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        uint32_t o[4];
#pragma unroll
                        for (int p = 0; p < 4; ++p) {
                            float v[2];
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int t = 2 * p + e, bx = t * G + g;
                                uint32_t lvl = (w[bx >> 2] >> (8 * (bx & 3) + 4 * half)) & 0xFu;
                                if constexpr (five) lvl |= ((hb >> (16 * half + t)) & 1u) << 4;
                                float x = __fmul_rn(__uint_as_float(0x4B000000u | lvl) - off,
                                                    __uint_as_float(sw[g]));
                                if constexpr (with_min) x = __fadd_rn(x, __uint_as_float(mw[g]));
                                v[e] = x;
                            }
                            o[p] = pack_bf16x2(v[0], v[1]);
                        }
                        *reinterpret_cast<uint4*>(drow + g * KV_GS + 16 * half + 8 * k) =
                            make_uint4(o[0], o[1], o[2], o[3]);
                    }
                }
            }
        }
    }
}

// Rows of positions [c0, c0 + FA_BC) of one plane (RB bytes a row, rows
// Hkv apart; src at position 0 of the block's batch row and kv head) into a
// staging slot (RB bytes a row) by cp.async; zeros at positions >= len.
template <int RB, int NT>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const uint8_t* src, int Hkv,
                                           int c0, int len, int tid) {
    constexpr int UNIT = RB % 16 == 0 ? 16 : RB % 8 == 0 ? 8 : 4;
    constexpr int PER = RB / UNIT, N = FA_BC * PER;
    const size_t pos_bytes = (size_t)Hkv * RB;
#pragma unroll
    for (int x = 0; x < (N + NT - 1) / NT; ++x) {
        const int i = tid + x * NT;
        if (N % NT != 0 && i >= N) break;
        const int r = i / PER, c = i - r * PER;
        const int pos = c0 + r;
        const bool ok = pos < len;  // past len: zeros, nothing read
        cp_async_n(dst + r * RB + c * UNIT, src + (ok ? pos : 0) * pos_bytes + c * UNIT, UNIT,
                   ok);
    }
}

// One tensor's planes of a tile (planes j0..j0 + 3 of the slot layout) by
// stage_rows, their row bytes known from the kind and the head dim.
template <int KIND, int D, int NT>
__device__ __forceinline__ void stage_tile(TileDims<D, NT>, unsigned char* base,
                                           const KVStage& st, int j0, size_t row0, int Hkv,
                                           int c0, int len, int tid) {
    constexpr int G = D / KV_GS;
    constexpr bool dense = KIND == KV_F16 || KIND == KV_BF16;
    constexpr int QB = dense ? 2 * D : KIND == KV_Q8_0 ? D : D / 2;
    stage_rows<QB, NT>(base + st.off[j0], st.src[j0] + row0 * QB, Hkv, c0, len, tid);
    if constexpr (!dense)
        stage_rows<4 * G, NT>(base + st.off[j0 + 1], st.src[j0 + 1] + row0 * 4 * G, Hkv, c0, len,
                              tid);
    if constexpr (KIND == KV_Q4_1 || KIND == KV_Q5_1)
        stage_rows<4 * G, NT>(base + st.off[j0 + 2], st.src[j0 + 2] + row0 * 4 * G, Hkv, c0, len,
                              tid);
    if constexpr (KIND == KV_Q5_0 || KIND == KV_Q5_1)
        stage_rows<4 * G, NT>(base + st.off[j0 + 3], st.src[j0 + 3] + row0 * 4 * G, Hkv, c0, len,
                              tid);
}

// Phase 1 by K5's copy; phase 0 by the raw planes staged in two slots (the
// tile's parity) behind the tiles in dynamic shared memory, landed into the
// tiles by deq_tile.
struct QuantKVLoader {
    static constexpr bool LANDS = true;
    const KVStage& st;  // the launch's planes and slot layout (rows = FA_BC)
    int kind_k, kind_v;
    size_t row0;        // plane row of (b, position 0, hk)
    int Hkv;
    const bf16* kc;     // current block at (b, token 0, hk)
    const bf16* vc;
    long long kc_ss, vc_ss;  // Hkv * Dk, Hkv * Dv
    unsigned char* stage;    // the two slots

    template <int DK, int DV, int NT>
    __device__ __forceinline__ void load(bf16* ks, bf16* vs, int phase, int c0, int len,
                                         int slot, int tid) const {
        if (phase == 1) {
            fa_copy_kv<DK, DV, NT>(ks, vs, kc, vc, kc_ss, vc_ss, c0, len, tid);
            return;
        }
        unsigned char* base = stage + (size_t)slot * st.bytes;
        using DimsK = TileDims<DK, NT>;
        using DimsV = TileDims<DV, NT>;
        KV_DISPATCH(kind_k, stage_tile, DimsK{}, base, st, 0, row0, Hkv, c0, len, tid)
        KV_DISPATCH(kind_v, stage_tile, DimsV{}, base, st, 4, row0, Hkv, c0, len, tid)
    }

    template <int D, int NT>
    __device__ __forceinline__ void land_one(int kind, bf16* dst, const unsigned char* base,
                                             int j, int tid) const {
        using Dims = TileDims<D, NT>;
        const uint8_t* q = base + st.off[j];
        const float* s = reinterpret_cast<const float*>(base + st.off[j + 1]);
        const float* m = reinterpret_cast<const float*>(base + st.off[j + 2]);
        const int* h = reinterpret_cast<const int*>(base + st.off[j + 3]);
        KV_DISPATCH(kind, deq_tile, Dims{}, dst, q, s, m, h, tid)
    }

    template <int DK, int DV, int NT>
    __device__ __forceinline__ bool land(bf16* ks, bf16* vs, int phase, int slot, int tid) const {
        if (phase != 0) return false;
        const unsigned char* base = stage + (size_t)slot * st.bytes;
        land_one<DK, NT>(kind_k, ks, base, 0, tid);
        land_one<DV, NT>(kind_v, vs, base, 4, tid);
        return true;
    }
};

template <int DK, int DV, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_prefill_quant_mma_kernel(const bf16* __restrict__ q, const __grid_constant__ KVStage st,
                               int kind_k, int kind_v, const bf16* __restrict__ kc,
                               const bf16* __restrict__ vc, const int* __restrict__ seq_len,
                               bf16* __restrict__ out, int S, int T_, int H, int Hkv, int s_eff,
                               float scale, float softcap, int window) {
    extern __shared__ __align__(16) unsigned char fa_smem[];
    const int hk = blockIdx.y, b = blockIdx.z;
    const int n = seq_len[b];
    const size_t cur = (size_t)b * T_ * Hkv + hk;  // (b, token 0, hk) in rows
    const QuantKVLoader ld{st, kind_k, kind_v, (size_t)b * S * Hkv + hk, Hkv, kc + cur * DK,
                           vc + cur * DV, (long long)Hkv * DK, (long long)Hkv * DV,
                           fa_smem + fa_smem_bytes(DK, DV)};
    prefill_attn_tiles<DK, DV, NW>(ld, q, out, b, hk, T_, H, H / Hkv, n, min(n, s_eff), scale,
                                   softcap, window);
}

// Four warps (64 GQA rows) a block up to head dim 128, else two (K5's
// registers above 128). Unlike K5, four at every grid size: the land step's
// work is per block, and four warps share it: at T=32-256 over 500-896 old
// positions (8B heads: 16-128 blocks) four read 11-16% faster than two, and
// at T=2048 from write offset 0 within 1% (PERF.md §6).
template <int DK, int DV>
static cudaError_t launch_mma(const void* q, const KVStage& st, int kind_k, int kind_v,
                              const void* kc, const void* vc, const int* seq_len, void* out,
                              int B, int S, int T_, int H, int Hkv, int s_eff, float scale,
                              float softcap, int window, size_t smem, cudaStream_t s) {
    constexpr int NW = DK <= 128 && DV <= 128 ? 4 : 2;
    static int attr_bytes = 0;  // the largest size set so far, per instantiation
    if ((int)smem > attr_bytes) {
        const cudaError_t err = cudaFuncSetAttribute(flash_prefill_quant_mma_kernel<DK, DV, NW>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     (int)smem);
        if (err != cudaSuccess) return err;
        attr_bytes = (int)smem;
    }
    const int R = T_ * (H / Hkv);
    const dim3 grid((R + 16 * NW - 1) / (16 * NW), Hkv, B);
    flash_prefill_quant_mma_kernel<DK, DV, NW><<<grid, 32 * NW, smem, s>>>(
        static_cast<const bf16*>(q), st, kind_k, kind_v, static_cast<const bf16*>(kc),
        static_cast<const bf16*>(vc), seq_len, static_cast<bf16*>(out), S, T_, H, Hkv, s_eff,
        scale, softcap, window);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32, and bf16 outside the tiles: the SIMT body (T the element type;
// shared memory and arithmetic in f32). Each old-cache tile is read in place
// from the planes and dequantized (common.cuh's kv_deq1, bit-exact against
// kv_dequant_planes) straight to its natural head-dim column.

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
flash_prefill_quant_simt_kernel(const T* __restrict__ q, KVPlanes kp, KVPlanes vp, int kind_k,
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
// `dtype`; K and V planes of one layer, each [B, S, Hkv*W] contiguous and
// 16-byte aligned (m/h null where the kind has none); seq_len [B] int32;
// s_eff the attended bound (<= S); out [B, T, H, Dv]. *simt is set to 1
// when the SIMT body is launched, 0 for the tiles (the wrapper counts the
// two bodies apart).
LCG_EXPORT int lcg_flash_prefill_quant(int dtype, int kind_k, int kind_v, const void* q,
                                       const void* kq, const void* ks, const void* km,
                                       const void* kh, const void* vq, const void* vs,
                                       const void* vm, const void* vh, int B, int S, int T_,
                                       int H, int Hkv, int Dk, int Dv, const void* kc,
                                       const void* vc, const int* seq_len, void* out,
                                       int s_eff, float scale, float softcap, int window,
                                       int* simt, void* stream) {
    if (Hkv < 1 || H % Hkv || Dk > PQ_MAX_D || Dv > PQ_MAX_D || Dk % KV_GS || Dv % KV_GS ||
        T_ < 1 || s_eff > S || !kv_kind_ok(kind_k) || !kv_kind_ok(kind_v))
        return static_cast<int>(cudaErrorInvalidValue);
    *simt = 0;
    const KVPlanes kp{kq, static_cast<const float*>(ks), static_cast<const float*>(km),
                      static_cast<const int*>(kh)};
    const KVPlanes vp{vq, static_cast<const float*>(vs), static_cast<const float*>(vm),
                      static_cast<const int*>(vh)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kc) |
                           reinterpret_cast<uintptr_t>(vc);
    if (dtype == DT_BF16 && ptrs % 16 == 0) {
        const KVStage stage = kv_stage(kind_k, kind_v, kp, vp, Dk, Dv, FA_BC);
        const size_t smem = fa_smem_bytes(Dk, Dv) + 2 * (size_t)stage.bytes;
#define LCG_PREFILL_Q(DK_, DV_)                                                          \
        if (Dk == DK_ && Dv == DV_)                                                       \
            return static_cast<int>(launch_mma<DK_, DV_>(q, stage, kind_k, kind_v, kc, vc, \
                                                         seq_len, out, B, S, T_, H, Hkv,   \
                                                         s_eff, scale, softcap, window,    \
                                                         smem, st));
        if (smem <= PQ_SMEM_MAX) {
            LCG_PREFILL_Q(32, 32) LCG_PREFILL_Q(64, 64) LCG_PREFILL_Q(96, 96)
            LCG_PREFILL_Q(128, 128) LCG_PREFILL_Q(160, 160) LCG_PREFILL_Q(192, 192)
            LCG_PREFILL_Q(224, 224) LCG_PREFILL_Q(256, 256) LCG_PREFILL_Q(192, 128)
        }
#undef LCG_PREFILL_Q
    }
    *simt = 1;
    const size_t smem = sizeof(float) *
        ((size_t)PQ_BR * (Dk + 1) + (size_t)PQ_BC * (Dk + 1) + (size_t)PQ_BC * (Dv + 1) +
         (size_t)PQ_BR * (PQ_BC + 1));
    const int R = T_ * (H / Hkv);
    const dim3 grid((R + PQ_BR - 1) / PQ_BR, Hkv, B);
    cudaError_t err;
    if (dtype == DT_BF16) {
        using T = __nv_bfloat16;
        err = cudaFuncSetAttribute(flash_prefill_quant_simt_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_prefill_quant_simt_kernel<T><<<grid, PQ_THREADS, smem, st>>>(
            static_cast<const T*>(q), kp, vp, kind_k, kind_v, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, T_, H, Hkv, Dk, Dv,
            s_eff, scale, softcap, window);
    } else {
        using T = float;
        err = cudaFuncSetAttribute(flash_prefill_quant_simt_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_prefill_quant_simt_kernel<T><<<grid, PQ_THREADS, smem, st>>>(
            static_cast<const T*>(q), kp, vp, kind_k, kind_v, static_cast<const T*>(kc),
            static_cast<const T*>(vc), seq_len, static_cast<T*>(out), S, T_, H, Hkv, Dk, Dv,
            s_eff, scale, softcap, window);
    }
    return static_cast<int>(cudaGetLastError());
}

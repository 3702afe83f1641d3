// qgemm_id — grouped fused dequant x GEMM over expert-sorted rows (the MoE
// prefill product, ggml's mul_mat_id at many rows), on wgmma.
//
// Replaces (llamacog_tpu/ops/pallas/qmm_id.py): _ragged_call (qmm_ragged,
// _ragged_kernel): out[S_pad, N] f32 = xs @ bf16(dequant(W[e]))^T tile by
// tile, where token tile i (rows i*tt .. i*tt+tt-1 of xs) belongs to expert
// e = tile_expert[i] of the stack W (wire blocks [n_exp * N, row_bytes],
// any kind of qgemm.cu). bf16 operands, f32 accumulation. Tiles whose
// expert lies outside [0, n_exp) are padding: their rows come out zero.
//
// Bound on this card: at the 128-token Mixtral prefill (256 (token, slot)
// rows) the used experts' weight bytes over 3.35 TB/s exceed the real rows'
// flops over the 989 TFLOP/s bf16 peak (gate_up 0.158 against 0.061 ms);
// at 512 tokens (1024 rows) the flops bound (0.243 ms). Design: dequantize
// each expert's weight strip once per pass of up to QID_PASS = 64 of its
// token rows (once per prefill chunk while an expert holds at most 64 rows:
// the 128-token bucket at top-2 of 8, whose experts hold ~32; the 512-token
// bucket makes ~2 passes), and multiply every row of the pass against it:
//   * work items are (pass, strip of QID_BN weight rows), a pass being up to
//     QID_PASS rows of one expert; persistent blocks (one an SM) walk them,
//     each having gathered every expert's tiles from tile_expert on the
//     device (any order), so the dequant cost no longer depends on how rows
//     fall into tiles, and an expert that draws most of the rows has its
//     passes on as many blocks;
//   * a producer warpgroup streams the strip's raw superblocks (two warps,
//     two superblocks of a row a slot) and the pass's activation rows (two
//     warps) by cp.async into two rings whose mbarriers count the landed
//     copies (cp.async.mbarrier.arrive), each running ahead across passes
//     and items while the consumers compute and store;
//   * two consumer warpgroups (64 weight rows each) dequantize straight into
//     the registers of wgmma's A operand: a thread forms the weights of rows
//     g and g + 8 of its warp at the columns the A fragment holds, from the
//     halfwords 2t + 8m of each 32-byte run of the wire block (Q4_K qs, Q6_K
//     ql/qh), in natural column order; no weight goes through shared memory;
//   * the pass's token rows are operand B, K-major in shared memory (64
//     columns a stage, 128-byte swizzle): one wgmma m64nNk16 a k16 step,
//     N = the rows rounded up to 16 (compiled for 16..64); the A registers
//     are double-buffered so that stage s's dequant overlaps stage s - 1's
//     products (wgmma.wait_group 1), and the four stages of a superblock are
//     unrolled so that their scale extraction is compiled.
// The pass width is the register budget's: ptxas builds the 384-thread
// block at 168 registers a thread (setmaxnreg gives the consumers 232 at run
// time, not at build time), and every wider pass tried spilled. The
// kernel reads 25-30% of its bound, not bound by the bytes; nor by the
// consumers' dequant issue (~6 instructions a weight here): the generic
// dequant below, several times the instructions a weight, runs at about the
// tuned kinds' speed (PERF.md). Where routing puts most rows on a few
// experts, each 64-row pass dequantizes its strip again.
// Each weight is formed as the plain dequant forms it, bit for bit, and
// rounded to bf16 (the arithmetic of qgemm_tile.cuh's QgStage); only the
// f32 summation order differs from qmm_ragged_plain.
// Q4_K and Q6_K (a Q4_K_M file's experts) have the tuned dequants below.
// Every other kind takes one generic dequant, compiled per kind: each of
// the thread's A-fragment weights is formed on its own from the raw ring by
// common.cuh::wire_weight (byte reads, each scale formed again; the
// codebook kinds' grid entries read from global memory through L1), the
// plain dequant's arithmetic, so the kind's layout needs no code here
// beyond its ring rows.
#include <type_traits>

#include "hopper.cuh"

constexpr int QID_WG = 2;                      // consumer warpgroups a block
constexpr int QID_BN = 64 * QID_WG;            // weight rows an item (its strip)
constexpr int QID_CONSUMERS = 128 * QID_WG;
constexpr int QID_THREADS = QID_CONSUMERS + 128;  // and a producer warpgroup
constexpr int QID_BK = 64;                     // K a stage: a Q4_K group, half a Q6_K chunk
constexpr int QID_CH = 16;                     // token rows per unit of the wgmma N
constexpr int QID_MAXCH = 4;                   // units a pass (see the register budget above)
constexpr int QID_PASS = QID_CH * QID_MAXCH;   // token rows a pass (wgmma N <= 64)
constexpr int QID_SB_GROUP = 2;                // superblocks of a row a raw slot holds
constexpr int QID_ACT_SLOT = QID_PASS * 128;   // an activation stage, 128 bytes a row
constexpr int QID_MAX_TILES = 1024;            // token tiles a launch
constexpr int QID_MAX_EXPERTS = 256;           // experts a launch
constexpr int QID_CONSUMER_BAR = 1, QID_ACT_BAR = 3;  // named barriers

template <int KIND>
struct QidCfg {
    // QID_SB_GROUP consecutive superblocks of a weight row in a raw ring row:
    // aligned where a superblock's bytes are a multiple of 16 (Q4_K, Q5_K,
    // Q8_0, the legacy kinds, IQ4_NL: rows of that many bytes from a 16-byte
    // aligned base); else (Q6_K, Q3_K, IQ3_XXS, IQ3_S, IQ2_S, IQ2_XXS,
    // IQ2_XS, IQ1_S, TQ1_0, TQ2_0: even offsets; Q2_K: multiples of 4;
    // IQ4_XS, IQ1_M: of 8)
    // the 16-byte chunks covering them from an offset of at most 14. Row
    // strides padded so that the halfword reads of a warp's eight rows fall
    // on distinct banks.
    static constexpr int GROUP_BYTES = QID_SB_GROUP * kind_sb_bytes(KIND);
    static constexpr int CHUNKS =
        kind_sb_bytes(KIND) % 16 == 0 ? GROUP_BYTES / 16 : (14 + GROUP_BYTES + 15) / 16;
    static constexpr int ROW = (CHUNKS * 16 / 128 * 128) + (CHUNKS * 16 % 128 <= 48 ? 48 : 112);
    static constexpr int RAW_SLOT = QID_BN * ROW;
    // ring depths within the 227 KB of shared memory
    static constexpr int ACT_SLOTS = 8;
    static constexpr int RAW_SLOTS = KIND == KIND_Q4_K ? 3 : 2;
    static constexpr size_t SMEM = 1024 + (size_t)ACT_SLOTS * QID_ACT_SLOT +
                                   (size_t)RAW_SLOTS * RAW_SLOT +
                                   (QID_MAX_TILES + 2 * QID_PASS + 2 * (QID_MAX_EXPERTS + 2)) *
                                       sizeof(int) +
                                   2 * (ACT_SLOTS + RAW_SLOTS) * sizeof(uint64_t);
};

// A ring position (slot, phase parity), advanced in step by its producer and
// its consumers.
struct QidRing {
    int slot = 0;
    uint32_t ph = 0;
    __device__ __forceinline__ void advance(int n) {
        if (++slot == n) {
            slot = 0;
            ph ^= 1;
        }
    }
};

// The 16 bits at even byte address p of shared memory, in the low half.
__device__ __forceinline__ uint32_t lds_half(const uint8_t* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    return *reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3)) >> (8 * (a & 2));
}
// The 32 bits at even byte address p of shared memory.
__device__ __forceinline__ uint32_t lds_word(const uint8_t* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    return (a & 2) ? __funnelshift_r(w[0], w[1], 16) : w[0];
}

// One stage's A operand of the thread: a[s] the m16n8k16 fragment of k16
// step s of the 64-column stage J of a superblock, for rows r0 (a[s][0],
// a[s][2]) and r0 + 8 (a[s][1], a[s][3]) of the warp, at columns 16s + 2t,
// +1 and 16s + 2t + 8, +9. The raw rows rw[h] point at the superblock's
// bytes in the ring; superblock() reads what its four stages share.
//
// Q4_K group J: column c < 32 is the low nibble of qs byte 32J + c, c >= 32
// the high nibble of 32J + c - 32; the thread's columns are the two bytes
// at 2t + 8m (m = 0..3). Weight (d*sc)*q - dmin*m, bf16.
template <int KIND>
struct QidDequant {  // the generic dequant: every kind but Q4_K and Q6_K
    __device__ __forceinline__ void superblock(const uint8_t* const (&)[2]) {}

    template <int J>
    __device__ __forceinline__ void stage(const uint8_t* const (&rw)[2], int t,
                                          uint32_t (&a)[4][4]) const {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c = 64 * J + 16 * s + 2 * t + 8 * v;
                    a[s][2 * v + h] =
                        pack_bf16x2(wire_weight<KIND>(rw[h], c), wire_weight<KIND>(rw[h], c + 1));
                }
    }
};

template <>
struct QidDequant<KIND_Q4_K> {
    uint32_t sc[2][3];  // the packed scales and mins of rows r0, r0 + 8
    float d[2], dmin[2];

    __device__ __forceinline__ void superblock(const uint8_t* const (&rw)[2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint4 v = *reinterpret_cast<const uint4*>(rw[h]);
            d[h] = f16_bits(v.x & 0xFFFF);
            dmin[h] = f16_bits(v.x >> 16);
            sc[h][0] = v.y; sc[h][1] = v.z; sc[h][2] = v.w;
        }
    }

    template <int J>
    __device__ __forceinline__ void stage(const uint8_t* const (&rw)[2], int t,
                                          uint32_t (&a)[4][4]) const {
        uint32_t lo[2][4], hi[2][4];
        float dl0[2], ml0[2], dl1[2], ml1[2], n0[2], n1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int sc0, mn0, sc1, mn1;
            q4k_scale_min(sc[h][0], sc[h][1], sc[h][2], 2 * J, sc0, mn0);
            q4k_scale_min(sc[h][0], sc[h][1], sc[h][2], 2 * J + 1, sc1, mn1);
            dl0[h] = __fmul_rn(d[h], u23_f32(sc0));
            ml0[h] = __fmul_rn(dmin[h], u23_f32(mn0));
            dl1[h] = __fmul_rn(d[h], u23_f32(sc1));
            ml1[h] = __fmul_rn(dmin[h], u23_f32(mn1));
            n0[h] = -16.f * dl0[h];
            n1[h] = -16.f * dl1[h];
            const uint8_t* q = rw[h] + 16 + 32 * J + 2 * t;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const uint32_t w = lds_half(q + 8 * m);
                // each nibble as 0x80 | q << 3: the high mantissa byte of 16 + q
                lo[h][m] = ((w << 3) & 0x7878u) | 0x8080u;
                hi[h][m] = ((w >> 1) & 0x7878u) | 0x8080u;
            }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int m = 2 * (s & 1) + v;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint32_t b = s < 2 ? lo[h][m] : hi[h][m];
                    const float dl = s < 2 ? dl0[h] : dl1[h], nn = s < 2 ? n0[h] : n1[h];
                    const float ml = s < 2 ? ml0[h] : ml1[h];
                    a[s][2 * v + h] =
                        pack_bf16x2(__fsub_rn(__fmaf_rn(dl, level_plus<16, 0>(b), nn), ml),
                                    __fsub_rn(__fmaf_rn(dl, level_plus<16, 1>(b), nn), ml));
                }
            }
        }
    }
};

// Q6_K stage J: chunk c = J >> 1 of the superblock, quarters Q = 2 (J & 1) +
// (s >> 1) for k16 step s; column l (0..31) of quarter Q is the nibble
// (J & 1 ? high : low) of ql byte 64c + 32 (s >> 1) + l and bits 2Q, 2Q + 1
// of qh byte 128 + 32c + l, scale sc[8c + 4 (J & 1) + s] * d. Weight
// d*sc*(q - 32), bf16. The ql/qh halfwords of a chunk serve both of its
// stages.
template <>
struct QidDequant<KIND_Q6_K> {
    uint32_t ql[2][2][4], qh[2][4];  // [row][low/high 32 bytes][m], halfwords
    float d[2];

    __device__ __forceinline__ void superblock(const uint8_t* const (&rw)[2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) d[h] = f16_bits(lds_half(rw[h] + 208) & 0xFFFF);
    }

    template <int J>
    __device__ __forceinline__ void stage(const uint8_t* const (&rw)[2], int t,
                                          uint32_t (&a)[4][4]) {
        constexpr int c = J >> 1, nib = J & 1;
        float dl[2][4], n96[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if constexpr (nib == 0) {
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    ql[h][0][m] = lds_half(rw[h] + 64 * c + 2 * t + 8 * m);
                    ql[h][1][m] = lds_half(rw[h] + 64 * c + 32 + 2 * t + 8 * m);
                    qh[h][m] = lds_half(rw[h] + 128 + 32 * c + 2 * t + 8 * m);
                }
            }
            const uint32_t sc = lds_word(rw[h] + 192 + 8 * c + 4 * nib);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                dl[h][s] = __fmul_rn(d[h], s8_f32((sc >> (8 * s)) & 0xFF));
                n96[h][s] = -96.f * dl[h][s];
            }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int m = 2 * (s & 1) + v;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint32_t lq = (ql[h][s >> 1][m] >> (4 * nib)) & 0x0F0Fu;
                    const uint32_t hq = (qh[h][m] >> (4 * nib + 2 * (s >> 1))) & 0x0303u;
                    // the high mantissa bytes of 64 + q
                    const uint32_t b = ((lq | (hq << 4)) << 1) | 0x8080u;
                    a[s][2 * v + h] =
                        pack_bf16x2(__fmaf_rn(dl[h][s], level_plus<64, 0>(b), n96[h][s]),
                                    __fmaf_rn(dl[h][s], level_plus<64, 1>(b), n96[h][s]));
                }
            }
        }
    }
};

// The tiles of expert e (e == n_exp: the padding tiles), in order, into
// list by the whole block; returns their count.
__device__ __forceinline__ int qid_gather(const int* __restrict__ tile_expert, int n_tiles, int e,
                                          int n_exp, int* list, int* wcnt) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    int cnt = 0;
    for (int i0 = 0; i0 < n_tiles; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        const int te = i < n_tiles ? tile_expert[i] : e;
        const bool pad = te < 0 || te >= n_exp;
        const bool take = i < n_tiles && (e < n_exp ? te == e : pad);
        const uint32_t bal = __ballot_sync(0xffffffffu, take);
        if (lane == 0) wcnt[w] = __popc(bal);
        __syncthreads();
        int before = 0, total = 0;
        for (int q = 0; q < nw; ++q) {
            before += q < w ? wcnt[q] : 0;
            total += wcnt[q];
        }
        if (take) list[cnt + before + __popc(bal & ((1u << lane) - 1))] = i;
        cnt += total;
        __syncthreads();
    }
    return cnt;
}

struct QidArgs {
    const uint8_t* w;
    const __nv_bfloat16* x;
    const int* tile_expert;
    float* out;
    int n_exp, n_tiles, tt, N, K, row_bytes;
};

// The consumers' pass of NCH * 32 token rows (Rp of them real) over the
// whole of K against the strip's 64 * QID_WG weight rows, then its stores.
template <int KIND, int NCH>
__device__ __forceinline__ void qid_pass(const QidArgs& p, uint8_t* act, uint8_t* raw,
                                         uint64_t* act_full, uint64_t* act_empty,
                                         uint64_t* raw_full, uint64_t* raw_empty,
                                         QidRing& ar, QidRing& rr, const int* crow, int Rp,
                                         int n0, const uint8_t* we, int ctid) {
    using C = QidCfg<KIND>;
    constexpr int bpb = kind_sb_bytes(KIND);
    const int warp = ctid >> 5, lane = ctid & 31, t = lane & 3;
    const int rb = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);  // weight rows rb, rb + 8
    float acc[8 * NCH];
    uint32_t a0[4][4], a1[4][4];  // A double-buffered: stage s's dequant overlaps s - 1's products
    QidDequant<KIND> dq;
    int held = -1;  // the activation slot whose products are still in flight
    const uint8_t* rw[2];
    const int n_sb = p.K / QK_K;

    auto step = [&](auto J, int sb, uint32_t (&a)[4][4]) {
        constexpr int j = decltype(J)::value;
        dq.template stage<j>(rw, t, a);  // the weights need no activations: before their wait
        if (j == 3 && (sb % QID_SB_GROUP == QID_SB_GROUP - 1 || sb == n_sb - 1)) {
            __syncwarp();  // the group's last stage: its raw slot is free
            if (lane == 0) mbar_arrive(&raw_empty[rr.slot]);
            rr.advance(C::RAW_SLOTS);
        }
        mbar_wait(&act_full[ar.slot], ar.ph);
        fence_proxy_async();  // the landed cp.async bytes, to wgmma's reads
        const uint64_t db = sw128_desc(act + ar.slot * QID_ACT_SLOT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QID_BK / 16; ++kk)
            wgmma_bf16_rs<NCH>(acc, a[kk], db + 2 * kk, (sb | j | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release its slot
        if (held >= 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&act_empty[held]);
        }
        held = ar.slot;
        ar.advance(C::ACT_SLOTS);
    };
    for (int sb = 0; sb < n_sb; ++sb) {
        const int sg = sb % QID_SB_GROUP;  // superblock sb - sg starts the slot's group
        const uint8_t* slot = raw + rr.slot * C::RAW_SLOT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // each row at its group's offset from 16 bytes
            const uintptr_t blk = reinterpret_cast<uintptr_t>(
                we + (size_t)min(n0 + rb + 8 * h, p.N - 1) * p.row_bytes +
                (size_t)(sb - sg) * bpb);
            rw[h] = slot + (rb + 8 * h) * C::ROW + (blk & 15) + sg * bpb;
        }
        if (sg == 0) mbar_wait(&raw_full[rr.slot], rr.ph);
        dq.superblock(rw);
        step(std::integral_constant<int, 0>{}, sb, a0);
        step(std::integral_constant<int, 1>{}, sb, a1);
        step(std::integral_constant<int, 2>{}, sb, a0);
        step(std::integral_constant<int, 3>{}, sb, a1);
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&act_empty[held]);
#pragma unroll
    for (int i = 0; i < 8 * NCH; ++i) reg_fence(acc[i]);

    // token row 8(i >> 2) + 2t + (i & 1) of the pass, weight row rb + 8((i >> 1) & 1)
#pragma unroll
    for (int i = 0; i < 8 * NCH; ++i) {
        const int r = 8 * (i >> 2) + 2 * t + (i & 1);
        const int n = n0 + rb + 8 * ((i >> 1) & 1);
        if (r < Rp && n < p.N) p.out[(size_t)crow[r] * p.N + n] = acc[i];
    }
}

template <int KIND>
__global__ void __launch_bounds__(QID_THREADS, 1) qgemm_id_kernel(const QidArgs p) {
    using C = QidCfg<KIND>;
    constexpr int bpb = kind_sb_bytes(KIND);
    extern __shared__ uint8_t qid_smem_raw[];
    uint8_t* act = align1024(qid_smem_raw);
    uint8_t* raw = act + C::ACT_SLOTS * QID_ACT_SLOT;
    int* list = reinterpret_cast<int*>(raw + C::RAW_SLOTS * C::RAW_SLOT);  // tiles by expert
    int* tstart = list + QID_MAX_TILES;  // expert e's tiles at list[tstart[e]..]
    int* pstart = tstart + QID_MAX_EXPERTS + 2;  // its passes from pass pstart[e]
    int* prow = pstart + QID_MAX_EXPERTS + 2;  // the pass's rows of xs, for the producer
    int* crow = prow + QID_PASS;               // and for the consumers' stores
    uint64_t* act_full = reinterpret_cast<uint64_t*>(crow + QID_PASS);
    uint64_t* act_empty = act_full + C::ACT_SLOTS;
    uint64_t* raw_full = act_empty + C::ACT_SLOTS;
    uint64_t* raw_empty = raw_full + C::RAW_SLOTS;
    __shared__ int wcnt[QID_THREADS / 32];

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < C::ACT_SLOTS; ++s) {
            mbar_init(&act_full[s], 64);             // every activation producer's copies
            mbar_init(&act_empty[s], QID_WG * 4);    // every consumer warp
        }
        for (int s = 0; s < C::RAW_SLOTS; ++s) {
            mbar_init(&raw_full[s], 64);
            mbar_init(&raw_empty[s], QID_WG * 4);
        }
        fence_mbar_init();
    }
    __syncthreads();

    // every expert's tiles (expert n_exp: the padding tiles), in order, and
    // its passes of up to QID_PASS rows; the work items are (pass, strip) over
    // these passes alone, so every item has rows and blocks that take them in
    // turn share the work evenly however the routing fell
    int total = 0;
    for (int e = 0; e <= p.n_exp; ++e) {
        const int cnt = qid_gather(p.tile_expert, p.n_tiles, e, p.n_exp, list + total, wcnt);
        if (tid == 0) {
            tstart[e] = total;
            pstart[e + 1] = (e == 0 ? 0 : pstart[e]) + (cnt * p.tt + QID_PASS - 1) / QID_PASS;
        }
        total += cnt;
    }
    if (tid == 0) pstart[0] = 0;
    __syncthreads();
    const int n_strips = (p.N + QID_BN - 1) / QID_BN;
    const int items = pstart[p.n_exp + 1] * n_strips;
    // item -> expert e, its rows [p0, p0 + Rp), strip n0
    auto item_of = [&](int item, int& e, int& p0, int& Rp, int& n0) {
        const int gp = item / n_strips;
        n0 = (item % n_strips) * QID_BN;
        e = 0;
        while (pstart[e + 1] <= gp) ++e;
        p0 = (gp - pstart[e]) * QID_PASS;
        const int next = e < p.n_exp ? tstart[e + 1] : total;
        Rp = min(QID_PASS, (next - tstart[e]) * p.tt - p0);
    };
    auto row_of = [&](int e, int q) { return list[tstart[e] + q / p.tt] * p.tt + q % p.tt; };
    const int n_st = p.K / QID_BK;
    QidRing ar, rr;

    if (warpgroup_index() == QID_WG) {  // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        // two warps stream the raw superblocks, two the activation stages:
        // each ring runs as far ahead as its own slots allow
        const bool raw_role = tid < QID_CONSUMERS + 64;
        const int ptid = (tid - QID_CONSUMERS) & 63;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            int e, p0, Rp, n0;
            item_of(item, e, p0, Rp, n0);
            if (e == p.n_exp) continue;  // the consumers write the padding zeros
            const uint8_t* we = p.w + (size_t)e * p.N * p.row_bytes;
            if (raw_role) {  // the strip's superblocks, a group a slot
                for (int sb = 0; sb < n_st / 4; sb += QID_SB_GROUP) {
                    const int gbytes = min(QID_SB_GROUP, n_st / 4 - sb) * bpb;
                    mbar_wait(&raw_empty[rr.slot], rr.ph ^ 1);
                    uint8_t* slot = raw + rr.slot * C::RAW_SLOT;
                    for (int i = ptid; i < QID_BN * C::CHUNKS; i += 64) {
                        const int r = i / C::CHUNKS, k = i % C::CHUNKS;
                        const uint8_t* blk = we + (size_t)min(n0 + r, p.N - 1) * p.row_bytes +
                                             (size_t)sb * bpb;
                        const uint8_t* src = reinterpret_cast<const uint8_t*>(
                            reinterpret_cast<uintptr_t>(blk) & ~uintptr_t(15)) + 16 * k;
                        const int left = static_cast<int>(blk + gbytes - src);
                        cp_async16_n(slot + r * C::ROW + 16 * k, left > 0 ? src : blk,
                                     left > 16 ? 16 : left > 0 ? left : 0);
                    }
                    cp_async_arrive(&raw_full[rr.slot]);
                    rr.advance(C::RAW_SLOTS);
                }
                continue;
            }
            const int rows = (Rp + QID_CH - 1) / QID_CH * QID_CH;
            named_sync(QID_ACT_BAR, 64);  // the last pass's rows are issued
            for (int r = ptid; r < Rp; r += 64) prow[r] = row_of(e, p0 + r);
            named_sync(QID_ACT_BAR, 64);
            for (int st = 0; st < n_st; ++st) {
                mbar_wait(&act_empty[ar.slot], ar.ph ^ 1);
                uint8_t* dst = act + ar.slot * QID_ACT_SLOT;
                // 16-byte chunk q of row r, 128-byte swizzled; zeros past Rp
                for (int i = ptid; i < rows * 8; i += 64) {
                    const int r = i >> 3, q = i & 7;
                    const bool ok = r < Rp;
                    cp_async16(dst + r * 128 + ((q ^ (r & 7)) << 4),
                               p.x + (size_t)(ok ? prow[r] : 0) * p.K + st * QID_BK + 8 * q, ok);
                }
                cp_async_arrive(&act_full[ar.slot]);
                ar.advance(C::ACT_SLOTS);
            }
        }
        cp_async_wait<0>();
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = tid;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int e, p0, Rp, n0;
        item_of(item, e, p0, Rp, n0);
        if (e == p.n_exp) {  // padding rows: zeros, no weights
            for (int i = ctid; i < Rp * QID_BN; i += QID_CONSUMERS) {
                const int col = n0 + i % QID_BN;
                if (col < p.N) p.out[(size_t)row_of(e, p0 + i / QID_BN) * p.N + col] = 0.f;
            }
            continue;
        }
        named_sync(QID_CONSUMER_BAR, QID_CONSUMERS);  // the last pass's stores read crow
        for (int r = ctid; r < Rp; r += QID_CONSUMERS) crow[r] = row_of(e, p0 + r);
        named_sync(QID_CONSUMER_BAR, QID_CONSUMERS);
        const uint8_t* we = p.w + (size_t)e * p.N * p.row_bytes;
#define QID_PASS_CASE(NCH)                                                                    \
    case NCH:                                                                                 \
        qid_pass<KIND, NCH>(p, act, raw, act_full, act_empty, raw_full, raw_empty, ar, rr,    \
                            crow, Rp, n0, we, ctid);                                           \
        break;
        switch ((Rp + QID_CH - 1) / QID_CH) {
            QID_PASS_CASE(1) QID_PASS_CASE(2) QID_PASS_CASE(3) QID_PASS_CASE(4)
        }
#undef QID_PASS_CASE
    }
}

static int qid_sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

template <int KIND>
static int launch_qid(const QidArgs& a, cudaStream_t stream) {
    static bool attr_set = false;  // once per instantiation, not per launch
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            qgemm_id_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)QidCfg<KIND>::SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        attr_set = true;
    }
    // at most one pass an expert more than the rows' own passes
    const long long passes = (a.n_tiles * a.tt + QID_PASS - 1) / QID_PASS + a.n_exp + 1;
    const long long items = passes * ((a.N + QID_BN - 1) / QID_BN);
    const int grid = items < qid_sm_count() ? (int)items : qid_sm_count();
    qgemm_id_kernel<KIND><<<grid, QID_THREADS, QidCfg<KIND>::SMEM, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// xs [S_pad, K] bf16, contiguous, 16-byte aligned, S_pad = tt * (tiles, at
// most QID_MAX_TILES); w [n_exp * N, K/256 superblocks] of `kind` (any of
// common.cuh's), 16-byte aligned; tile_expert [S_pad / tt] int32 on the
// device; out [S_pad, N] f32. tt a multiple of 16.
LCG_EXPORT int lcg_qgemm_id(const void* x, int x_dtype, int S_pad, int K, const void* w,
                            int kind, int n_exp, int N, const void* tile_expert, int tt,
                            void* out, void* stream) {
    if (x_dtype != DT_BF16 || tt < 16 || tt % 16 || S_pad < tt || S_pad % tt ||
        S_pad / tt > QID_MAX_TILES || K < QK_K || K % QK_K || n_exp < 1 ||
        n_exp > QID_MAX_EXPERTS || N < 1 || (N + QID_BN - 1) / QID_BN > (1 << 20) ||
        kind_sb_bytes(kind) == 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const QidArgs a = {static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(x),
                       static_cast<const int*>(tile_expert), static_cast<float*>(out),
                       n_exp, S_pad / tt, tt, N, K, (K / QK_K) * kind_sb_bytes(kind)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
#define QID_CASE(KIND) \
    case KIND: return launch_qid<KIND>(a, s);
        QID_CASE(KIND_Q4_K) QID_CASE(KIND_Q6_K) QID_CASE(KIND_Q8_0) QID_CASE(KIND_Q5_K)
        QID_CASE(KIND_Q4_0) QID_CASE(KIND_Q4_1) QID_CASE(KIND_Q5_0) QID_CASE(KIND_Q5_1)
        QID_CASE(KIND_Q2_K) QID_CASE(KIND_Q3_K) QID_CASE(KIND_IQ4_NL) QID_CASE(KIND_IQ4_XS)
        QID_CASE(KIND_IQ3_XXS) QID_CASE(KIND_IQ3_S) QID_CASE(KIND_IQ2_S) QID_CASE(KIND_IQ2_XXS)
        QID_CASE(KIND_IQ2_XS) QID_CASE(KIND_IQ1_S) QID_CASE(KIND_IQ1_M) QID_CASE(KIND_TQ1_0)
#undef QID_CASE
        default: return launch_qid<KIND_TQ2_0>(a, s);
    }
}

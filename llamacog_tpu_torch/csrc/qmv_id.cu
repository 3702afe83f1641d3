// qmv_id — expert-gathered fused dequant x matvec over stacked GGUF wire
// experts (the MoE decode product, ggml's mul_mat_id at few rows).
//
// Replaces (llamacog_tpu/ops/pallas/qmm_id.py):
//   * _gather_call (qmm_gather, _gather_kernel): out[s, N] f32 =
//     x[s, K] @ dequant(W[ids[s]])[N, K]^T for S <= 32 (token, slot) rows,
//     W a stack of n_exp experts stored as wire blocks [n_exp * N, row_bytes];
//   * _offset_call (qmm_gather_offset, _offset_kernel): the same contract,
//     which the TPU ran as one launch per row to reuse qmm's DMA pipeline.
//     Here it is one launch over all rows.
// The TPU kernel's grid is (S, N / tn): each row streams its own expert's
// tiles. Here rows that share an expert share its decode.
//
// Bound on this card: bytes. A row does 2 flops per weight of one expert
// against 0.56 (Q4_K) or 0.82 (Q6_K) bytes per weight, so the least time is
// the selected experts' bytes (each distinct expert once) over 3.35 TB/s.
// What stands in the way is instructions and their latency, as in qmv.cu:
// forming a weight's level takes ~1.5 instructions, folding it into a row's
// sum an FMA, and a row's activations more (bf16 -> f32 and their loads).
//
// Two kernels, counted apart (qmv_id, qmv_id_group); the caller picks one
// from the shapes alone (ops/cuda/qmm_id.py::gather_groups), so a launch
// stays one launch and the decode step's CUDA graph captures it:
//   * qid_rows_kernel, for rows that seldom share an expert (one token's top
//     k are distinct; 32 rows over 128 experts mostly are): a block per (row,
//     QID_TILE weight rows), a warp walking its 2 rows with
//     common.cuh::qmv_walk. Timed against a persistent walk of K1's row
//     count (4 Q4_K rows a warp) and against the grouping kernel on such
//     rows, this grid read fastest (PERF.md §6).
//   * qid_group_kernel, for rows of several tokens over few experts (at
//     least twice as many rows as experts, about two rows a used expert at
//     a router's top k: an 8-slot Mixtral step; with fewer it reads slower,
//     tools/gather_rule.py). Each block reads
//     ids (S <= 32, a lane a row) and groups them by expert with
//     __match_any_sync into passes in shared memory: one used expert and up
//     to QID_NB of the rows that chose it, in row order; an expert with more
//     rows takes further passes. No routing result reaches the host. The
//     grid is (QID_TILE weight rows, pass slot): a block walks passes y,
//     y + QID_PASS_SLOTS, ... of its tile, so the passes of one expert read
//     its bytes at about the same time (through L2). A warp forms its 2
//     rows' levels once a step and folds them against each of the pass's
//     rows (qmv_walk's fold at up to 8 rows). The raw blocks of the wide
//     kinds (Q6_K, Q5_K, Q8_0, Q2_K, Q3_K: 10-14 registers a row a step)
//     come through a per-warp ring of QID_STAGES steps in shared memory
//     (cp.async, a run of contiguous bytes a row, landed at its address's
//     offset within 16 so the raw loaders read it as device memory), which
//     only their launches allocate; the others' through registers, one step
//     ahead, as qmv_walk. Every kind was timed both ways
//     (tools/gather_rule.py --only ring, PERF.md §6): neither path is the
//     faster for all, so both stay (the register walk costs Q6_K, Q5_K,
//     Q3_K and Q8_0 up to 19, 35, 9 and 11%; the ring costs the legacy,
//     4-bit codebook, IQ2_XXS and IQ1_S gate_up stacks 4-19%). Launch
//     bounds of 4 blocks an SM cap it at 128 registers.
// Tried and dropped (PERF.md §6): a persistent grid of flat (pass, row
// group) walks, activations staged per block in shared memory (by cp.async
// with a barrier a step, or by bulk copies on mbarriers), activations made
// f32 by a prologue launch, L1 prefetch of the next step's activations.
// No tensor cores: at S <= 32 an expert rarely has more than 8 rows, so an
// m16n8 tile would be mostly padding, and forming bf16 weights for it costs
// the instructions that the folded offsets save. Many rows an expert is
// K11's (qgemm_id.cu).
// The fold is common.cuh's in both kernels (raw levels dotted with x per
// sub-block part, the scale applied once, the offset folded against the
// part's sum of x, f32 throughout), so a row's result is the same bits in
// either kernel and in a pass of any size: it does not depend on the other
// rows of the launch. (Forming each weight once, scale times level less
// offset, read ~5% faster but moved a row's sum by up to ~1e-6 of it.)
// A row whose id lies outside [0, n_exp) gets zeros and reads no weights
// (the ragged route's padding tiles, ops/cuda/qmm_id.py).
// Every weight kind of qmv.cu: a Q4_K or Q6_K stack (a Q4_K_M file's
// experts) takes the instantiation of those two alone, a codebook kind's
// stack the one of the five codebook kinds, a 1-2 bit or ternary kind's the
// one of those six, every other kind the one of the other eight.
#include "hopper.cuh"

constexpr int QID_NB = 8;                     // rows a pass folds against one decode
constexpr int QID_R = 2;                      // weight rows a warp
constexpr int QID_TILE = QMV_WARPS * QID_R;   // weight rows a block
constexpr int QID_GROUP_MAX = 32;             // rows the grouping kernel takes (a lane a row)
constexpr int QID_PASS_SLOTS = 4;             // blocks a tile of weight rows
constexpr int QID_STAGES = 3;                 // steps a warp's raw ring holds
// a row's step of raw blocks in the ring: QMV_SB_STEP superblocks of the
// widest kind (Q8_0) and 16 bytes for the run's offset within 16
constexpr int QID_RUN = (QMV_SB_STEP * Q80_BYTES + 31) / 16 * 16;

template <int K>
struct KindTag {
    static constexpr int value = K;
};

// f(KindTag<KIND>()) for the kind of the set KSET that `kind` names.
template <int KSET, typename F>
__device__ __forceinline__ void qid_dispatch(int kind, F&& f) {
#define QID_CASE(KIND) \
    case KIND: f(KindTag<KIND>()); break;
    if constexpr (KSET == KS_Q4K_Q6K) {
        if (kind == KIND_Q4_K) f(KindTag<KIND_Q4_K>());
        else f(KindTag<KIND_Q6_K>());
    } else if constexpr (KSET == KS_ALL) {
        switch (kind) {
            QID_CASE(KIND_Q8_0) QID_CASE(KIND_Q5_K) QID_CASE(KIND_Q4_0) QID_CASE(KIND_Q4_1)
            QID_CASE(KIND_Q5_0) QID_CASE(KIND_Q5_1) QID_CASE(KIND_Q2_K)
            default: f(KindTag<KIND_Q3_K>()); break;
        }
    } else if constexpr (KSET == KS_IQ) {
        switch (kind) {
            QID_CASE(KIND_IQ4_NL) QID_CASE(KIND_IQ4_XS) QID_CASE(KIND_IQ3_XXS) QID_CASE(KIND_IQ3_S)
            default: f(KindTag<KIND_IQ2_S>()); break;
        }
    } else {
        switch (kind) {
            QID_CASE(KIND_IQ2_XXS) QID_CASE(KIND_IQ2_XS) QID_CASE(KIND_IQ1_S) QID_CASE(KIND_IQ1_M)
            QID_CASE(KIND_TQ1_0)
            default: f(KindTag<KIND_TQ2_0>()); break;
        }
    }
#undef QID_CASE
}

// ---------------------------------------------------------------------------
// Rows that seldom share an expert: a block per (row s, QID_TILE weight
// rows), a warp per 2.
template <typename TX, int KSET>
__global__ void __launch_bounds__(QMV_WARPS * 32)
qid_rows_kernel(const uint8_t* __restrict__ w, const TX* __restrict__ x,
                const int* __restrict__ ids, float* __restrict__ out, int kind, int n_exp,
                int N, int K, int row_bytes) {
    const int s = blockIdx.x;
    const int g = (int)blockIdx.y * QMV_WARPS + (int)(threadIdx.x >> 5);  // one group a warp
    const int groups = (N + QID_R - 1) / QID_R;
    const int e = ids[s];
    float* o = out + (size_t)s * N;
    if (e >= 0 && e < n_exp) {
        const uint8_t* we = w + (size_t)e * N * row_bytes;
        const TX* xs = x + (size_t)s * K;
        qid_dispatch<KSET>(kind, [&](auto k) {
            qmv_walk<decltype(k)::value, 1, QID_R, TX>(we, N, row_bytes, xs, 1, K, g, groups,
                                                       groups, o);
        });
    } else if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int r = 0; r < QID_R; ++r)
            if (g * QID_R + r < N) o[g * QID_R + r] = 0.f;
    }
}

// ---------------------------------------------------------------------------
// Rows grouped by expert (2..QID_GROUP_MAX rows).

// The passes of the launch's rows: pass p is expert exp[p] against rows
// row[p][0..cnt[p]).
struct QidTable {
    int exp[QID_GROUP_MAX];
    __align__(8) uint8_t row[QID_GROUP_MAX][QID_NB];
    uint8_t cnt[QID_GROUP_MAX];
    int passes;
};

// Warp 0 groups rows 0..S-1 (S <= 32, a lane a row) by expert into t;
// blocks of pass slot 0 write the zeros of rows whose id lies outside
// [0, n_exp), each in its own QID_TILE columns.
__device__ void qid_table(const int* __restrict__ ids, int S, int n_exp, int N, QidTable& t,
                          float* __restrict__ out) {
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const int e = lane < S ? ids[lane] : -1;
        const bool valid = lane < S && e >= 0 && e < n_exp;
        // lanes without an expert match none: their keys are below every id
        const unsigned same = __match_any_sync(0xffffffffu, valid ? e : -1 - lane);
        const int cnt = __popc(same);
        const bool leader = valid && __ffs(same) - 1 == lane;
        const int np = leader ? (cnt + QID_NB - 1) / QID_NB : 0;
        int incl = np;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        if (lane == 31) t.passes = incl;
        if (leader) {
            const int p0 = incl - np;
            unsigned m = same;
            for (int j = 0; j < cnt; ++j) {
                const int p = p0 + j / QID_NB;
                if (j % QID_NB == 0) {
                    t.exp[p] = e;
                    t.cnt[p] = min(QID_NB, cnt - j);
                }
                t.row[p][j % QID_NB] = __ffs(m) - 1;
                m &= m - 1;
            }
        }
        unsigned bad = __ballot_sync(0xffffffffu, lane < S && !valid);
        if (blockIdx.y == 0) {
            while (bad) {
                const int z = __ffs(bad) - 1;
                bad &= bad - 1;
                const int c = blockIdx.x * QID_TILE + lane;
                if (lane < QID_TILE && c < N) out[(size_t)z * N + c] = 0.f;
            }
        }
    }
    __syncthreads();
}

// The kinds whose raw blocks reach the grouping walk through the shared-
// memory ring: those whose raw fields take 10 or more registers a row a
// step, which the register walk would hold twice.
__host__ __device__ constexpr bool qid_ring(int kind) {
    return kind == KIND_Q6_K || kind == KIND_Q5_K || kind == KIND_Q8_0 || kind_low_k(kind);
}
constexpr int QID_RING_BYTES = QID_STAGES * QID_R * QID_RUN;  // a warp's ring

// One warp's walk over passes q, q + qstep, ... (< P) against its rows
// gR, gR + 1 (rows past N re-read row N - 1 and are not written). The walk
// is one flat sequence of steps of QMV_SB_STEP superblocks across the ends
// of passes: a ring kind's raw blocks are copied QID_STAGES - 1 steps ahead
// of the arithmetic, the others' loaded into registers one step ahead. A
// pass's levels are formed once a step and folded against each of its rows.
// A lane whose 32-weight block lies past K (a padded row of a 32-weight-
// block kind) reads no x and adds nothing.
template <int KIND, typename TX>
__device__ void qid_walk(const uint8_t* __restrict__ w, int N, int row_bytes,
                         const TX* __restrict__ x, int K, const QidTable& t, int q, int qstep,
                         int g, float* __restrict__ out, uint8_t* ring) {
    constexpr int PP = qmv_parts<KIND>();
    constexpr int bpb = kind_sb_bytes(KIND);
    constexpr int R = QID_R, NB = QID_NB;
    constexpr bool RING = qid_ring(KIND);
    constexpr int RUN = (QMV_SB_STEP * bpb + 31) / 16 * 16;  // a row's step in the ring
    constexpr int STAGE = R * RUN;
    const int lane = threadIdx.x & 31;
    const int sub = lane >> 3;  // which of the step's four superblocks
    const int i = lane & 7;     // slice slot within the superblock
    const int nsb = (K + QK_K - 1) / QK_K;
    const int steps = (nsb + QMV_SB_STEP - 1) / QMV_SB_STEP;
    const int P = t.passes, row0 = g * R;
    if (q >= P || row0 >= N) return;
    struct Pass {
        const uint8_t* w;  // row row0 of the pass's expert
        int rows;          // its activation rows
        uint2 map;         // those rows, a byte each
    };
    auto pass = [&](int p) {
        Pass m;
        m.w = w + ((size_t)t.exp[p] * N + row0) * row_bytes;
        m.rows = t.cnt[p];
        m.map = *reinterpret_cast<const uint2*>(t.row[p]);
        return m;
    };
    auto srow = [&](const Pass& m, int b) {
        return (int)((b < 4 ? m.map.x >> (8 * b) : m.map.y >> (8 * (b - 4))) & 0xFF);
    };
    auto run = [&](const Pass& m, int r, int st) {  // row r's bytes of step st
        return m.w + (size_t)min(r, N - 1 - row0) * row_bytes + (size_t)st * QMV_SB_STEP * bpb;
    };
    // the ring's copy cursor: step si of pass qi
    int qi = q, si = 0;
    Pass mi = pass(qi);
    auto copy_step = [&](uint8_t* stage) {
        if (qi < P) {
            const int len = min(QMV_SB_STEP, nsb - si * QMV_SB_STEP) * bpb;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const uint8_t* src = run(mi, r, si);
                const uint8_t* al = reinterpret_cast<const uint8_t*>(
                    reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
                const int span = (int)(src - al) + len;  // from the aligned start to the end
                for (int c = lane; 16 * c < span; c += 32)
                    cp_async16_n(stage + r * RUN + 16 * c, al + 16 * c, min(16, span - 16 * c));
            }
            if (++si == steps) {
                si = 0;
                qi += qstep;
                if (qi < P) mi = pass(qi);
            }
        }
        cp_async_commit();
    };
    auto load = [&](const Pass& m, int st, QmvRaw<KIND> (&raw)[R]) {
        const int sb = min(st * QMV_SB_STEP + sub, nsb - 1);
#pragma unroll
        for (int r = 0; r < R; ++r) raw[r] = qmv_raw<KIND>(run(m, r, 0) + (size_t)sb * bpb, i);
    };
    Pass cur = pass(q);
    QmvRaw<KIND> raw[R];
    int slot = 0;
    if constexpr (RING) {
#pragma unroll
        for (int s = 0; s < QID_STAGES - 1; ++s) copy_step(ring + s * STAGE);
    } else {
        load(cur, 0, raw);
    }
    float acc[R][NB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;
    int st = 0;
    while (true) {
        int qn = q, sn = st + 1;
        if (sn == steps) {
            sn = 0;
            qn += qstep;
        }
        const bool more = qn < P;
        const Pass nx = sn == 0 && more ? pass(qn) : cur;
        QmvRaw<KIND> nxt[R];
        const uint8_t* stage = ring + slot * STAGE;
        if constexpr (RING) {
            cp_async_wait<QID_STAGES - 2>();
            __syncwarp();  // every lane's copies of this step landed; the last step's reads done
            copy_step(ring + (slot == 0 ? QID_STAGES - 1 : slot - 1) * STAGE);
            slot = slot + 1 == QID_STAGES ? 0 : slot + 1;
        } else if (more) {
            load(nx, sn, nxt);
        }
        const int sb = st * QMV_SB_STEP + sub;
        if (sb < nsb && (!kind_block32(KIND) || sb * QK_K + 32 * i < K)) {
            float lv[R][QMV_SLICE], sc[R][PP], mn[R][PP];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if constexpr (RING) {
                    const int off = (int)(reinterpret_cast<uintptr_t>(run(cur, r, st)) & 15);
                    qmv_levels<KIND>(qmv_raw<KIND>(stage + r * RUN + off + sub * bpb, i), i,
                                     lv[r], sc[r], mn[r]);
                } else {
                    qmv_levels<KIND>(raw[r], i, lv[r], sc[r], mn[r]);
                }
            }
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                if (b >= cur.rows) break;
                float xv[QMV_SLICE], sx[PP];
                x_slice<KIND>(x + (size_t)srow(cur, b) * K + (size_t)sb * QK_K, i, xv);
                x_part_sums<KIND>(xv, sx);
#pragma unroll
                for (int r = 0; r < R; ++r)
                    acc[r][b] = qmv_fold<KIND>(lv[r], xv, sc[r], mn[r], sx, acc[r][b]);
            }
        }
        if (sn == 0) {  // the pass's last step: reduce across the warp and store
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                if (b >= cur.rows) break;
                float* o = out + (size_t)srow(cur, b) * N + row0;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float v = warp_sum(acc[r][b]);
                    if (lane == 0 && row0 + r < N) o[r] = v;
                    acc[r][b] = 0.f;
                }
            }
        }
        if (!more) break;
        if constexpr (!RING) {
#pragma unroll
            for (int r = 0; r < R; ++r) raw[r] = nxt[r];
        }
        cur = nx;
        q = qn;
        st = sn;
    }
    if constexpr (RING) cp_async_wait<0>();
}

// A block per (QID_TILE weight rows, pass slot y of gridDim.y): its warps
// walk passes y, y + gridDim.y, ... of the table each block builds.
template <typename TX, int KSET>
__global__ void __launch_bounds__(QMV_WARPS * 32, 4)
qid_group_kernel(const uint8_t* __restrict__ w, const TX* __restrict__ x,
                 const int* __restrict__ ids, float* __restrict__ out, int kind, int n_exp, int S,
                 int N, int K, int row_bytes) {
    __shared__ QidTable t;
    extern __shared__ __align__(16) uint8_t rings[];  // QID_RING_BYTES a warp, for a ring kind
    qid_table(ids, S, n_exp, N, t, out);
    const int g = (int)blockIdx.x * QMV_WARPS + (int)(threadIdx.x >> 5);
    qid_dispatch<KSET>(kind, [&](auto k) {
        qid_walk<decltype(k)::value, TX>(w, N, row_bytes, x, K, t, blockIdx.y, gridDim.y, g, out,
                                         rings + (threadIdx.x >> 5) * QID_RING_BYTES);
    });
}

// ---------------------------------------------------------------------------
// qmv_id's instantiations (Q8_0 and Q5_K stacks take KS_ALL's kernel)
constexpr unsigned QMV_ID_SETS = 1u << KS_Q4K_Q6K | 1u << KS_ALL | 1u << KS_IQ | 1u << KS_IQ_LOW;

struct QidArgs {
    const uint8_t* w;
    const int* ids;
    float* out;
    int kind, n_exp, S, N, K, row_bytes;
};

template <typename TX, int KSET>
static void launch_k(const QidArgs& a, const TX* x, bool group, cudaStream_t s) {
    const int tiles = (a.N + QID_TILE - 1) / QID_TILE;
    if (group)  // a ring kind's launch alone takes the rings' shared memory
        qid_group_kernel<TX, KSET><<<dim3(tiles, min(a.S, QID_PASS_SLOTS)), QMV_WARPS * 32,
                                     qid_ring(a.kind) ? QMV_WARPS * QID_RING_BYTES : 0, s>>>(
            a.w, x, a.ids, a.out, a.kind, a.n_exp, a.S, a.N, a.K, a.row_bytes);
    else
        qid_rows_kernel<TX, KSET><<<dim3(a.S, tiles), QMV_WARPS * 32, 0, s>>>(
            a.w, x, a.ids, a.out, a.kind, a.n_exp, a.N, a.K, a.row_bytes);
}

template <typename TX>
static void launch_x(const QidArgs& a, const void* x, int set, bool group, cudaStream_t s) {
    const TX* xt = static_cast<const TX*>(x);
    if (set == KS_Q4K_Q6K) launch_k<TX, KS_Q4K_Q6K>(a, xt, group, s);
    else if (set == KS_IQ) launch_k<TX, KS_IQ>(a, xt, group, s);
    else if (set == KS_IQ_LOW) launch_k<TX, KS_IQ_LOW>(a, xt, group, s);
    else launch_k<TX, KS_ALL>(a, xt, group, s);
}

// x [S, K] (f32 or bf16, contiguous); w [n_exp * N, ceil(K/256) runs] of
// `kind` (any; K a multiple of 256, or of 32 for a 32-weight-block kind,
// rows padded to a whole run); ids [S] int32 on the device; out [S, N] f32.
// group 1: rows grouped by expert (2 <= S <= QID_GROUP_MAX); 0: a block per
// row.
LCG_EXPORT int lcg_qmv_id(const void* x, int x_dtype, int S, int K, const void* w, int kind,
                          int n_exp, int N, const void* ids, void* out, int group,
                          void* stream) {
    if (S < 1 || S > 65535 || !k_fits(K, &kind, 1) || n_exp < 1 || N < 1 ||
        (N + QID_TILE - 1) / QID_TILE > 65535 || kind_sb_bytes(kind) == 0 ||
        (x_dtype != DT_F32 && x_dtype != DT_BF16) || (group && (S < 2 || S > QID_GROUP_MAX)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int set = launch_set(&kind, 1, QMV_ID_SETS);
    if (set < 0) return static_cast<int>(cudaErrorInvalidValue);
    const QidArgs a{static_cast<const uint8_t*>(w), static_cast<const int*>(ids),
                    static_cast<float*>(out), kind, n_exp, S, N, K,
                    ((K + QK_K - 1) / QK_K) * kind_sb_bytes(kind)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == DT_BF16)
        launch_x<__nv_bfloat16>(a, x, set, group != 0, s);
    else
        launch_x<float>(a, x, set, group != 0, s);
    return static_cast<int>(cudaGetLastError());
}

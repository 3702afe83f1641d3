// Hopper building blocks shared by the int8 prefill GEMM (qmm_i8.cu, K13)
// and the MoE grouped GEMM (qgemm_id.cu, K11): mbarriers, TMA tile loads,
// the 128-byte-swizzled shared-memory layout and its wgmma descriptor, and
// the warpgroup MMA shapes the kernels issue. sm_90a only (wgmma).
//
// Layout: a K-major operand tile is R rows of 128 bytes (128 int8 or 64 bf16
// columns). Row r's 16-byte chunk q sits at r * 128 + ((q ^ (r & 7)) * 16),
// the layout TMA writes under CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads
// with layout type 1 (SWIZZLE_128B): 8-row atoms of 1024 bytes, the tile
// base 1024-byte aligned. A k step of 32 bytes inside the 128-byte row moves
// the descriptor's start address by 32 bytes (the hardware applies the XOR
// to the absolute address bits).
#pragma once

#include "common.cuh"

// ---------------------------------------------------------------------------
// mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and add `bytes` to the transaction count of the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as complete: parity 1 passes at once).
// A wait that outlasts ~2^34 clocks (seconds) traps: a launch fault the
// caller sees, not a card that never comes back.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    long long start = -1;
    for (;;) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        const long long now = clock64();
        if (start < 0) start = now;
        else if (now - start > (1ll << 34)) __trap();
    }
}

// Generic-proxy writes to shared memory (cp.async) made visible to the
// async proxy (wgmma operand reads): the reader fences once the barrier
// that counts the landed copies has completed, before its wgmma.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA: a box of the 2-D tensor `map` at element coordinates (c0 innermost,
// c1) into shared memory, completion counted in bytes on `bar`. Rows and
// columns past the tensor's edge land as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
           "r"(c0), "r"(c1) : "memory");
}

// Arrive once on `bar` when every cp.async this thread has issued so far
// has landed (the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Synchronise the `count` threads (whole warps) that use named barrier `id`
// (1..15; 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// 16 bytes global -> shared, asynchronously, of which the first `bytes`
// (0..16) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

// ---------------------------------------------------------------------------
// wgmma
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin a register at this point of the program: reads after it cannot move
// above it (accumulators are read only after the wgmma.wait that retires
// their last product).
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r) :: "memory"); }
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r) :: "memory"); }

// Descriptor of a K-major, 128-byte-swizzled tile at shared address p
// (1024-byte aligned atoms): start address >> 4, leading byte offset 1
// (unused by swizzled K-major tiles), stride 1024 bytes between 8-row
// atoms, layout type SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 128] (s32) (+)= a[64 x 32] s8 . b[128 x 32]^T s8, both operands in
// shared memory, K-major. Thread (warp w of the warpgroup, lane 4g + t)
// holds d[i] at row 16w + g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
// 2t + (i & 1). scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
          "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
          "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] (f32) (+)= a[64 x 16] bf16 . b[N x 16]^T bf16 for N = 16 * NCH
// (NCH 1..4: qgemm_id's passes),
// a from registers (the m16n8k16 A fragment of warp w's rows 16w..16w+15:
// a[0] row g cols 2t, 2t+1; a[1] row g + 8; a[2] row g cols 2t + 8, 2t + 9;
// a[3] row g + 8 there), b K-major in shared memory. d as
// wgmma_s8_m64n128k32's: d[i] at row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2t + (i & 1).
template <int NCH>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8 * NCH], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<1>(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<2>(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<3>(float (&d)[24], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<4>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The warpgroup of this thread, as a value the compiler knows to be
// uniform across the warp (a branch on it keeps the warps converged, which
// setmaxnreg needs to take effect).
__device__ __forceinline__ int warpgroup_index() {
    return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// A pointer into dynamic shared memory rounded up to 1024 bytes (swizzled
// tiles); the launcher allocates 1024 bytes more than the kernel uses.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    const uint32_t a = smem_u32(p);
    return p + (((a + 1023u) & ~1023u) - a);
}

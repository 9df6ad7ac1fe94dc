// Hopper (sm_90a) pieces of the attention kernels: 16-byte asynchronous
// copies into swizzled shared memory (`cp.async.cg`), the shared-memory
// matrix descriptors of `wgmma`, and `wgmma.mma_async` with A in registers
// or in shared memory.
//
// Tile layout. A tile is R rows x D bf16 (D = 32 or 64) stored with a row
// stride of 2D bytes under the swizzle of the same width: the 16-byte chunk
// index of a byte offset is XORed with bits 7.. of the offset
// (SWIZZLE_128B for D = 64: chunk ^= row % 8; SWIZZLE_64B for D = 32:
// chunk ^= (row / 2) % 4). Tiles start 1024 bytes apart from a 1024-aligned
// base, so the pattern is the hardware's. One layout serves every product:
//   * K-major (D contiguous, D the depth), e.g. K as B of S = Q K^T, or Q
//     as A from shared memory: a 16-deep step of D advances the
//     descriptor's start by 32 bytes;
//   * MN-major (D contiguous, rows the depth), e.g. V as B of O = P V, read
//     with the transpose bit: a 16-row step advances it by 16 rows.
// In both, the 8-row groups lie 8 * 2D bytes apart (the descriptor's stride
// byte offset); the leading byte offset is unused (one swizzle atom wide).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile of
// rows D bf16 wide (relative to a 1024-aligned base).
template <int D>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
    constexpr uint32_t MASK = (2 * D) / 16 - 1;  // 7 (128-byte rows) or 3 (64-byte rows)
    const uint32_t off = row * (2 * D) + chunk * 16;
    return off ^ (((off >> 7) & MASK) << 4);
}

// Byte offset of the 32-bit pair at column `col` (even) of row `row`.
template <int D>
__device__ __forceinline__ uint32_t swizzled_pair(int row, int col) {
    return swizzled<D>(row, col >> 3) + (col & 7) * 2;
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// the sum over the four threads of a quad (one fragment row)
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (x + bias) for a pair of bf16: fp32 add, rounded once
__device__ __forceinline__ uint32_t add_pair(uint32_t x, const __nv_bfloat16* bias) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias);
    const __nv_bfloat162 r = __floats2bfloat162_rn(__low2float(v) + __low2float(b),
                                                   __high2float(v) + __high2float(b));
    return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's landed shared-memory writes before later reads by
// `wgmma` (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// This thread's share of copying ROWS x D bf16 into a swizzled tile with NT
// threads, 16 bytes a copy: thread i copies chunk i % (D / 8) of rows
// i / (D / 8) + k * STEP. STEP is a multiple of 8, so every copy of a thread
// has the same swizzle phase: the offsets are computed once per kernel and a
// copy costs an add and the instruction.
template <int D, int NT>
struct TileCopy {
    static constexpr int STEP = NT / (D / 8);  // rows between a thread's copies
    uint32_t smem;    // byte offset of this thread's first chunk in a tile
    size_t gmem;      // element offset of the same in device memory
    size_t step;      // elements between a thread's copies in device memory

    __device__ __forceinline__ TileCopy(size_t row_stride) {
        const int row = threadIdx.x / (D / 8), chunk = threadIdx.x % (D / 8);
        smem = swizzled<D>(row, chunk);
        gmem = (size_t)row * row_stride + chunk * 8;
        step = (size_t)STEP * row_stride;
    }

    // rows [0, ROWS) of the operand whose row 0 is at `src` into the tile at `dst`
    template <int ROWS>
    __device__ __forceinline__ void issue(uint32_t dst, const __nv_bfloat16* src) const {
        static_assert(ROWS % STEP == 0 && STEP % 8 == 0, "whole swizzle periods per copy");
        src += gmem;
#pragma unroll
        for (int k = 0; k < ROWS / STEP; ++k) {
            cp_async16(dst + smem + k * STEP * 2 * D, src + k * step);
        }
    }
};

// wgmma descriptor of the swizzled tile (or 16-deep slice of it) at `addr`.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    constexpr uint64_t LAYOUT = D == 64 ? 1 : 2;     // SWIZZLE_128B : SWIZZLE_64B
    constexpr uint64_t SBO = 8 * 2 * D;              // bytes between 8-row groups
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((SBO >> 4) << 32) |
           (LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence/wait that guards them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x N, fp32) (+)= A(64 x 16, bf16, registers) * B(16 x N, bf16, shared
// memory at `desc`; TRANS_B = 1: MN-major). Registers per thread: the
// m16n8k16 fragments of warp w of the warpgroup for rows 16w..16w+15; d[4j..]
// for columns 8j..8j+7. scale_d = 0 overwrites D.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TRANS_B));
}

// D(64 x 64, fp32) (+)= A(64 x 16, bf16, shared memory at `adesc`, K-major)
// * B(16 x 64, bf16, shared memory at `bdesc`; TRANS_B = 1: MN-major). The
// same register layout of D as above.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t adesc, uint64_t bdesc,
                                         int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TRANS_B));
}

// The product with N = 64 or 32 columns (the accumulator's size picks it).
template <int TRANS_B, int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
    static_assert(R == 32 || R == 16, "m64n64k16 or m64n32k16");
    if constexpr (R == 32) {
        wgmma_m64n64k16<TRANS_B>(d, a, desc, scale_d);
    } else {
        wgmma_m64n32k16<TRANS_B>(d, a, desc, scale_d);
    }
}

}  // namespace

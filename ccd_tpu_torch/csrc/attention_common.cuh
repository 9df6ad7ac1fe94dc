// Pieces shared by the attention kernels (forward and backward): strided
// operands, bf16 tensor-core fragments through `mma.sync.m16n8k16`, and the
// tile loader that adds the qkv bias on the way into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int MAX_GRID_Z = 65535;      // the grid's z extent carries the batch
constexpr int PAD = 8;    // bf16 elements of row padding in shared memory:
                          // rows 16 bytes apart modulo 128, so the fragment
                          // loads below are free of bank conflicts

// One (B, H, S, D) operand of the attention kernels, D contiguous: element
// (b, h, row, d) lies at ptr + b * batch + h * head + row * row_stride + d
// (strides in elements). The packed layout (B, S, 3C) is three operands over
// one buffer, row stride 3C and head offset D; folded (B*H, S, D) tensors
// are H = 1 with row stride D; (B, S, H, D) tensors have row stride H * D
// and head offset D. Rows must start 16 bytes apart and aligned, which the
// callers check.
template <typename T>
struct Operand {
    T* ptr;
    long long batch, row_stride, head;
    __device__ __forceinline__ T* at(int b, int h, size_t row) const {
        return ptr + (size_t)b * batch + (size_t)h * head + row * row_stride;
    }
};

// The operands of one forward call: q, k, v and the output, and a bias per
// input operand (D values per head, head h at offset h * D) or null.
template <typename T>
struct FwdArgs {
    Operand<const T> q, k, v;
    const T* bq;
    const T* bk;
    const T* bv;
    Operand<T> o;
};

// The operands of one backward call: the forward's inputs and biases, the
// output's cotangent, the three gradients, two (B, H, S) fp32 scratch arrays
// that the first kernel fills and the second reads, and the logits' scale.
template <typename T>
struct BwdArgs {
    Operand<const T> q, k, v, dout;
    const T* bq;
    const T* bk;
    const T* bv;
    Operand<T> dq, dk, dv;
    float* lse;
    float* delta;
    float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_bias(const T* bias, int h, int D) {
    return bias ? bias + (size_t)h * D : nullptr;
}

// Operand from a host array of (batch, row, head) strides
template <typename T>
Operand<T> operand(T* ptr, const long long* s) {
    return Operand<T>{ptr, s[0], s[1], s[2]};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices; lane l supplies the address of row l%8
// of matrix l/8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// rows x D bf16 from device memory (row stride `stride` elements) into shared
// memory (row stride D + PAD), 16 bytes per thread and step, bias[D] added on
// the way (fp32 add, rounded to bf16 once, as a bf16 tensor add rounds).
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride,
                                          int rows, const bf16* bias) {
    constexpr int CHUNKS = D / 8;
    for (int i = threadIdx.x; i < rows * CHUNKS; i += blockDim.x) {
        const int r = i / CHUNKS;
        const int c = (i % CHUNKS) * 8;
        uint4 v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * stride + c));
        if (bias != nullptr) {
            uint4 bv = __ldg(reinterpret_cast<const uint4*>(bias + c));
            __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&v);
            const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                pv[j] = __floats2bfloat162_rn(__low2float(pv[j]) + __low2float(pb[j]),
                                              __high2float(pv[j]) + __high2float(pb[j]));
            }
        }
        *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = v;
    }
}

// The A fragments (16 rows x D, row-major in shared memory, row stride
// D + PAD) of the 16 rows starting at `rows16`, for all of D.
template <int D>
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[D / 16][4], const bf16* rows16,
                                                 int g, int t) {
    const bf16* r0 = rows16 + g * (D + PAD) + 2 * t;
    const bf16* r1 = r0 + 8 * (D + PAD);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        a[kk][0] = ld32(r0 + kk * 16);
        a[kk][1] = ld32(r1 + kk * 16);
        a[kk][2] = ld32(r0 + kk * 16 + 8);
        a[kk][3] = ld32(r1 + kk * 16 + 8);
    }
}

// c[j] += A(16 x D) * B^T for the 64 rows of B (row-major in shared memory,
// row stride D + PAD) that start at `brows`: a 16 x 64 tile of A B^T as eight
// m16n8 C fragments, one per octet of B rows.
template <int D>
__device__ __forceinline__ void mma_a_bt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* brows, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const bf16* bp = brows + (j * 8 + g) * (D + PAD) + kk * 16 + 2 * t;
            mma_bf16(c[j], a[kk], ld32(bp), ld32(bp + 8));
        }
    }
}

// acc(16 x D) += P(16 x 64) * B(64 x D): P is a 16 x 64 fp32 tile held as
// eight C fragments and rounded to bf16 here (the fragments of two octets are
// the A fragment of one 16-deep step); B's 64 rows start at `brows` and its
// fragments come transposed out of shared memory, two D octets per ldmatrix.
template <int D>
__device__ __forceinline__ void mma_p_b(float (&acc)[D / 8][4], const float (&p)[8][4],
                                        const bf16* brows, int lane) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
        const bf16* bp = brows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (D + PAD)
                         + (lane >> 4) * 8;
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, bp + jd * 16);
            mma_bf16(acc[2 * jd], pa, bb[0], bb[1]);
            mma_bf16(acc[2 * jd + 1], pa, bb[2], bb[3]);
        }
    }
}

// One warp stores its 16 x D fp32 accumulator tile (m16n8 C fragments, one
// per column octet), scaled per row, as bf16: through its own 16 rows of
// shared memory `stage` (row stride D + PAD), then 16 bytes a thread to
// `dst` (row stride `dst_stride` elements).
template <int D>
__device__ __forceinline__ void store_warp_tile(bf16* stage, bf16* dst, size_t dst_stride,
                                                const float (&acc)[D / 8][4],
                                                float scale0, float scale1, int lane) {
    constexpr int LD = D + PAD;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(stage + g * LD + j * 8 + 2 * t) =
            pack_bf16(acc[j][0] * scale0, acc[j][1] * scale0);
        *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
            pack_bf16(acc[j][2] * scale1, acc[j][3] * scale1);
    }
    __syncwarp();
    constexpr int CHUNKS = D / 8;
    for (int i = lane; i < 16 * CHUNKS; i += 32) {
        const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
        *reinterpret_cast<uint4*>(dst + (size_t)r * dst_stride + c) =
            *reinterpret_cast<const uint4*>(stage + r * LD + c);
    }
}

}  // namespace

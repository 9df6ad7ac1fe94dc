// Pieces shared by the attention kernels (forward and backward): strided
// operands, the arguments of a call, and what the forward saves for the
// backward.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_GRID_Z = 65535;  // the grid's z extent carries the batch
constexpr int MAX_DEVICES = 64;    // devices whose kernel attributes are cached
constexpr float LOG2E = 1.4426950408889634f;

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

// The operands of one forward call: q, k, v and the output, a bias per
// input operand (D values per head, head h at offset h * D) or null, and a
// (B, H, S) fp32 array for each row's log-sum-exp or null (see below).
template <typename T>
struct FwdArgs {
    Operand<const T> q, k, v;
    const T* bq;
    const T* bk;
    const T* bv;
    Operand<T> o;
    float* lse;
};

// The row statistic the forward saves for the backward, in the units the
// kernels keep their logits: lse[b, h, i] = log2(sum_j 2^(x_ij)) with
// x_ij = (q_i + bq) . k_j * scale * log2(e), the base-2 log-sum-exp of the
// scaled logits WITHOUT the key bias bk (bk adds (q_i + bq) . bk to every
// logit of row i, which the softmax cancels, so no kernel reads it). Then
// p_ij = 2^(x_ij - lse_i).

// The operands of one backward call: the forward's inputs and biases, its
// output o and saved lse (B, H, S), the output's cotangent, the three
// gradients, a (B, H, S) fp32 scratch array that the first kernel fills
// with delta_i = dout_i . (o_i - bv) and the second reads, and the logits'
// scale.
template <typename T>
struct BwdArgs {
    Operand<const T> q, k, v, o, dout;
    const T* bq;
    const T* bk;
    const T* bv;
    Operand<T> dq, dk, dv;
    const float* lse;
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

}  // namespace

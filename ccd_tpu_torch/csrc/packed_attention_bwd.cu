// Backward of multi-head attention for Hopper (sm_90a), on strided operands.
//
// Replaces two Pallas kernels of ccd_tpu/ops/flash_attention.py with one
// device code: `_packed_bwd_kernel` behind the custom VJP of
// `mha_packed_bias` (K1-bwd), and `_bwd_kernel` behind the custom VJP of
// `flash_attention` (K1b-bwd). Each operand is a base pointer with a batch
// stride, a row stride and a per-head column offset
// (attention_common.cuh::Operand). For the packed layout, from the un-biased
// qkv projection (B, S, 3C), its bias (3C,) and the output's cotangent dO
// (B, S, C) it recomputes per head, with q, k, v biased as in the forward,
//
//     P  = softmax(q k^T * scale)                  fp32
//     dP = dO v^T                                  fp32
//     dS = P * (dP - rowsum(dP * P)) * scale       fp32, cast to the input type
//     dq = dS k      dk = dS^T q      dv = P^T dO  (P cast to the input type)
//
// and writes dq | dk | dv at their column offsets of dqkv (B, S, 3C), which is
// the cotangent of the projection's output as it stands: no transposes, and
// nothing of size S x S ever reaches device memory. (The bias' cotangent is
// the sum of dqkv over B and S, taken by the caller.) For folded (B*H, S, D)
// or (B, S, H, D) tensors it reads q, k, v, dO and writes dq, dk, dv where
// they lie, without bias; a folded (768, 256, 64) bf16 call moves
// 7 * 25.2 MB = 176.2 MB, as much as the packed one at B = 128.
//
// What bounds it on an H100: bytes. At (B, S, C, H) = (128, 256, 384, 6) in
// bf16 one call must read qkv (75.5 MB) and dO (25.2 MB) and write dqkv
// (75.5 MB): 176.2 MB, 0.053 ms at 3.35 TB/s, against 5 products of
// 2*S*S*D flop per head = 32.2 GFLOP, 0.033 ms at 989 TFLOP/s. The TPU
// kernel grids over B and loops over heads inside one block of fast memory;
// here blocks are small and parallel, and dq sums over keys while dk and dv
// sum over query rows, so there are two kernels, deterministic and without
// atomics:
//
//   * dq: one block per (batch, head, 64 query rows), the head's K and V in
//     shared memory. The forward saves nothing but its inputs, so a first
//     pass over the keys finds each row's maximum, sum and rowsum(dP * P)
//     online (as the forward finds its output); a second pass forms dS and
//     accumulates dS k. It leaves the rows' log-sum-exp and rowsum in two
//     (B, H, S) fp32 scratch arrays.
//   * dk, dv: one block per (batch, head, 64 keys), the head's Q and dO in
//     shared memory. It computes the TRANSPOSED tiles k q^T and v dO^T, so
//     that keys are the rows every warp owns and both sums over query rows
//     stay in registers; P^T and dS^T follow from the scratch arrays.
//
// The price of saving nothing: 9 tile products instead of 5, each operand
// tile read from L2 once per 64-row tile of the other side.
//
// bf16 goes through `mma.sync.m16n8k16` (16 rows per warp); fp32 through
// scalar FMA, one row per thread, exact fp32 (no TF32).
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"

namespace {

constexpr int TILE = 64;   // rows per block (queries in dq, keys in dk/dv), 4 warps
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ void zero_tile(float (&c)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) { c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f; }
}

// grid (S / 64, H, B), block 128 threads,
// dynamic shared memory (2 * 64 + 2 * S) * (D + PAD) * 2 bytes.
template <int D>
__global__ void __launch_bounds__(2 * TILE)
attention_bwd_dq_bf16(const BwdArgs<bf16> a, int S) {
    constexpr int LD = D + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // 64 x LD, later the dq tile
    bf16* dOs = Qs + TILE * LD;                    // 64 x LD
    bf16* Ks = dOs + TILE * LD;                    // S x LD
    bf16* Vs = Ks + (size_t)S * LD;                // S x LD

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * TILE;
    const float scale = a.scale;
    load_tile<D>(Qs, a.q.at(b, h, row0), a.q.row_stride, TILE, head_bias(a.bq, h, D));
    load_tile<D>(dOs, a.dout.at(b, h, row0), a.dout.row_stride, TILE, nullptr);
    load_tile<D>(Ks, a.k.at(b, h, 0), a.k.row_stride, S, head_bias(a.bk, h, D));
    load_tile<D>(Vs, a.v.at(b, h, 0), a.v.row_stride, S, head_bias(a.bv, h, D));
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
    uint32_t qa[D / 16][4], da[D / 16][4];
    load_a_fragments<D>(qa, Qs + warp * 16 * LD, g, t);
    load_a_fragments<D>(da, dOs + warp * 16 * LD, g, t);
    const float scale_log2e = scale * LOG2E;

    // pass 1: per row (g and g + 8) the running maximum of the scaled logits
    // (base 2), and this thread's share of sum(e) and sum(e * dP)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
    for (int k0 = 0; k0 < S; k0 += 64) {
        float s[8][4], dp[8][4];
        zero_tile(s);
        zero_tile(dp);
        mma_a_bt<D>(s, qa, Ks + (size_t)k0 * LD, g, t);
        mma_a_bt<D>(dp, da, Vs + (size_t)k0 * LD, g, t);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            s[j][0] *= scale_log2e; s[j][1] *= scale_log2e;
            s[j][2] *= scale_log2e; s[j][3] *= scale_log2e;
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
        m0 = mn0; m1 = mn1;
        l0 *= alpha0; l1 *= alpha1;
        a0 *= alpha0; a1 *= alpha1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float e0 = exp2f(s[j][0] - m0), e1 = exp2f(s[j][1] - m0);
            const float e2 = exp2f(s[j][2] - m1), e3 = exp2f(s[j][3] - m1);
            l0 += e0 + e1;
            l1 += e2 + e3;
            a0 = fmaf(e0, dp[j][0], fmaf(e1, dp[j][1], a0));
            a1 = fmaf(e2, dp[j][2], fmaf(e3, dp[j][3], a1));
        }
    }
    l0 = quad_sum(l0); l1 = quad_sum(l1);
    const float L0 = m0 + log2f(l0), L1 = m1 + log2f(l1);      // log-sum-exp, base 2
    const float dl0 = quad_sum(a0) / l0, dl1 = quad_sum(a1) / l1;  // rowsum(dP * P)
    if (t == 0) {
        const size_t r = ((size_t)b * gridDim.y + h) * S + row0 + warp * 16 + g;
        a.lse[r] = L0; a.lse[r + 8] = L1;
        a.delta[r] = dl0; a.delta[r + 8] = dl1;
    }

    // pass 2: dq = dS k
    float dq[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) { dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f; }
    for (int k0 = 0; k0 < S; k0 += 64) {
        float s[8][4], dp[8][4];
        zero_tile(s);
        zero_tile(dp);
        mma_a_bt<D>(s, qa, Ks + (size_t)k0 * LD, g, t);
        mma_a_bt<D>(dp, da, Vs + (size_t)k0 * LD, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            s[j][0] = exp2f(fmaf(s[j][0], scale_log2e, -L0)) * (dp[j][0] - dl0) * scale;
            s[j][1] = exp2f(fmaf(s[j][1], scale_log2e, -L0)) * (dp[j][1] - dl0) * scale;
            s[j][2] = exp2f(fmaf(s[j][2], scale_log2e, -L1)) * (dp[j][2] - dl1) * scale;
            s[j][3] = exp2f(fmaf(s[j][3], scale_log2e, -L1)) * (dp[j][3] - dl1) * scale;
        }
        mma_p_b<D>(dq, s, Ks + (size_t)k0 * LD, lane);
    }
    // each warp stages its rows over its own 16 rows of the Q tile (only it
    // read them, and they are in registers now)
    store_warp_tile<D>(Qs + warp * 16 * LD, a.dq.at(b, h, row0 + warp * 16), a.dq.row_stride,
                       dq, 1.f, 1.f, lane);
}

// grid (S / 64, H, B), block 128 threads, dynamic shared memory
// (2 * 64 + 2 * S) * (D + PAD) * 2 + 2 * S * 4 bytes. Runs after the dq
// kernel on the same stream and reads its two scratch arrays.
template <int D>
__global__ void __launch_bounds__(2 * TILE)
attention_bwd_dkdv_bf16(const BwdArgs<bf16> a, int S) {
    constexpr int LD = D + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Kt = reinterpret_cast<bf16*>(smem_raw);  // 64 x LD, later the dk tile
    bf16* Vt = Kt + TILE * LD;                     // 64 x LD, later the dv tile
    bf16* Qs = Vt + TILE * LD;                     // S x LD
    bf16* dOs = Qs + (size_t)S * LD;               // S x LD
    float* Ls = reinterpret_cast<float*>(dOs + (size_t)S * LD);  // S
    float* Ds = Ls + S;                                          // S

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * TILE;
    const float scale = a.scale;
    load_tile<D>(Kt, a.k.at(b, h, row0), a.k.row_stride, TILE, head_bias(a.bk, h, D));
    load_tile<D>(Vt, a.v.at(b, h, row0), a.v.row_stride, TILE, head_bias(a.bv, h, D));
    load_tile<D>(Qs, a.q.at(b, h, 0), a.q.row_stride, S, head_bias(a.bq, h, D));
    load_tile<D>(dOs, a.dout.at(b, h, 0), a.dout.row_stride, S, nullptr);
    const size_t note0 = ((size_t)b * gridDim.y + h) * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
        Ls[i] = a.lse[note0 + i];
        Ds[i] = a.delta[note0 + i];
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a_fragments<D>(ka, Kt + warp * 16 * LD, g, t);
    load_a_fragments<D>(va, Vt + warp * 16 * LD, g, t);
    const float scale_log2e = scale * LOG2E;

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
        dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    for (int q0 = 0; q0 < S; q0 += 64) {
        // rows are this warp's 16 keys, columns 64 queries
        float st[8][4], dpt[8][4];
        zero_tile(st);
        zero_tile(dpt);
        mma_a_bt<D>(st, ka, Qs + (size_t)q0 * LD, g, t);
        mma_a_bt<D>(dpt, va, dOs + (size_t)q0 * LD, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = q0 + j * 8 + 2 * t;  // the queries of this thread's two columns
            const float La = Ls[c], Lb = Ls[c + 1], da = Ds[c], db = Ds[c + 1];
            st[j][0] = exp2f(fmaf(st[j][0], scale_log2e, -La));
            st[j][1] = exp2f(fmaf(st[j][1], scale_log2e, -Lb));
            st[j][2] = exp2f(fmaf(st[j][2], scale_log2e, -La));
            st[j][3] = exp2f(fmaf(st[j][3], scale_log2e, -Lb));
            dpt[j][0] = st[j][0] * (dpt[j][0] - da) * scale;
            dpt[j][1] = st[j][1] * (dpt[j][1] - db) * scale;
            dpt[j][2] = st[j][2] * (dpt[j][2] - da) * scale;
            dpt[j][3] = st[j][3] * (dpt[j][3] - db) * scale;
        }
        mma_p_b<D>(dv, st, dOs + (size_t)q0 * LD, lane);   // dv += P^T dO
        mma_p_b<D>(dk, dpt, Qs + (size_t)q0 * LD, lane);   // dk += dS^T q
    }
    store_warp_tile<D>(Kt + warp * 16 * LD, a.dk.at(b, h, row0 + warp * 16), a.dk.row_stride,
                       dk, 1.f, 1.f, lane);
    store_warp_tile<D>(Vt + warp * 16 * LD, a.dv.at(b, h, row0 + warp * 16), a.dv.row_stride,
                       dv, 1.f, 1.f, lane);
}

constexpr int F32_KEYS = 32;     // keys per shared-memory chunk, dq kernel
constexpr int F32_QUERIES = 16;  // queries per shared-memory chunk, dk/dv kernel

// D floats of one row from device memory plus bias, into `dst`
template <int D>
__device__ __forceinline__ void load_row_f32(float* dst, const float* src, const float* bias) {
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        float4 v = __ldg(reinterpret_cast<const float4*>(src + d));
        if (bias != nullptr) {
            float4 bv = __ldg(reinterpret_cast<const float4*>(bias + d));
            v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
        }
        dst[d] = v.x; dst[d + 1] = v.y; dst[d + 2] = v.z; dst[d + 3] = v.w;
    }
}

// `rows` x D floats (row stride `stride`) plus bias into shared memory with
// row stride `ld`, all threads of the block together
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              size_t stride, int rows, const float* bias) {
    for (int i = threadIdx.x; i < rows * (D / 4); i += blockDim.x) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * stride + c));
        if (bias != nullptr) {
            float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c));
            v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
        }
        float* p = dst + r * ld + c;
        p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
    }
}

// D floats from registers to one row of device memory
template <int D>
__device__ __forceinline__ void store_row_f32(float* dst, const float (&x)[D]) {
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        *reinterpret_cast<float4*>(dst + d) = make_float4(x[d], x[d + 1], x[d + 2], x[d + 3]);
    }
}

// grid (S / 64, H, B), block 64 threads; thread r owns query row r of the
// tile: q and dq in registers, its dO row in shared memory (row stride D + 1,
// so the threads' rows fall into different banks).
template <int D>
__global__ void __launch_bounds__(TILE)
attention_bwd_dq_f32(const BwdArgs<float> a, int S) {
    __shared__ __align__(16) float Ks[F32_KEYS * D];
    __shared__ __align__(16) float Vs[F32_KEYS * D];
    __shared__ float dOs[TILE * (D + 1)];
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * TILE;
    const float scale = a.scale;
    const float* bk = head_bias(a.bk, h, D);
    const float* bv = head_bias(a.bv, h, D);

    float q[D];
    load_row_f32<D>(q, a.q.at(b, h, row0 + threadIdx.x), head_bias(a.bq, h, D));
    load_rows_f32<D>(dOs, D + 1, a.dout.at(b, h, row0), a.dout.row_stride, TILE, nullptr);
    const float* dO = dOs + threadIdx.x * (D + 1);

    // pass 1: the row's maximum, sum(e) and sum(e * dP), online
    float m = -INFINITY, l = 0.f, acc = 0.f;
    for (int k0 = 0; k0 < S; k0 += F32_KEYS) {
        __syncthreads();  // the previous chunk is no longer read (and dOs is written)
        load_rows_f32<D>(Ks, D, a.k.at(b, h, k0), a.k.row_stride, F32_KEYS, bk);
        load_rows_f32<D>(Vs, D, a.v.at(b, h, k0), a.v.row_stride, F32_KEYS, bv);
        __syncthreads();
        for (int j = 0; j < F32_KEYS; ++j) {
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                s = fmaf(q[d], Ks[j * D + d], s);
                dp = fmaf(dO[d], Vs[j * D + d], dp);
            }
            s *= scale;
            const float mn = fmaxf(m, s);
            const float alpha = expf(m - mn), e = expf(s - mn);
            m = mn;
            l = fmaf(l, alpha, e);
            acc = fmaf(acc, alpha, e * dp);
        }
    }
    const float L = m + logf(l), dl = acc / l;
    const size_t note = ((size_t)b * gridDim.y + h) * S + row0 + threadIdx.x;
    a.lse[note] = L;
    a.delta[note] = dl;

    // pass 2: dq = dS k
    float dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    for (int k0 = 0; k0 < S; k0 += F32_KEYS) {
        __syncthreads();
        load_rows_f32<D>(Ks, D, a.k.at(b, h, k0), a.k.row_stride, F32_KEYS, bk);
        load_rows_f32<D>(Vs, D, a.v.at(b, h, k0), a.v.row_stride, F32_KEYS, bv);
        __syncthreads();
        for (int j = 0; j < F32_KEYS; ++j) {
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                s = fmaf(q[d], Ks[j * D + d], s);
                dp = fmaf(dO[d], Vs[j * D + d], dp);
            }
            const float ds = expf(s * scale - L) * (dp - dl) * scale;
#pragma unroll
            for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, Ks[j * D + d], dq[d]);
        }
    }
    store_row_f32<D>(a.dq.at(b, h, row0 + threadIdx.x), dq);
}

// grid (S / 64, H, B), block 64 threads; thread r owns key row r of the
// tile: its k and v rows in shared memory (row stride D + 1), dk and dv in
// registers; queries stream through shared memory 16 at a time.
template <int D>
__global__ void __launch_bounds__(TILE)
attention_bwd_dkdv_f32(const BwdArgs<float> a, int S) {
    __shared__ float Kt[TILE * (D + 1)];
    __shared__ float Vt[TILE * (D + 1)];
    __shared__ __align__(16) float Qc[F32_QUERIES * D];
    __shared__ __align__(16) float dOc[F32_QUERIES * D];
    __shared__ float Lc[F32_QUERIES], Dc[F32_QUERIES];
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * TILE;
    const float scale = a.scale;
    load_rows_f32<D>(Kt, D + 1, a.k.at(b, h, row0), a.k.row_stride, TILE,
                     head_bias(a.bk, h, D));
    load_rows_f32<D>(Vt, D + 1, a.v.at(b, h, row0), a.v.row_stride, TILE,
                     head_bias(a.bv, h, D));
    const float* k = Kt + threadIdx.x * (D + 1);
    const float* v = Vt + threadIdx.x * (D + 1);
    const float* bq = head_bias(a.bq, h, D);
    const size_t note0 = ((size_t)b * gridDim.y + h) * S;

    float dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) { dk[d] = 0.f; dv[d] = 0.f; }
    for (int q0 = 0; q0 < S; q0 += F32_QUERIES) {
        __syncthreads();  // the previous chunk is no longer read (and Kt, Vt are written)
        load_rows_f32<D>(Qc, D, a.q.at(b, h, q0), a.q.row_stride, F32_QUERIES, bq);
        load_rows_f32<D>(dOc, D, a.dout.at(b, h, q0), a.dout.row_stride, F32_QUERIES, nullptr);
        if (threadIdx.x < F32_QUERIES) {
            Lc[threadIdx.x] = a.lse[note0 + q0 + threadIdx.x];
            Dc[threadIdx.x] = a.delta[note0 + q0 + threadIdx.x];
        }
        __syncthreads();
        for (int i = 0; i < F32_QUERIES; ++i) {
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                s = fmaf(k[d], Qc[i * D + d], s);
                dp = fmaf(v[d], dOc[i * D + d], dp);
            }
            const float p = expf(s * scale - Lc[i]);
            const float ds = p * (dp - Dc[i]) * scale;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                dk[d] = fmaf(ds, Qc[i * D + d], dk[d]);
                dv[d] = fmaf(p, dOc[i * D + d], dv[d]);
            }
        }
    }
    store_row_f32<D>(a.dk.at(b, h, row0 + threadIdx.x), dk);
    store_row_f32<D>(a.dv.at(b, h, row0 + threadIdx.x), dv);
}

template <int D>
int launch_bf16(const BwdArgs<bf16>& a, int B, int S, int H, cudaStream_t stream) {
    const size_t smem_dq = (size_t)(2 * TILE + 2 * S) * (D + PAD) * sizeof(bf16);
    const size_t smem_dkdv = smem_dq + 2 * (size_t)S * sizeof(float);
    if (smem_dkdv > SMEM_LIMIT) return -2;
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_dq);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(attention_bwd_dkdv_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(S / TILE, H, B);
    attention_bwd_dq_bf16<D><<<grid, 2 * TILE, smem_dq, stream>>>(a, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_bf16<D><<<grid, 2 * TILE, smem_dkdv, stream>>>(a, S);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const BwdArgs<float>& a, int B, int S, int H, cudaStream_t stream) {
    dim3 grid(S / TILE, H, B);
    attention_bwd_dq_f32<D><<<grid, TILE, 0, stream>>>(a, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_f32<D><<<grid, TILE, 0, stream>>>(a, S);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const BwdArgs<T>& a, int B, int S, int H, int D, cudaStream_t st) {
    if (B > MAX_GRID_Z) return -3;
    if constexpr (sizeof(T) == 2) {
        if (D == 64) return launch_bf16<64>(a, B, S, H, st);
        if (D == 32) return launch_bf16<32>(a, B, S, H, st);
    } else {
        if (D == 64) return launch_f32<64>(a, B, S, H, st);
        if (D == 32) return launch_f32<32>(a, B, S, H, st);
    }
    return -1;
}

template <typename T>
int packed_backward(const void* qkv, const void* bias, const void* dout, void* dqkv,
                    void* lse, void* delta, int B, int S, int H, int D, float scale,
                    cudaStream_t st) {
    const long long C = (long long)H * D;
    const T* x = static_cast<const T*>(qkv);
    const T* bb = static_cast<const T*>(bias);
    T* dx = static_cast<T*>(dqkv);
    const long long in[3] = {S * 3 * C, 3 * C, D}, o[3] = {S * C, C, D};
    BwdArgs<T> a{operand(x, in), operand(x + C, in), operand(x + 2 * C, in),
                 operand(static_cast<const T*>(dout), o),
                 bb, bb ? bb + C : nullptr, bb ? bb + 2 * C : nullptr,
                 operand(dx, in), operand(dx + C, in), operand(dx + 2 * C, in),
                 static_cast<float*>(lse), static_cast<float*>(delta), scale};
    return launch(a, B, S, H, D, st);
}

template <typename T>
int strided_backward(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, void* lse, void* delta, const long long* strides,
                     int B, int S, int H, int D, float scale, cudaStream_t st) {
    BwdArgs<T> a{operand(static_cast<const T*>(q), strides),
                 operand(static_cast<const T*>(k), strides + 3),
                 operand(static_cast<const T*>(v), strides + 6),
                 operand(static_cast<const T*>(dout), strides + 9),
                 nullptr, nullptr, nullptr,
                 operand(static_cast<T*>(dq), strides + 12),
                 operand(static_cast<T*>(dk), strides + 15),
                 operand(static_cast<T*>(dv), strides + 18),
                 static_cast<float*>(lse), static_cast<float*>(delta), scale};
    return launch(a, B, S, H, D, st);
}

}  // namespace

// The entries below launch both kernels on `stream`, do not synchronise, and
// return the CUDA error code of the launches (0 = success), -1 for an
// unsupported D, -2 when one head's rows exceed shared memory, -3 when B
// exceeds the grid. Tensors are of one type: is_bf16 = 1 for bfloat16, 0 for
// float32. lse and delta are (B, H, S) fp32 scratch that the first kernel
// fills and the second reads. D is 32 or 64 and S a multiple of 64; the
// caller checks both, and the alignment.

// K1-bwd. qkv and dqkv (B, S, 3*H*D), dout (B, S, H*D) contiguous, bias
// (3*H*D,) or null.
extern "C" int packed_attention_backward(const void* qkv, const void* bias, const void* dout,
                                         void* dqkv, void* lse, void* delta,
                                         int B, int S, int H, int D, int is_bf16,
                                         float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? packed_backward<bf16>(qkv, bias, dout, dqkv, lse, delta, B, S, H, D, scale, st)
        : packed_backward<float>(qkv, bias, dout, dqkv, lse, delta, B, S, H, D, scale, st);
}

// K1b-bwd. q, k, v, dout, dq, dk and dv are (B, H, S, D) operands given by
// their base pointers and `strides`, twenty-one element strides: (batch, row,
// head) for each in that order; D is contiguous.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* dout, void* dq, void* dk, void* dv,
                                        void* lse, void* delta, const long long* strides,
                                        int B, int S, int H, int D, int is_bf16, float scale,
                                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? strided_backward<bf16>(q, k, v, dout, dq, dk, dv, lse, delta, strides,
                                            B, S, H, D, scale, st)
                   : strided_backward<float>(q, k, v, dout, dq, dk, dv, lse, delta, strides,
                                             B, S, H, D, scale, st);
}

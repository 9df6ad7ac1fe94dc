// Fused DINO distillation cross-entropy for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas kernels `_fwd_kernel` and `_bwd_kernel` behind
// `fused_dino_row_ce` (ccd_tpu/ops/fused_dino_ce.py). Per row r of the (R, K)
// student logits s and teacher logits t (teacher row r' = r, or
// (r + R/2) mod R with swap_halves: the cross-view pairing done by
// addressing), with the centre c (K,), s' = s / st and t' = (t[r'] - c) / tt:
//
//     forward   ce[r] = -softmax(t') . log_softmax(s')
//     backward  ds[r] = g[r] / st * (softmax(s') - softmax(t')),  in s's type
//
// What bounds both on an H100: bytes. At (R, K) = (3328, 65536) in bf16 the
// forward must read s and t once, 872.4 MB, 0.260 ms at 3.35 TB/s; the
// backward reads both again and writes ds, 1308.6 MB, 0.391 ms. The plain
// chain writes several (R, K) fp32 intermediates instead.
//
// Forward: one pass over K with 16-byte loads and fp32 arithmetic in
// registers, one block per row; every thread keeps the five running
// statistics of its share of the row (maximum and sum of exp for s' and for
// t', and sum(exp(t' - max) * s')), rescaled online whenever a maximum grows,
// and the block merges them at the end with the same rescaling. It leaves the
// five per row in `stats` (5, R): max s', sum_s, max t', sum_t, sum(p * s').
// The TPU kernel walks K as a sequential grid axis with the statistics in
// scratch memory; here that walk is the loop inside the block.
//
// Backward: a streaming pass that moves its 1308.6 MB at the rate the card
// gives a two-reads-one-write stream, with little else in the way:
//   * a block is (a K slice of 256 threads x 16 bytes) x (4 consecutive rows),
//     and the slices vary fastest in the grid, so the blocks in flight cover
//     whole consecutive rows and the card sweeps s, t and ds in order as one
//     elementwise call does (blocks that walk tens of rows down one slice,
//     or a whole row each, spread the traffic over the arrays and stream
//     slower);
//   * all four rows' 16-byte loads of s and t are issued before any of their
//     arithmetic (128 bytes a thread in flight, four blocks an SM): registers
//     hold them, and no shared-memory ring is needed to cover the latency;
//   * a thread reads its 16 bytes' worth of the centre once for the four rows,
//     pre-scaled to -c log2(e) / tt, not once a row;
//   * each row's constants are folded once, in base 2, by one thread each into
//     shared memory: b_s = max s' log2(e) + log2(sum_s), likewise b_t, and
//     g / st; then p_s = ex2(s a_s - b_s) (a_s = log2(e) / st) and
//     p_t = ex2(t a_t - c a_t - b_t): a multiply-add (and an add) and one
//     ex2.approx per exponential;
//   * s and t are read with ld.global.cs and ds written with st.global.cs:
//     each byte is touched once.
// What is left is the memory system: the kernel streams within a few per
// cent of torch.add on the same (R, K) pair, which moves the same bytes.
//
// Rows need no particular length: rows whose byte length and base address are
// multiples of 16 take the vector path, any other K the scalar path (one
// element a thread, the same design).
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/fused_dino_ce.py.


#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;  // the running maxima start here, as the TPU kernel's _NEG

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

// 16 bytes of T from `p` as floats
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&x)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        x[2 * j] = __low2float(h[j]);
        x[2 * j + 1] = __high2float(h[j]);
    }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// running statistics of a part of one row
struct Stats {
    float m_s, l_s, m_t, l_t, acc;
};

// N more elements (already s' and t') into the statistics
template <int N>
__device__ __forceinline__ void absorb(Stats& st, const float (&s)[N], const float (&t)[N]) {
    float cm_s = s[0], cm_t = t[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
        cm_s = fmaxf(cm_s, s[j]);
        cm_t = fmaxf(cm_t, t[j]);
    }
    if (cm_s > st.m_s) {
        st.l_s *= __expf(st.m_s - cm_s);
        st.m_s = cm_s;
    }
    if (cm_t > st.m_t) {
        const float r = __expf(st.m_t - cm_t);
        st.l_t *= r;
        st.acc *= r;
        st.m_t = cm_t;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
        st.l_s += __expf(s[j] - st.m_s);
        const float p = __expf(t[j] - st.m_t);
        st.l_t += p;
        st.acc = fmaf(p, s[j], st.acc);
    }
}

__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
    Stats o;
    o.m_s = fmaxf(a.m_s, b.m_s);
    o.l_s = a.l_s * __expf(a.m_s - o.m_s) + b.l_s * __expf(b.m_s - o.m_s);
    o.m_t = fmaxf(a.m_t, b.m_t);
    const float ra = __expf(a.m_t - o.m_t), rb = __expf(b.m_t - o.m_t);
    o.l_t = a.l_t * ra + b.l_t * rb;
    o.acc = a.acc * ra + b.acc * rb;
    return o;
}

__device__ __forceinline__ Stats shuffle_xor(const Stats& a, int lane_mask) {
    Stats o;
    o.m_s = __shfl_xor_sync(0xffffffffu, a.m_s, lane_mask);
    o.l_s = __shfl_xor_sync(0xffffffffu, a.l_s, lane_mask);
    o.m_t = __shfl_xor_sync(0xffffffffu, a.m_t, lane_mask);
    o.l_t = __shfl_xor_sync(0xffffffffu, a.l_t, lane_mask);
    o.acc = __shfl_xor_sync(0xffffffffu, a.acc, lane_mask);
    return o;
}

// grid R, block THREADS. VEC: rows are read 16 bytes a thread.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dino_ce_forward(const T* __restrict__ s, const T* __restrict__ t, const float* __restrict__ c,
                float* __restrict__ ce, float* __restrict__ stats, int R, int K, int t_shift,
                float inv_tt, float inv_st) {
    const int r = blockIdx.x;
    const int rt = (r + t_shift) % R;
    const T* srow = s + (size_t)r * K;
    const T* trow = t + (size_t)rt * K;
    Stats st = {NEG, 0.f, NEG, 0.f, 0.f};
    if constexpr (VEC) {
        constexpr int N = Vec<T>::N;
        for (int k = threadIdx.x * N; k < K; k += THREADS * N) {
            float sv[N], tv[N], cv[N];
            load16(srow + k, sv);
            load16(trow + k, tv);
#pragma unroll
            for (int j = 0; j < N; j += 4) {
                const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + k + j));
                cv[j] = c4.x; cv[j + 1] = c4.y; cv[j + 2] = c4.z; cv[j + 3] = c4.w;
            }
#pragma unroll
            for (int j = 0; j < N; ++j) {
                sv[j] *= inv_st;
                tv[j] = (tv[j] - cv[j]) * inv_tt;
            }
            absorb<N>(st, sv, tv);
        }
    } else {
        for (int k = threadIdx.x; k < K; k += THREADS) {
            const float sv[1] = {to_float(srow[k]) * inv_st};
            const float tv[1] = {(to_float(trow[k]) - c[k]) * inv_tt};
            absorb<1>(st, sv, tv);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) st = merge(st, shuffle_xor(st, off));
    __shared__ Stats parts[THREADS / 32];
    if ((threadIdx.x & 31) == 0) parts[threadIdx.x >> 5] = st;
    __syncthreads();
    if (threadIdx.x == 0) {
        st = parts[0];
        for (int w = 1; w < THREADS / 32; ++w) st = merge(st, parts[w]);
        const float lse = __logf(st.l_s) + st.m_s;
        ce[r] = -(st.acc / st.l_t - lse);
        stats[r] = st.m_s;
        stats[(size_t)R + r] = st.l_s;
        stats[2 * (size_t)R + r] = st.m_t;
        stats[3 * (size_t)R + r] = st.l_t;
        stats[4 * (size_t)R + r] = st.acc;
    }
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BWD_ROWS = 4;  // rows a backward block takes, their loads all in flight at once

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 16 streamed bytes as floats: 4 fp32, or 8 bf16
__device__ __forceinline__ void unpack(const uint4& v, float (&x)[4]) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&x)[8]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        x[2 * j] = __uint_as_float(w[j] << 16);
        x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
}

__device__ __forceinline__ uint4 pack(const float (&x)[4]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
}

__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    return v;
}

// one streamed element
__device__ __forceinline__ float load_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_stream(const bf16* p) {
    return __uint_as_float(static_cast<unsigned>(__ldcs(reinterpret_cast<const unsigned short*>(p)))
                           << 16);
}
__device__ __forceinline__ void store_stream(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void store_stream(bf16* p, float x) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// grid (K slices, row groups of BWD_ROWS), block THREADS; a block takes row
// group blockIdx.y, then every gridDim.y-th after it. VEC: rows are read 16
// bytes a thread, else one element. a_s = log2(e) / st, a_t = log2(e) / tt.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dino_ce_backward(const T* __restrict__ s, const T* __restrict__ t, const float* __restrict__ c,
                 const float* __restrict__ g, const float* __restrict__ stats,
                 T* __restrict__ ds, int R, int K, int t_shift, float a_s, float a_t,
                 float inv_st) {
    constexpr int N = VEC ? Vec<T>::N : 1;
    constexpr int U = BWD_ROWS;
    __shared__ float4 row_consts[U];  // -b_s, -b_t, g / st
    const int k = (blockIdx.x * THREADS + threadIdx.x) * N;
    const bool live = k < K;  // K % N == 0 on the vector path
    float nc[N];              // -c a_t
    if (live) {
        if constexpr (VEC) {
#pragma unroll
            for (int j = 0; j < N; j += 4) {
                const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + k + j));
                nc[j] = -c4.x * a_t; nc[j + 1] = -c4.y * a_t;
                nc[j + 2] = -c4.z * a_t; nc[j + 3] = -c4.w * a_t;
            }
        } else {
            nc[0] = -__ldg(c + k) * a_t;
        }
    }
    for (int r0 = blockIdx.y * U; r0 < R; r0 += gridDim.y * U) {
        const int n = min(U, R - r0);
        __syncthreads();  // the previous group's constants are read
        if (threadIdx.x < n) {
            const int r = r0 + threadIdx.x;
            row_consts[threadIdx.x] = make_float4(
                -fmaf(stats[r], LOG2E, log2f(stats[static_cast<size_t>(R) + r])),
                -fmaf(stats[2 * static_cast<size_t>(R) + r], LOG2E,
                      log2f(stats[3 * static_cast<size_t>(R) + r])),
                g[r] * inv_st, 0.f);
        }
        __syncthreads();
        if (!live) continue;
        if constexpr (VEC) {
            uint4 sv[U], tv[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (u < n) {
                    int rt = r0 + u + t_shift;
                    rt -= rt >= R ? R : 0;
                    sv[u] = __ldcs(reinterpret_cast<const uint4*>(
                        s + static_cast<size_t>(r0 + u) * K + k));
                    tv[u] = __ldcs(reinterpret_cast<const uint4*>(
                        t + static_cast<size_t>(rt) * K + k));
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (u < n) {
                    const float4 rc = row_consts[u];
                    float x[N], y[N];
                    unpack(sv[u], x);
                    unpack(tv[u], y);
#pragma unroll
                    for (int j = 0; j < N; ++j) {
                        const float p_s = ex2(fmaf(x[j], a_s, rc.x));
                        const float p_t = ex2(fmaf(y[j], a_t, nc[j]) + rc.y);
                        x[j] = rc.z * (p_s - p_t);
                    }
                    __stcs(reinterpret_cast<uint4*>(ds + static_cast<size_t>(r0 + u) * K + k),
                           pack(x));
                }
            }
        } else {
            float sv[U], tv[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (u < n) {
                    int rt = r0 + u + t_shift;
                    rt -= rt >= R ? R : 0;
                    sv[u] = load_stream(s + static_cast<size_t>(r0 + u) * K + k);
                    tv[u] = load_stream(t + static_cast<size_t>(rt) * K + k);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (u < n) {
                    const float4 rc = row_consts[u];
                    const float p_s = ex2(fmaf(sv[u], a_s, rc.x));
                    const float p_t = ex2(fmaf(tv[u], a_t, nc[0]) + rc.y);
                    store_stream(ds + static_cast<size_t>(r0 + u) * K + k, rc.z * (p_s - p_t));
                }
            }
        }
    }
}

bool rows_vectorise(const void* a, const void* b, const void* d, const void* c, int K,
                    size_t elem) {
    auto aligned = [](const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; };
    return ((size_t)K * elem) % 16 == 0 && aligned(a) && aligned(b) && aligned(d)
           && aligned(c);
}

template <typename T>
int launch_forward(const void* s, const void* t, const float* c, float* ce, float* stats,
                   int R, int K, int t_shift, float tt, float st, cudaStream_t stream) {
    const T* sp = static_cast<const T*>(s);
    const T* tp = static_cast<const T*>(t);
    if (rows_vectorise(s, t, nullptr, c, K, sizeof(T))) {
        dino_ce_forward<T, true><<<R, THREADS, 0, stream>>>(sp, tp, c, ce, stats, R, K, t_shift,
                                                            1.f / tt, 1.f / st);
    } else {
        dino_ce_forward<T, false><<<R, THREADS, 0, stream>>>(sp, tp, c, ce, stats, R, K, t_shift,
                                                             1.f / tt, 1.f / st);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_backward_as(const T* s, const T* t, const float* c, const float* g,
                       const float* stats, T* ds, int R, int K, int t_shift, float tt, float st,
                       cudaStream_t stream) {
    constexpr int N = VEC ? Vec<T>::N : 1;
    const int slices = (K + THREADS * N - 1) / (THREADS * N);
    // slices vary fastest: the blocks in flight cover whole consecutive rows
    const int groups = std::min((R + BWD_ROWS - 1) / BWD_ROWS, 65535);
    dino_ce_backward<T, VEC><<<dim3(slices, groups), THREADS, 0, stream>>>(
        s, t, c, g, stats, ds, R, K, t_shift, LOG2E / st, LOG2E / tt, 1.f / st);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* s, const void* t, const float* c, const float* g,
                    const float* stats, void* ds, int R, int K, int t_shift, float tt, float st,
                    cudaStream_t stream) {
    const T* sp = static_cast<const T*>(s);
    const T* tp = static_cast<const T*>(t);
    T* dp = static_cast<T*>(ds);
    if (rows_vectorise(s, t, ds, c, K, sizeof(T)))
        return launch_backward_as<T, true>(sp, tp, c, g, stats, dp, R, K, t_shift, tt, st, stream);
    return launch_backward_as<T, false>(sp, tp, c, g, stats, dp, R, K, t_shift, tt, st, stream);
}

template <typename T, bool VEC>
int backward_attributes(int* out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, dino_ce_backward<T, VEC>);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dino_ce_backward<T, VEC>,
                                                            THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.localSizeBytes);
    out[2] = static_cast<int>(fa.sharedSizeBytes);
    out[3] = blocks;
    out[4] = THREADS;
    return 0;
}

}  // namespace

// s, t (R, K) contiguous, of one type: is_bf16 = 1 for bfloat16, 0 for
// float32; c (K,) fp32; ce (R,) and stats (5, R) fp32 outputs. Student row r
// is paired with teacher row (r + t_shift) mod R. Launches on `stream`, does
// not synchronise, returns the CUDA error code of the launch (0 = success).
extern "C" int fused_dino_ce_forward(const void* s, const void* t, const void* c, void* ce,
                                     void* stats, int R, int K, int t_shift, int is_bf16,
                                     float teacher_temp, float student_temp, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* cp = static_cast<const float*>(c);
    float* cep = static_cast<float*>(ce);
    float* sp = static_cast<float*>(stats);
    if (is_bf16) {
        return launch_forward<bf16>(s, t, cp, cep, sp, R, K, t_shift, teacher_temp,
                                    student_temp, st);
    }
    return launch_forward<float>(s, t, cp, cep, sp, R, K, t_shift, teacher_temp, student_temp,
                                 st);
}

// As above, with g (R,) fp32 the cotangent of ce and stats (5, R) as the
// forward left them; writes ds (R, K) in the type of s.
extern "C" int fused_dino_ce_backward(const void* s, const void* t, const void* c,
                                      const void* g, const void* stats, void* ds, int R, int K,
                                      int t_shift, int is_bf16, float teacher_temp,
                                      float student_temp, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* cp = static_cast<const float*>(c);
    const float* gp = static_cast<const float*>(g);
    const float* sp = static_cast<const float*>(stats);
    if (is_bf16) {
        return launch_backward<bf16>(s, t, cp, gp, sp, ds, R, K, t_shift, teacher_temp,
                                     student_temp, st);
    }
    return launch_backward<float>(s, t, cp, gp, sp, ds, R, K, t_shift, teacher_temp,
                                  student_temp, st);
}

// Launch resources of the backward kernel for is_bf16 on its 16-byte (vec =
// 1) or scalar path, into out[0..4]: registers per thread, local (spill)
// bytes per thread, shared memory per block, resident blocks per SM, threads
// per block. Returns 0 or a CUDA error code.
extern "C" int fused_dino_ce_backward_attributes(int is_bf16, int vec, int* out) {
    if (is_bf16) return vec ? backward_attributes<bf16, true>(out)
                            : backward_attributes<bf16, false>(out);
    return vec ? backward_attributes<float, true>(out) : backward_attributes<float, false>(out);
}

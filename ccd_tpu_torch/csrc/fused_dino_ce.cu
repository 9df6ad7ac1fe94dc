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
// What bounds it on an H100: bytes. At (R, K) = (3328, 65536) in bf16 the
// forward must read s and t once, 872.4 MB, 0.260 ms at 3.35 TB/s; the
// backward reads both again and writes ds, 1308.6 MB, 0.391 ms. The plain
// chain writes several (R, K) fp32 intermediates instead. So each kernel
// makes one pass over K with 16-byte loads and fp32 arithmetic in registers:
// one block per row; every thread keeps the five running statistics of its
// share of the row (maximum and sum of exp for s' and for t', and
// sum(exp(t' - max) * s')), rescaled online whenever a maximum grows, and the
// block merges them at the end with the same rescaling. The forward leaves
// the five per row in `stats` (5, R): max s', sum_s, max t', sum_t,
// sum(p * s'); the backward rebuilds both softmaxes from the first four.
// The TPU kernel walks K as a sequential grid axis with the statistics in
// scratch memory; here that walk is the loop inside the block.
//
// Rows need no particular length: rows whose byte length and base address are
// multiples of 16 take the vector path, any other K the scalar path.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/fused_dino_ce.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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

__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float (&x)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// grid R, block THREADS
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dino_ce_backward(const T* __restrict__ s, const T* __restrict__ t, const float* __restrict__ c,
                 const float* __restrict__ g, const float* __restrict__ stats,
                 T* __restrict__ ds, int R, int K, int t_shift, float inv_tt, float inv_st) {
    const int r = blockIdx.x;
    const int rt = (r + t_shift) % R;
    const T* srow = s + (size_t)r * K;
    const T* trow = t + (size_t)rt * K;
    T* drow = ds + (size_t)r * K;
    const float m_s = stats[r], m_t = stats[2 * (size_t)R + r];
    const float inv_ls = 1.f / stats[(size_t)R + r], inv_lt = 1.f / stats[3 * (size_t)R + r];
    const float gs = g[r] * inv_st;
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
                const float p_s = __expf(sv[j] * inv_st - m_s) * inv_ls;
                const float p_t = __expf((tv[j] - cv[j]) * inv_tt - m_t) * inv_lt;
                sv[j] = gs * (p_s - p_t);
            }
            store16(drow + k, sv);
        }
    } else {
        for (int k = threadIdx.x; k < K; k += THREADS) {
            const float p_s = __expf(to_float(srow[k]) * inv_st - m_s) * inv_ls;
            const float p_t = __expf((to_float(trow[k]) - c[k]) * inv_tt - m_t) * inv_lt;
            from_float(drow + k, gs * (p_s - p_t));
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

template <typename T>
int launch_backward(const void* s, const void* t, const float* c, const float* g,
                    const float* stats, void* ds, int R, int K, int t_shift, float tt, float st,
                    cudaStream_t stream) {
    const T* sp = static_cast<const T*>(s);
    const T* tp = static_cast<const T*>(t);
    T* dp = static_cast<T*>(ds);
    if (rows_vectorise(s, t, ds, c, K, sizeof(T))) {
        dino_ce_backward<T, true><<<R, THREADS, 0, stream>>>(sp, tp, c, g, stats, dp, R, K,
                                                             t_shift, 1.f / tt, 1.f / st);
    } else {
        dino_ce_backward<T, false><<<R, THREADS, 0, stream>>>(sp, tp, c, g, stats, dp, R, K,
                                                              t_shift, 1.f / tt, 1.f / st);
    }
    return static_cast<int>(cudaGetLastError());
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

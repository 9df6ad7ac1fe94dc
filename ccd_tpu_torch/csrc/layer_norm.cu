// LayerNorm over the last axis for Hopper (sm_90a), forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA, which
// fuses the casts around it. The port ran it as three passes (a cast to
// fp32, ATen's fp32 LayerNorm, a cast to the compute type), 20 bytes an
// element where 4 do. For each row x (C values) of a (rows, C) input, with
// fp32 parameters w, b:
//
//     mean = sum(x) / C,  var = sum((x - mean)^2) / C,  rstd = 1 / sqrt(var + eps)
//     forward   y = (x - mean) * rstd * w + b                  in y's type
//     backward  xh = (x - mean) * rstd,  g = dy * w
//               dx = rstd * (g - mean(g) - xh * mean(g * xh))  in x's type
//               dw = sum over rows of dy * xh,  db = sum over rows of dy   (fp32)
//
// all arithmetic in fp32; x is bf16 or fp32, y (and dy) bf16 or fp32.
//
// What bounds it on an H100: bytes. A ViT-Small norm at the recognition
// batch, (262144, 384) in bf16, must read x and write y, 403 MB, 0.120 ms at
// 3.35 TB/s, against 8 operations an element (0.015 ms of the fp32 pipe);
// the backward reads x and dy and writes dx, 1.5 times that. So the design
// moves each of those bytes once and keeps everything else in registers:
//   * one warp a row: the row is loaded once with 16-byte loads (8 values a
//     lane a load; C % 8 == 0) into registers, and the mean, then the centred
//     variance, are warp sums over those registers (two exact passes, no
//     E[x^2] - E[x]^2); y is written once, in its own type;
//   * the forward's warps walk the rows with a stride of the whole grid (as
//     many blocks as the card holds at once), and each warp loads its next
//     row before it normalises this one, so two rows of loads are in flight
//     a warp; w and b (a few KB that every warp reads) come from the cache
//     at each row: held in registers they cost a quarter of the warps an SM
//     holds, and the kernel 7 % of its time at (262144, 384);
//   * the fp32 mean and rstd of each row are written only where a gradient
//     is wanted (8 bytes a row);
//   * the backward's dx kernel keeps each lane's share of dw and db in
//     registers over all the rows its warp walks; the block's warps add
//     theirs through shared memory in a fixed order into one fp32 partial row
//     a block (2 x blocks x C floats of scratch, 1-2 % of the pass's bytes),
//     and a second small kernel adds the partials over the blocks, again in
//     a fixed order. No atomics: the same inputs give the same bits.
// Neither kernel synchronises with the host or allocates: the wrapper hands
// in every buffer from torch.empty, and both launch on the caller's stream,
// so they run inside a captured CUDA graph as they do eagerly.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/layer_norm.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int V = 8;          // values a lane loads at once (16 bytes of bf16)
constexpr int MAX_IT = 4;     // loads a lane a row: C <= 32 * V * MAX_IT = 1024
constexpr int WARPS = 4;      // warps a block (both directions)
constexpr int THREADS = 32 * WARPS;
constexpr int SUM_WARPS = 8;  // the partials' reduction: warps a block, 32 columns a block

__device__ __forceinline__ float warp_sum(float v) {
    // a butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// V values from 16 bytes of bf16 or 32 bytes of fp32, as fp32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[V]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[V]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// V fp32 values rounded to nearest even into bf16 (16 bytes), or as fp32 (32 bytes)
__device__ __forceinline__ void store8(bf16* p, const float (&v)[V]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[V]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the row's values this lane holds: vector k = i * 32 + lane for i < IT
template <typename T, int IT>
__device__ __forceinline__ void load_row(const T* row, int lane, int nvec, float (&v)[IT][V]) {
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        const int k = i * 32 + lane;
        if (k < nvec) {
            load8(row + k * V, v[i]);
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j) v[i][j] = 0.f;
        }
    }
}

// the row's mean and rstd from the values in registers (absent vectors hold 0)
template <int IT>
__device__ __forceinline__ void row_stats(const float (&v)[IT][V], int lane, int nvec, float inv_c,
                                          float eps, float& mean, float& rstd) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < IT; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) s += v[i][j];
    mean = warp_sum(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        if (i * 32 + lane < nvec) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float d = v[i][j] - mean;
                q = fmaf(d, d, q);
            }
        }
    }
    rstd = rsqrtf(warp_sum(q) * inv_c + eps);
}

// grid: as many blocks as the card holds at once (at most one warp a row)
template <typename TX, typename TY, int IT>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, TY* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
                      int C, float eps) {
    const int lane = threadIdx.x & 31;
    const int stride = gridDim.x * WARPS;
    const int nvec = C / V;
    const float inv_c = 1.f / static_cast<float>(C);

    int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    float cur[IT][V];
    if (row < rows) load_row(x + static_cast<size_t>(row) * C, lane, nvec, cur);
    for (; row < rows; row += stride) {
        const int next = row + stride;
        float nxt[IT][V];
        if (next < rows) load_row(x + static_cast<size_t>(next) * C, lane, nvec, nxt);
        float mean, rstd;
        row_stats(cur, lane, nvec, inv_c, eps, mean, rstd);
        TY* out = y + static_cast<size_t>(row) * C;
#pragma unroll
        for (int i = 0; i < IT; ++i) {
            const int k = i * 32 + lane;
            if (k < nvec) {
                float o[V], wk[V], bk[V];
                load8(w + k * V, wk);
                load8(b + k * V, bk);
#pragma unroll
                for (int j = 0; j < V; ++j) o[j] = fmaf((cur[i][j] - mean) * rstd, wk[j], bk[j]);
                store8(out + k * V, o);
            }
        }
        if (mean_out != nullptr && lane == 0) {
            mean_out[row] = mean;
            rstd_out[row] = rstd;
        }
#pragma unroll
        for (int i = 0; i < IT; ++i)
#pragma unroll
            for (int j = 0; j < V; ++j) cur[i][j] = nxt[i][j];
    }
}

// dx from the forward's mean and rstd, and one partial row of dw and of db a
// block: partial[0][block][C] (dw), partial[1][block][C] (db). Dynamic shared
// memory: 2 * WARPS * C floats.
template <typename TX, typename TY, int IT>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_kernel(const TX* __restrict__ x, const TY* __restrict__ dy,
                      const float* __restrict__ w, const float* __restrict__ mean,
                      const float* __restrict__ rstd, TX* __restrict__ dx,
                      float* __restrict__ partial, int rows, int C) {
    extern __shared__ float red[];  // [2][WARPS][C]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int stride = gridDim.x * WARPS;
    const int nvec = C / V;
    const float inv_c = 1.f / static_cast<float>(C);
    float dw[IT][V], db[IT][V];
#pragma unroll
    for (int i = 0; i < IT; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) dw[i][j] = db[i][j] = 0.f;

    for (int row = blockIdx.x * WARPS + warp; row < rows; row += stride) {
        const size_t off = static_cast<size_t>(row) * C;
        float xv[IT][V], gv[IT][V];
        load_row(x + off, lane, nvec, xv);
        load_row(dy + off, lane, nvec, gv);
        const float m = mean[row], r = rstd[row];
        float sg = 0.f, sgx = 0.f;
#pragma unroll
        for (int i = 0; i < IT; ++i) {
            float wk[V];
            if (i * 32 + lane < nvec) {
                load8(w + (i * 32 + lane) * V, wk);
            } else {
#pragma unroll
                for (int j = 0; j < V; ++j) wk[j] = 0.f;
            }
#pragma unroll
            for (int j = 0; j < V; ++j) {
                // absent vectors: x = dy = 0, so they add 0 to every sum below
                const float xh = (xv[i][j] - m) * r;
                const float d = gv[i][j];
                dw[i][j] = fmaf(d, xh, dw[i][j]);
                db[i][j] += d;
                const float g = d * wk[j];
                sg += g;
                sgx = fmaf(g, xh, sgx);
                xv[i][j] = xh;
                gv[i][j] = g;
            }
        }
        const float a = warp_sum(sg) * inv_c, c = warp_sum(sgx) * inv_c;
#pragma unroll
        for (int i = 0; i < IT; ++i) {
            const int k = i * 32 + lane;
            if (k < nvec) {
                float o[V];
#pragma unroll
                for (int j = 0; j < V; ++j) o[j] = r * (gv[i][j] - a - xv[i][j] * c);
                store8(dx + off + k * V, o);
            }
        }
    }

    // the block's warps' shares, added in warp order
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        const int k = i * 32 + lane;
        if (k < nvec) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
                red[warp * C + k * V + j] = dw[i][j];
                red[(WARPS + warp) * C + k * V + j] = db[i][j];
            }
        }
    }
    __syncthreads();
    float* pw = partial + static_cast<size_t>(blockIdx.x) * C;
    float* pb = partial + static_cast<size_t>(gridDim.x + blockIdx.x) * C;
    for (int col = threadIdx.x; col < C; col += THREADS) {
        float sw = 0.f, sb = 0.f;
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
            sw += red[k * C + col];
            sb += red[(WARPS + k) * C + col];
        }
        pw[col] = sw;
        pb[col] = sb;
    }
}

// grads[0] = dw (blockIdx.y 0) or grads[1] = db (1) from the partial rows:
// 32 columns a block, its warps each add every SUM_WARPS-th partial row in
// order, then warp 0 adds the warps' sums in order
__global__ void __launch_bounds__(32 * SUM_WARPS)
layer_norm_param_grad_kernel(const float* __restrict__ partial, float* __restrict__ grads,
                             int blocks, int C) {
    __shared__ float sums[SUM_WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    const float* p = partial + static_cast<size_t>(blockIdx.y) * blocks * C;
    float acc = 0.f;
    if (col < C)
        for (int k = warp; k < blocks; k += SUM_WARPS) acc += p[static_cast<size_t>(k) * C + col];
    sums[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && col < C) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < SUM_WARPS; ++k) t += sums[k][lane];
        grads[blockIdx.y * C + col] = t;
    }
}

// the blocks of the forward (or the backward's dx) kernel one SM holds at
// once (no launch, no synchronisation)
template <typename TX, typename TY, int IT>
int blocks_per_sm(bool backward, int C, int* per_sm) {
    const cudaError_t err = backward
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              per_sm, layer_norm_bwd_kernel<TX, TY, IT>, THREADS, 2 * WARPS * C * sizeof(float))
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              per_sm, layer_norm_fwd_kernel<TX, TY, IT>, THREADS, 0);
    return static_cast<int>(err);
}

template <typename TX, typename TY, int IT>
int forward(const void* x, const void* w, const void* b, void* y, void* stats, int rows,
            int C, float eps, int blocks, cudaStream_t stream) {
    float* mean = static_cast<float*>(stats);  // (2, rows): the means, then the rstds
    layer_norm_fwd_kernel<TX, TY, IT><<<blocks, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<TY*>(y), mean, mean == nullptr ? nullptr : mean + rows, rows, C, eps);
    return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY, int IT>
int backward(const void* x, const void* dy, const void* w, const void* stats, void* dx,
             void* partial, void* grads, int rows, int C, int blocks, cudaStream_t stream) {
    const float* mean = static_cast<const float*>(stats);
    layer_norm_bwd_kernel<TX, TY, IT><<<blocks, THREADS, 2 * WARPS * C * sizeof(float), stream>>>(
        static_cast<const TX*>(x), static_cast<const TY*>(dy), static_cast<const float*>(w),
        mean, mean + rows, static_cast<TX*>(dx), static_cast<float*>(partial), rows, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    layer_norm_param_grad_kernel<<<dim3((C + 31) / 32, 2), 32 * SUM_WARPS, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<float*>(grads), blocks, C);
    return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY, int IT>
int attributes(bool backward, int C, int* out) {
    cudaFuncAttributes fa;
    cudaError_t err = backward ? cudaFuncGetAttributes(&fa, layer_norm_bwd_kernel<TX, TY, IT>)
                               : cudaFuncGetAttributes(&fa, layer_norm_fwd_kernel<TX, TY, IT>);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    const int e = blocks_per_sm<TX, TY, IT>(backward, C, &per_sm);
    if (e != 0) return e;
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.localSizeBytes);
    out[2] = static_cast<int>(fa.sharedSizeBytes) + (backward ? 2 * WARPS * C * 4 : 0);
    out[3] = per_sm;
    out[4] = THREADS;
    return 0;
}

// what each C entry does for one (x type, y type, loads a lane a row); one
// switch holds every instantiation
enum Op { FORWARD, BACKWARD, ATTR_FWD, ATTR_BWD };

struct Args {
    const void *x, *w, *b, *dy, *stats_in;
    void *y, *stats, *dx, *partial, *grads;
    int rows, C, blocks;
    float eps;
    int* out;
    cudaStream_t stream;
};

template <typename TX, typename TY, int IT>
int run(Op op, const Args& a) {
    switch (op) {
        case FORWARD:
            return forward<TX, TY, IT>(a.x, a.w, a.b, a.y, a.stats, a.rows, a.C, a.eps, a.blocks,
                                       a.stream);
        case BACKWARD:
            return backward<TX, TY, IT>(a.x, a.dy, a.w, a.stats_in, a.dx, a.partial, a.grads,
                                        a.rows, a.C, a.blocks, a.stream);
        case ATTR_FWD:
            return attributes<TX, TY, IT>(false, a.C, a.out);
        default:
            return attributes<TX, TY, IT>(true, a.C, a.out);
    }
}

template <typename TX, typename TY>
int by_width(Op op, const Args& a) {
    switch ((a.C / V + 31) / 32) {
        case 1: return run<TX, TY, 1>(op, a);
        case 2: return run<TX, TY, 2>(op, a);
        case 3: return run<TX, TY, 3>(op, a);
        default: return run<TX, TY, 4>(op, a);
    }
}

int dispatch(Op op, const Args& a, int x_bf16, int y_bf16) {
    if (a.C < V || a.C > 32 * V * MAX_IT || a.C % V != 0 || a.rows < 0) return -1;
    if (x_bf16) return y_bf16 ? by_width<bf16, bf16>(op, a) : by_width<bf16, float>(op, a);
    return y_bf16 ? by_width<float, bf16>(op, a) : by_width<float, float>(op, a);
}

}  // namespace

// x: (rows, C) bf16 (x_bf16) or fp32, 16-byte aligned, C % 8 == 0, 8 <= C <=
// 1024; w, b: (C,) fp32, 16-byte aligned; y: (rows, C) bf16 (y_bf16) or fp32;
// stats: (2, rows) fp32 (each row's mean, then its rstd), or null (nothing
// saved). blocks: the grid, WARPS rows a block at a time (the wrapper sizes
// it from layer_norm_attributes). Returns the CUDA error code of the launch
// (0 = success), -1 for an unsupported shape.
extern "C" int layer_norm_forward(const void* x, const void* w, const void* b, void* y,
                                  void* stats, int rows, int C, float eps, int blocks,
                                  int x_bf16, int y_bf16, void* stream) {
    if (rows == 0) return 0;
    if (rows < 0 || blocks <= 0) return -1;
    Args a{};
    a.x = x; a.w = w; a.b = b; a.y = y; a.stats = stats;
    a.rows = rows; a.C = C; a.eps = eps; a.blocks = blocks;
    a.stream = static_cast<cudaStream_t>(stream);
    return dispatch(FORWARD, a, x_bf16, y_bf16);
}

// dx (in x's type) and grads ((2, C) fp32: dw, then db) from x, dy (in y's
// type), w and the forward's stats; partial: 2 * blocks * C fp32 scratch, a
// row of dw and of db for each of the grid's blocks (sized as the
// forward's). Two launches: dx with the partial rows, then their sums.
// Returns 0, -1 or the CUDA error code.
extern "C" int layer_norm_backward(const void* x, const void* dy, const void* w,
                                   const void* stats, void* dx, void* partial, void* grads,
                                   int rows, int C, int blocks, int x_bf16, int y_bf16,
                                   void* stream) {
    if (rows <= 0 || blocks <= 0) return -1;
    Args a{};
    a.x = x; a.dy = dy; a.w = w; a.stats_in = stats; a.dx = dx; a.partial = partial;
    a.grads = grads; a.rows = rows; a.C = C; a.blocks = blocks;
    a.stream = static_cast<cudaStream_t>(stream);
    return dispatch(BACKWARD, a, x_bf16, y_bf16);
}

// Launch resources of the forward (backward = 0) or the backward dx kernel
// built for this width and these types, into out[0..4]: registers per
// thread, local (spill) bytes per thread, shared memory per block, resident
// blocks per SM, threads per block. Returns 0, -1 or a CUDA error code.
extern "C" int layer_norm_attributes(int backward, int C, int x_bf16, int y_bf16, int* out) {
    Args a{};
    a.C = C; a.out = out;
    return dispatch(backward ? ATTR_BWD : ATTR_FWD, a, x_bf16, y_bf16);
}

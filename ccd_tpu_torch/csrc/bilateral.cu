// Bilateral filter with cv2 semantics on a disc window, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bilateral_pallas` behind `bilateral_filter`
// (ccd_tpu/data/aug_ops.py). Per sample b of the (B, H, W, 3) fp32 NHWC
// image x, with per-sample scalars gc[b] = -1 / (2 sigma_color^2),
// gs[b] = -1 / (2 sigma_space^2) and rad2[b] (the disc's radius squared):
//
//     out[y, x] = sum_t w_t * x[y + dy, x + dx] / sum_t w_t
//     w_t = exp(gc * cd^2 + gs * (dy^2 + dx^2)),
//     cd  = 255 * sum_c |x[y + dy, x + dx, c] - x[y, x, c]|
//
// over the taps with dy^2 + dx^2 <= R^2 (R = the static max radius, at most
// 5: 81 taps) and, except the centre tap, dy^2 + dx^2 <= rad2[b] (rad2 need
// not be a square: 8 admits (2, 2)); image indices are clamped (edge
// replication). Forward only.
//
// What bounds it on an H100: operations. At (64, 32, 128, 3) the kernel must
// read and write 6.3 MB (0.0019 ms at 3.35 TB/s), but a tap costs at least 11
// fp32 instructions (3 subtractions and 2 additions for the L1 distance, a
// multiply and a multiply-add for the exponent, 3 multiply-adds and an add
// into the sums) and one exponential, up to 81 taps a pixel: with per-sample
// radii 1..5 about 0.003 ms of the fp32 pipe. So the design spends its issue
// slots on those instructions and little else:
//   * the kernel is a template on R (0..5): each tap's offset and d^2 are
//     compile-time constants and every loop unrolls; the per-sample test
//     d^2 <= rad2 is a uniform branch (one radius per block), taken per row
//     of the disc and per tap, so a sample pays for the taps it has;
//   * 255^2 and log2(e) fold into gc, log2(e) into gs: a weight is
//     ex2.approx(gc' * l1 * l1 + gs' * d^2), one multiply, one multiply-add
//     and one special-function op, contracted freely into FMAs (about 12
//     instructions a tap and pixel in all);
//   * each thread filters P = 4 horizontally adjacent pixels: for a row of
//     the disc it loads the P + 2R tile values it needs once, as float4s
//     (r, g, b, 0), and every tap of that row reuses them for all 4 pixels;
//   * a block (four warps, 32 x 16 pixels) stages its halo with 16-byte
//     cp.async copies of the interleaved RGB rows as they lie in memory, all
//     in flight at once, then spreads them into a float4 tile whose layout
//     skips one float4 after every 4 columns, so that the 8 lanes of a
//     quarter warp read 16 bytes each from 8 different bank groups; no
//     division anywhere;
//   * blockIdx.x is the sample, so the blocks an SM holds come from many
//     samples, whose radii differ.
// What is left: a block's heavy warps (radius 5: 4 x 81 taps) run long after
// the light ones are done, and the SFU's 16 lanes an SM take one ex2 per tap
// for every 12 fp32-pipe instructions; the halo's latency and the launch of
// the blocks are paid once each.
// The TPU kernel's move of channels to planes and its -1e30 exponent for
// masked taps are VMEM idioms and are not carried over.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/bilateral.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 5;
constexpr int P = 4;                          // horizontally adjacent pixels a thread
constexpr int TX = 8, TY = 16;                // threads across and down
constexpr int THREADS = TX * TY;              // four warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE_W = TX * P, TILE_H = TY;   // 32 x 16 pixels a block
constexpr int HALO_W = TILE_W + 2 * MAX_R;
constexpr int HALO_H = TILE_H + 2 * MAX_R;
constexpr float LOG2E = 1.4426950408889634f;

// tile column -> float4 slot: one slot skipped after every P columns, so that
// the 8 lanes of a quarter warp, which read one tile row P columns apart,
// fall in 8 different bank groups
__host__ __device__ constexpr int padded(int col) { return col + col / P; }
static_assert(TX % 8 == 0, "a quarter warp reads within one tile row");
constexpr int TROW = padded(HALO_W - 1) + 1;
// floats of one halo row as loaded: 3 per column, up to 3 more in front for
// 16-byte alignment, rounded up to whole float4s
constexpr int STAGE_W = (3 * HALO_W + 3 + 3) / 4 * 4;

__host__ __device__ constexpr int isqrt(int n) {
    int r = 0;
    while ((r + 1) * (r + 1) <= n) ++r;
    return r;
}

// 16 (or 4) bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

struct Sums {
    float n0, n1, n2, den;
};

// The taps of disc row DY for the thread's P pixels. `trow` points at the
// tile row of image row y + DY, at the thread's first pixel's column - R.
template <int R, int DY>
__device__ __forceinline__ void filter_row(const float4* __restrict__ trow,
                                           const float4 (&c)[P], Sums (&acc)[P], float r2,
                                           float gc2, float gs2) {
    constexpr int DXS = isqrt(R * R - DY * DY);  // the row's half-width in the static disc
    float4 v[P + 2 * R];
    // the values some tap of this row reads: j = p + dx + R
#pragma unroll
    for (int j = R - DXS; j < R + P + DXS; ++j) {
        const int near = j < R ? R - j : (j >= R + P ? j - (R + P - 1) : 0);  // least |dx|
        const int d2 = near * near + DY * DY;
        if (d2 == 0 || static_cast<float>(d2) <= r2) v[j] = trow[padded(j)];
    }
#pragma unroll
    for (int dx = -DXS; dx <= DXS; ++dx) {
        const int d2 = DY * DY + dx * dx;
        if (d2 > 0 && !(static_cast<float>(d2) <= r2)) continue;  // uniform per block
        const float kd = gs2 * static_cast<float>(d2);
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const float4 q = v[p + dx + R];
            const float l1 = fabsf(q.x - c[p].x) + fabsf(q.y - c[p].y) + fabsf(q.z - c[p].z);
            const float w = ex2(fmaf(gc2 * l1, l1, kd));
            acc[p].n0 = fmaf(w, q.x, acc[p].n0);
            acc[p].n1 = fmaf(w, q.y, acc[p].n1);
            acc[p].n2 = fmaf(w, q.z, acc[p].n2);
            acc[p].den += w;
        }
    }
}

// rows DY..R of the disc; a row whose every tap lies outside rad2 is skipped
template <int R, int DY>
__device__ __forceinline__ void filter_rows(const float4* __restrict__ tcol,
                                            const float4 (&c)[P], Sums (&acc)[P], float r2,
                                            float gc2, float gs2) {
    if constexpr (DY <= R) {
        if (DY == 0 || static_cast<float>(DY * DY) <= r2)
            filter_row<R, DY>(tcol + DY * TROW, c, acc, r2, gc2, gs2);
        filter_rows<R, DY + 1>(tcol, c, acc, r2, gc2, gs2);
    }
}

// grid (B, ceil(W / TILE_W), ceil(H / TILE_H)), block THREADS. vec: x and
// out 16-byte aligned and W % 4 == 0 (16-byte loads and stores).
template <int R>
__global__ void __launch_bounds__(THREADS)
bilateral_kernel(const float* __restrict__ x, const float* __restrict__ gc,
                 const float* __restrict__ gs, const float* __restrict__ rad2,
                 float* __restrict__ out, int H, int W, int vec) {
    __shared__ __align__(16) float4 tile[HALO_H][TROW];
    __shared__ __align__(16) float stage[HALO_H][STAGE_W];
    constexpr int SH = TILE_H + 2 * R, SW = TILE_W + 2 * R;
    const int b = blockIdx.x;
    const int x0 = blockIdx.y * TILE_W;
    const int y0 = blockIdx.z * TILE_H;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t sample = static_cast<size_t>(b) * H * W * 3;
    const int clo = max(x0 - R, 0);                  // the image columns the halo reads
    const int nf = 3 * (min(x0 + TILE_W + R, W) - clo);

    // 1. the halo's rows as they lie in memory (rows clamped), every copy in
    //    flight at once
    for (int ly = warp; ly < SH; ly += WARPS) {
        const int gy = min(max(y0 - R + ly, 0), H - 1);
        const size_t g0 = sample + (static_cast<size_t>(gy) * W + clo) * 3;
        if (vec) {
            const size_t a0 = g0 & ~static_cast<size_t>(3);
            const int n4 = (static_cast<int>(g0 - a0) + nf + 3) >> 2;
            for (int i = lane; i < n4; i += 32) copy16(&stage[ly][4 * i], x + a0 + 4 * i);
        } else {
            for (int i = lane; i < nf; i += 32) copy4(&stage[ly][i], x + g0 + i);
        }
    }
    copies_wait();
    __syncthreads();
    // 2. one float4 a pixel, columns clamped (edge replication)
    for (int ly = warp; ly < SH; ly += WARPS) {
        const int gy = min(max(y0 - R + ly, 0), H - 1);
        const size_t g0 = sample + (static_cast<size_t>(gy) * W + clo) * 3;
        const int off = vec ? static_cast<int>(g0 & 3) : 0;
        for (int lx = lane; lx < SW; lx += 32) {
            const int gx = min(max(x0 - R + lx, 0), W - 1);
            const float* p = &stage[ly][off + 3 * (gx - clo)];
            tile[ly][padded(lx)] = make_float4(p[0], p[1], p[2], 0.f);
        }
    }
    __syncthreads();

    // 3. the taps, P pixels a thread
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const int ox = x0 + tx * P, oy = y0 + ty;
    if (ox >= W || oy >= H) return;
    const float r2 = rad2[b];
    const float gc2 = gc[b] * (255.f * 255.f * LOG2E);
    const float gs2 = gs[b] * LOG2E;
    const float4* tcol = &tile[ty + R][padded(tx * P)];  // padded(tx P + j) = that + padded(j)
    float4 c[P];
    Sums acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        c[p] = tcol[padded(R + p)];
        acc[p] = {0.f, 0.f, 0.f, 0.f};
    }
    filter_rows<R, -R>(tcol, c, acc, r2, gc2, gs2);

    // 4. num / den (den >= 1: the centre tap weighs 1)
    float res[3 * P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const float inv = 1.f / acc[p].den;
        res[3 * p] = acc[p].n0 * inv;
        res[3 * p + 1] = acc[p].n1 * inv;
        res[3 * p + 2] = acc[p].n2 * inv;
    }
    float* o = out + ((static_cast<size_t>(b) * H + oy) * W + ox) * 3;
    if (P % 4 == 0 && vec) {  // W % 4 == 0: the P pixels are all inside
        float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
        for (int i = 0; i < 3 * P / 4; ++i)
            o4[i] = make_float4(res[4 * i], res[4 * i + 1], res[4 * i + 2], res[4 * i + 3]);
    } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
            if (ox + p < W) {
                o[3 * p] = res[3 * p];
                o[3 * p + 1] = res[3 * p + 1];
                o[3 * p + 2] = res[3 * p + 2];
            }
        }
    }
}

template <int R>
int launch(const float* x, const float* gc, const float* gs, const float* rad2, float* out,
           int B, int H, int W, cudaStream_t stream) {
    const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 && W % 4 == 0;
    const dim3 grid(B, (W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
    bilateral_kernel<R><<<grid, THREADS, 0, stream>>>(x, gc, gs, rad2, out, H, W, vec);
    return static_cast<int>(cudaGetLastError());
}

template <int R>
int attributes(int* out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, bilateral_kernel<R>);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bilateral_kernel<R>,
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

// x, out: (B, H, W, 3) fp32 contiguous on the device; gc, gs, rad2: (B,)
// fp32. R in [0, 5]. Returns the CUDA error code of the launch (0 =
// success), -1 for an unsupported R or shape.
extern "C" int bilateral_filter_forward(const void* x, const void* gc, const void* gs,
                                        const void* rad2, void* out, int B, int H, int W,
                                        int R, void* stream) {
    if (R < 0 || R > MAX_R || B <= 0 || H <= 0 || W <= 0 || (H + TILE_H - 1) / TILE_H > 65535
        || (W + TILE_W - 1) / TILE_W > 65535)
        return -1;
    const float* xp = static_cast<const float*>(x);
    const float* gcp = static_cast<const float*>(gc);
    const float* gsp = static_cast<const float*>(gs);
    const float* r2p = static_cast<const float*>(rad2);
    float* op = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 0: return launch<0>(xp, gcp, gsp, r2p, op, B, H, W, st);
        case 1: return launch<1>(xp, gcp, gsp, r2p, op, B, H, W, st);
        case 2: return launch<2>(xp, gcp, gsp, r2p, op, B, H, W, st);
        case 3: return launch<3>(xp, gcp, gsp, r2p, op, B, H, W, st);
        case 4: return launch<4>(xp, gcp, gsp, r2p, op, B, H, W, st);
        default: return launch<5>(xp, gcp, gsp, r2p, op, B, H, W, st);
    }
}

// Launch resources of the kernel built for max radius R, into out[0..4]:
// registers per thread, local (spill) bytes per thread, shared memory per
// block, resident blocks per SM, threads per block. Returns 0, -1 for an
// unsupported R, or a CUDA error code.
extern "C" int bilateral_filter_attributes(int R, int* out) {
    switch (R) {
        case 0: return attributes<0>(out);
        case 1: return attributes<1>(out);
        case 2: return attributes<2>(out);
        case 3: return attributes<3>(out);
        case 4: return attributes<4>(out);
        case 5: return attributes<5>(out);
        default: return -1;
    }
}

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
// 5: 81 taps) and, except the centre tap, dy^2 + dx^2 <= rad2[b]; image
// indices are clamped (edge replication). Forward only.
//
// What bounds it on an H100: operations. At (64, 32, 128, 3) the kernel must
// read and write 6.3 MB (0.0019 ms at 3.35 TB/s) but evaluates one expf and
// about 25 other fp32 operations per tap, up to 81 taps per pixel. So each
// block stages its tile of 8 x 32 pixels plus a halo of R in shared memory
// once (indices clamped on load instead of a padded copy in device memory),
// and every thread walks the taps of one pixel from there with fp32 sums in
// registers. A tap outside the block's sample's disc is skipped as a whole:
// the radius is one per sample, so the branch is uniform across the block.
// The TPU kernel's move of channels to planes and its -1e30 exponent for
// masked taps are VMEM idioms and are not carried over.
//
// The exponent's argument and the sums are computed in the plain version's
// order with round-to-nearest intrinsics (no contraction into FMAs), so the
// kernel differs from the plain version only by expf's last bits.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/bilateral.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int MAX_R = 5;
constexpr int SH = TILE_H + 2 * MAX_R;
constexpr int SW = TILE_W + 2 * MAX_R + 1;  // +1: fewer bank conflicts along a row

__global__ void __launch_bounds__(TILE_W * TILE_H)
bilateral_kernel(const float* __restrict__ x, const float* __restrict__ gc,
                 const float* __restrict__ gs, const float* __restrict__ rad2,
                 float* __restrict__ out, int H, int W, int R) {
    __shared__ float tile[3][SH][SW];
    const int b = blockIdx.z;
    const int x0 = blockIdx.x * TILE_W;
    const int y0 = blockIdx.y * TILE_H;
    const float* img = x + static_cast<size_t>(b) * H * W * 3;

    const int sh = TILE_H + 2 * R;
    const int sw = TILE_W + 2 * R;
    for (int i = threadIdx.y * TILE_W + threadIdx.x; i < sh * sw; i += TILE_W * TILE_H) {
        const int ly = i / sw;
        const int lx = i - ly * sw;
        const int gy = min(max(y0 - R + ly, 0), H - 1);
        const int gx = min(max(x0 - R + lx, 0), W - 1);
        const float* p = img + (static_cast<size_t>(gy) * W + gx) * 3;
        tile[0][ly][lx] = __ldg(p);
        tile[1][ly][lx] = __ldg(p + 1);
        tile[2][ly][lx] = __ldg(p + 2);
    }
    __syncthreads();

    const int ox = x0 + threadIdx.x;
    const int oy = y0 + threadIdx.y;
    if (ox >= W || oy >= H) return;

    const float g_c = gc[b];
    const float g_s = gs[b];
    const float r2 = rad2[b];
    const int cy = threadIdx.y + R;
    const int cx = threadIdx.x + R;
    const float c0 = tile[0][cy][cx], c1 = tile[1][cy][cx], c2 = tile[2][cy][cx];
    float n0 = 0.f, n1 = 0.f, n2 = 0.f, den = 0.f;
    for (int dy = -R; dy <= R; ++dy) {
        for (int dx = -R; dx <= R; ++dx) {
            const int d2 = dy * dy + dx * dx;
            const float d2f = static_cast<float>(d2);
            if (d2 > R * R || (d2 > 0 && d2f > r2)) continue;  // uniform per block
            const float v0 = tile[0][cy + dy][cx + dx];
            const float v1 = tile[1][cy + dy][cx + dx];
            const float v2 = tile[2][cy + dy][cx + dx];
            const float l1 = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(v0, c0)),
                                                 fabsf(__fsub_rn(v1, c1))),
                                       fabsf(__fsub_rn(v2, c2)));
            const float cd = __fmul_rn(l1, 255.f);
            const float arg = __fadd_rn(__fmul_rn(__fmul_rn(g_c, cd), cd), __fmul_rn(g_s, d2f));
            const float w = expf(arg);
            n0 = __fadd_rn(n0, __fmul_rn(w, v0));
            n1 = __fadd_rn(n1, __fmul_rn(w, v1));
            n2 = __fadd_rn(n2, __fmul_rn(w, v2));
            den = __fadd_rn(den, w);
        }
    }
    float* o = out + ((static_cast<size_t>(b) * H + oy) * W + ox) * 3;
    o[0] = __fdiv_rn(n0, den);
    o[1] = __fdiv_rn(n1, den);
    o[2] = __fdiv_rn(n2, den);
}

}  // namespace

// x, out: (B, H, W, 3) fp32 contiguous on the device; gc, gs, rad2: (B,)
// fp32. R in [0, 5]. Returns the CUDA error code of the launch (0 =
// success), -1 for an unsupported R or shape.
extern "C" int bilateral_filter_forward(const void* x, const void* gc, const void* gs,
                                        const void* rad2, void* out, int B, int H, int W,
                                        int R, void* stream) {
    if (R < 0 || R > MAX_R || B <= 0 || H <= 0 || W <= 0) return -1;
    const dim3 block(TILE_W, TILE_H);
    const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
    bilateral_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(gc),
        static_cast<const float*>(gs), static_cast<const float*>(rad2),
        static_cast<float*>(out), H, W, R);
    return static_cast<int>(cudaGetLastError());
}

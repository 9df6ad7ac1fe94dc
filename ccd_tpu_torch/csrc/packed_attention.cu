// Forward of packed multi-head attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_packed_fwd_kernel` behind `mha_packed_bias` /
// `mha_packed` (ccd_tpu/ops/flash_attention.py). Per head h it computes
//
//     softmax((q + bq)(k + bk)^T * scale) (v + bv)
//
// straight from the un-biased qkv projection (B, S, 3C), channel order
// [q h0..hH | k h0..hH | v h0..hH], plus its bias (3C,), and writes the head's
// (S, D) slab at column h*D of the (B, S, C) output. No transposes in or out.
// Logits and softmax are fp32; the probabilities are cast to the input type
// before the second product, which accumulates in fp32.
//
// What bounds it on an H100: bytes. At (B, S, C, H) = (288, 256, 384, 6) in
// bf16 one call must read 288*256*1152*2 B = 169.9 MB and write 56.6 MB; at
// 3.35 TB/s that is 0.068 ms, while its 4*S*S*D*H*B = 29.0 GFLOP take 0.029 ms
// at 989 TFLOP/s. So the design keeps everything but qkv and the output out
// of device memory: one block per (batch, head, tile of query rows) reads the
// head's q/k/v columns by offset, adds the bias as the values are loaded,
// keeps the head's K and V in shared memory, keeps the scores in registers
// (online softmax over 64-key steps) and stores the output slab through
// shared memory in 16-byte rows. The K and V columns of a head are read once
// per query tile; the tiles of one head are neighbours in the grid, so the
// repeats are served by the L2 cache.
//
// Two kernels:
//   * bf16: tensor cores through `mma.sync.m16n8k16`; each warp owns 16 query
//     rows. (`wgmma`, TMA and pipelining are left for a later change.)
//   * fp32: scalar FMA, one query row per thread, K/V streamed through shared
//     memory in 32-key chunks. Exact fp32 arithmetic (no TF32).
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/flash_attention.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KEYS = 64;  // keys per online-softmax step (bf16 kernel)
constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int PAD = 8;    // bf16 elements of row padding in shared memory:
                          // rows 16 bytes apart modulo 128, so the fragment
                          // loads below are free of bank conflicts

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

// grid (S / (16 * WARPS), H, B), block 32 * WARPS threads,
// dynamic shared memory (16 * WARPS + 2 * S) * (D + PAD) * 2 bytes.
template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
packed_attention_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, int S, int H, float scale_log2e) {
    constexpr int ROWS = 16 * WARPS;
    constexpr int LD = D + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // ROWS x LD, later the output tile
    bf16* Ks = Qs + ROWS * LD;                     // S x LD
    bf16* Vs = Ks + (size_t)S * LD;                // S x LD

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int C = H * D;
    const size_t stride = 3 * (size_t)C;
    const bf16* base = qkv + (size_t)b * S * stride + h * D;
    const bf16* bq = bias ? bias + h * D : nullptr;
    const bf16* bk = bias ? bias + C + h * D : nullptr;
    const bf16* bv = bias ? bias + 2 * C + h * D : nullptr;
    load_tile<D>(Qs, base + (size_t)tile * ROWS * stride, stride, ROWS, bq);
    load_tile<D>(Ks, base + C, stride, S, bk);
    load_tile<D>(Vs, base + 2 * C, stride, S, bv);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair

    // A fragments of this warp's 16 query rows, for all of D
    uint32_t qa[D / 16][4];
    {
        const bf16* q0 = Qs + (warp * 16 + g) * LD + 2 * t;
        const bf16* q1 = q0 + 8 * LD;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            qa[kk][0] = ld32(q0 + kk * 16);
            qa[kk][1] = ld32(q1 + kk * 16);
            qa[kk][2] = ld32(q0 + kk * 16 + 8);
            qa[kk][3] = ld32(q1 + kk * 16 + 8);
        }
    }

    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) { o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f; }
    float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows g and g + 8
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

    for (int k0 = 0; k0 < S; k0 += KEYS) {
        // scores of 16 rows x 64 keys, fp32
        float s[KEYS / 8][4];
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) { s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f; }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int j = 0; j < KEYS / 8; ++j) {
                const bf16* kp = Ks + (size_t)(k0 + j * 8 + g) * LD + kk * 16 + 2 * t;
                mma_bf16(s[j], qa[kk], ld32(kp), ld32(kp + 8));
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
            s[j][0] *= scale_log2e; s[j][1] *= scale_log2e;
            s[j][2] *= scale_log2e; s[j][3] *= scale_log2e;
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
        m0 = mn0; m1 = mn1;
        l0 *= alpha0; l1 *= alpha1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha0; o[j][1] *= alpha0;
            o[j][2] *= alpha1; o[j][3] *= alpha1;
        }
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
            s[j][0] = exp2f(s[j][0] - m0); s[j][1] = exp2f(s[j][1] - m0);
            s[j][2] = exp2f(s[j][2] - m1); s[j][3] = exp2f(s[j][3] - m1);
            l0 += s[j][0] + s[j][1];
            l1 += s[j][2] + s[j][3];
        }
        // O += P V: the score fragments of two key octets are the A fragment
        // of one 16-key step; V's B fragments come transposed out of shared
        // memory, two D octets per ldmatrix.
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
            const bf16* vp = Vs + (size_t)(k0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                             + (lane >> 4) * 8;
#pragma unroll
            for (int jd = 0; jd < D / 16; ++jd) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, vp + jd * 16);
                mma_bf16(o[2 * jd], pa, vb[0], vb[1]);
                mma_bf16(o[2 * jd + 1], pa, vb[2], vb[3]);
            }
        }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;

    // Each warp overwrites its own 16 rows of the Q tile (only it read them,
    // and they are in registers now), then stores them 16 bytes a thread.
    bf16* ot = Qs + warp * 16 * LD;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ot + g * LD + j * 8 + 2 * t) =
            pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
        *reinterpret_cast<uint32_t*>(ot + (g + 8) * LD + j * 8 + 2 * t) =
            pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
    __syncwarp();
    bf16* orow = out + ((size_t)b * S + (size_t)tile * ROWS + warp * 16) * C + h * D;
    constexpr int CHUNKS = D / 8;
    for (int i = lane; i < 16 * CHUNKS; i += 32) {
        const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
        *reinterpret_cast<uint4*>(orow + (size_t)r * C + c) =
            *reinterpret_cast<const uint4*>(ot + r * LD + c);
    }
}

constexpr int F32_ROWS = 64;  // query rows (= threads) per block, fp32 kernel
constexpr int F32_KEYS = 32;  // keys per shared-memory chunk
constexpr int F32_STEP = 8;   // keys per softmax rescale

// grid (S / 64, H, B), block 64 threads; thread r owns query row r of the tile.
template <int D>
__global__ void __launch_bounds__(F32_ROWS)
packed_attention_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                     float* __restrict__ out, int S, int H, float scale) {
    __shared__ __align__(16) float Ks[F32_KEYS][D];
    __shared__ __align__(16) float Vs[F32_KEYS][D];
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int C = H * D;
    const size_t stride = 3 * (size_t)C;
    const float* base = qkv + (size_t)b * S * stride + h * D;
    const int row = tile * F32_ROWS + threadIdx.x;

    float q[D], o[D];
    {
        const float* qp = base + (size_t)row * stride;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
            float4 v = __ldg(reinterpret_cast<const float4*>(qp + d));
            if (bias != nullptr) {
                float4 bq = __ldg(reinterpret_cast<const float4*>(bias + h * D + d));
                v.x += bq.x; v.y += bq.y; v.z += bq.z; v.w += bq.w;
            }
            q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
            o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
        }
    }
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < S; k0 += F32_KEYS) {
        __syncthreads();  // the previous chunk is no longer read
        for (int i = threadIdx.x; i < F32_KEYS * (D / 4); i += F32_ROWS) {
            const int r = i / (D / 4), c = (i % (D / 4)) * 4;
            const float* kp = base + (size_t)(k0 + r) * stride + C + c;
            float4 kv = __ldg(reinterpret_cast<const float4*>(kp));
            float4 vv = __ldg(reinterpret_cast<const float4*>(kp + C));
            if (bias != nullptr) {
                float4 bk = __ldg(reinterpret_cast<const float4*>(bias + C + h * D + c));
                float4 bv = __ldg(reinterpret_cast<const float4*>(bias + 2 * C + h * D + c));
                kv.x += bk.x; kv.y += bk.y; kv.z += bk.z; kv.w += bk.w;
                vv.x += bv.x; vv.y += bv.y; vv.z += bv.z; vv.w += bv.w;
            }
            *reinterpret_cast<float4*>(&Ks[r][c]) = kv;
            *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
        }
        __syncthreads();
        for (int kk = 0; kk < F32_KEYS; kk += F32_STEP) {
            float s[F32_STEP];
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < F32_STEP; ++j) {
                float acc = 0.f;
#pragma unroll
                for (int d = 0; d < D; ++d) acc = fmaf(q[d], Ks[kk + j][d], acc);
                s[j] = acc * scale;
                mx = fmaxf(mx, s[j]);
            }
            const float mn = fmaxf(m, mx);
            const float alpha = expf(m - mn);
            m = mn;
            l *= alpha;
#pragma unroll
            for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
            for (int j = 0; j < F32_STEP; ++j) {
                const float p = expf(s[j] - m);
                l += p;
#pragma unroll
                for (int d = 0; d < D; ++d) o[d] = fmaf(p, Vs[kk + j][d], o[d]);
            }
        }
    }
    const float inv = 1.f / l;
    float* op = out + ((size_t)b * S + row) * C + h * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        *reinterpret_cast<float4*>(op + d) =
            make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
    }
}

template <int D, int WARPS>
int launch_bf16(const void* qkv, const void* bias, void* out, int B, int S, int H,
                float scale, cudaStream_t stream) {
    const size_t smem = (size_t)(16 * WARPS + 2 * S) * (D + PAD) * sizeof(bf16);
    if (smem > SMEM_LIMIT) return -2;
    cudaError_t err = cudaFuncSetAttribute(packed_attention_bf16<D, WARPS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(S / (16 * WARPS), H, B);
    packed_attention_bf16<D, WARPS><<<grid, 32 * WARPS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
        static_cast<bf16*>(out), S, H, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* qkv, const void* bias, void* out, int B, int S, int H,
               float scale, cudaStream_t stream) {
    dim3 grid(S / F32_ROWS, H, B);
    packed_attention_f32<D><<<grid, F32_ROWS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<float*>(out), S, H, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, S, 3*H*D) and out (B, S, H*D) contiguous, bias (3*H*D,) or null, all
// of one type: is_bf16 = 1 for bfloat16, 0 for float32. D is 32 or 64 and S a
// multiple of 64; the caller checks both. Launches on `stream`, does not
// synchronise, and returns the CUDA error code of the launch (0 = success),
// -1 for an unsupported D, -2 when one head's K and V exceed shared memory.
extern "C" int packed_attention_forward(const void* qkv, const void* bias, void* out,
                                        int B, int S, int H, int D, int is_bf16,
                                        float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err;
    if (is_bf16) {
        // 128-row tiles read K and V half as often; 64-row tiles take any S % 64 == 0
        const bool wide = (S % 128 == 0);
        if (D == 64) {
            err = wide ? launch_bf16<64, 8>(qkv, bias, out, B, S, H, scale, st)
                       : launch_bf16<64, 4>(qkv, bias, out, B, S, H, scale, st);
        } else if (D == 32) {
            err = wide ? launch_bf16<32, 8>(qkv, bias, out, B, S, H, scale, st)
                       : launch_bf16<32, 4>(qkv, bias, out, B, S, H, scale, st);
        } else {
            return -1;
        }
    } else {
        if (D == 64) err = launch_f32<64>(qkv, bias, out, B, S, H, scale, st);
        else if (D == 32) err = launch_f32<32>(qkv, bias, out, B, S, H, scale, st);
        else return -1;
    }
    return err;
}

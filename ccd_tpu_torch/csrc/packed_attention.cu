// Forward of multi-head attention for Hopper (sm_90a), on strided operands.
//
// Replaces two Pallas kernels of ccd_tpu/ops/flash_attention.py with one
// device code:
//   * `_packed_fwd_kernel` behind `mha_packed_bias` / `mha_packed` (K1-fwd):
//     softmax((q + bq)(k + bk)^T * scale) (v + bv) per head straight from the
//     un-biased qkv projection (B, S, 3C), channel order
//     [q h0..hH | k h0..hH | v h0..hH], plus its bias (3C,), writing the
//     head's (S, D) slab at column h*D of the (B, S, C) output;
//   * `_fwd_kernel` behind `flash_attention` / `mha` (K1b-fwd): the same
//     without bias on folded (B*H, S, D) tensors, or on (B, S, H, D) tensors
//     read and written in place (no transposes, where the JAX `mha` moves
//     q, k, v and the output through two transposes).
// Each operand is a base pointer with a batch stride, a row stride and a
// per-head column offset (attention_common.cuh::Operand); the two C entries
// below differ only in how they build the operands. Logits and softmax are
// fp32; the probabilities are cast to the input type before the second
// product, which accumulates in fp32.
//
// What bounds it on an H100: bytes. At (B, S, C, H) = (288, 256, 384, 6) in
// bf16 one packed call must read 288*256*1152*2 B = 169.9 MB and write
// 56.6 MB; at 3.35 TB/s that is 0.068 ms, while its 4*S*S*D*H*B = 29.0 GFLOP
// take 0.029 ms at 989 TFLOP/s. A folded (768, 256, 64) call reads 75.5 MB
// and writes 25.2 MB: 0.030 ms against 12.9 GFLOP, 0.013 ms. So the design
// keeps everything but the inputs and the output out of device memory: one
// block per (batch, head, tile of query rows) reads the head's q/k/v rows by
// offset, adds the bias as the values are loaded, keeps the head's K and V in
// shared memory, keeps the scores in registers (online softmax over 64-key
// steps) and stores the output slab through shared memory in 16-byte rows.
// The K and V rows of a head are read once per query tile; the tiles of one
// head are neighbours in the grid, so the repeats are served by the L2 cache.
//
// Two kernels:
//   * bf16: tensor cores through `mma.sync.m16n8k16`; each warp owns 16 query
//     rows. (`wgmma`, TMA and pipelining are left for a later change.)
//   * fp32: scalar FMA, one query row per thread, K/V streamed through shared
//     memory in 32-key chunks. Exact fp32 arithmetic (no TF32).
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"

namespace {

constexpr int KEYS = 64;  // keys per online-softmax step (bf16 kernel)

// grid (S / (16 * WARPS), H, B), block 32 * WARPS threads,
// dynamic shared memory (16 * WARPS + 2 * S) * (D + PAD) * 2 bytes.
template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attention_fwd_bf16(const FwdArgs<bf16> a, int S, float scale_log2e) {
    constexpr int ROWS = 16 * WARPS;
    constexpr int LD = D + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // ROWS x LD, later the output tile
    bf16* Ks = Qs + ROWS * LD;                     // S x LD
    bf16* Vs = Ks + (size_t)S * LD;                // S x LD

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    load_tile<D>(Qs, a.q.at(b, h, (size_t)tile * ROWS), a.q.row_stride, ROWS,
                 head_bias(a.bq, h, D));
    load_tile<D>(Ks, a.k.at(b, h, 0), a.k.row_stride, S, head_bias(a.bk, h, D));
    load_tile<D>(Vs, a.v.at(b, h, 0), a.v.row_stride, S, head_bias(a.bv, h, D));
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair

    // A fragments of this warp's 16 query rows, for all of D
    uint32_t qa[D / 16][4];
    load_a_fragments<D>(qa, Qs + warp * 16 * LD, g, t);

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
    store_warp_tile<D>(Qs + warp * 16 * LD, a.o.at(b, h, (size_t)tile * ROWS + warp * 16),
                       a.o.row_stride, o, inv0, inv1, lane);
}

constexpr int F32_ROWS = 64;  // query rows (= threads) per block, fp32 kernel
constexpr int F32_KEYS = 32;  // keys per shared-memory chunk
constexpr int F32_STEP = 8;   // keys per softmax rescale

// grid (S / 64, H, B), block 64 threads; thread r owns query row r of the tile.
template <int D>
__global__ void __launch_bounds__(F32_ROWS)
attention_fwd_f32(const FwdArgs<float> a, int S, float scale) {
    __shared__ __align__(16) float Ks[F32_KEYS][D];
    __shared__ __align__(16) float Vs[F32_KEYS][D];
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int row = tile * F32_ROWS + threadIdx.x;
    const float* bq = head_bias(a.bq, h, D);
    const float* bk = head_bias(a.bk, h, D);
    const float* bv = head_bias(a.bv, h, D);

    float q[D], o[D];
    {
        const float* qp = a.q.at(b, h, row);
#pragma unroll
        for (int d = 0; d < D; d += 4) {
            float4 v = __ldg(reinterpret_cast<const float4*>(qp + d));
            if (bq != nullptr) {
                float4 bb = __ldg(reinterpret_cast<const float4*>(bq + d));
                v.x += bb.x; v.y += bb.y; v.z += bb.z; v.w += bb.w;
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
            float4 kv = __ldg(reinterpret_cast<const float4*>(a.k.at(b, h, k0 + r) + c));
            float4 vv = __ldg(reinterpret_cast<const float4*>(a.v.at(b, h, k0 + r) + c));
            if (bk != nullptr) {
                float4 kb = __ldg(reinterpret_cast<const float4*>(bk + c));
                float4 vb = __ldg(reinterpret_cast<const float4*>(bv + c));
                kv.x += kb.x; kv.y += kb.y; kv.z += kb.z; kv.w += kb.w;
                vv.x += vb.x; vv.y += vb.y; vv.z += vb.z; vv.w += vb.w;
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
    float* op = a.o.at(b, h, row);
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        *reinterpret_cast<float4*>(op + d) =
            make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
    }
}

template <int D, int WARPS>
int launch_bf16(const FwdArgs<bf16>& a, int B, int S, int H, float scale,
                cudaStream_t stream) {
    const size_t smem = (size_t)(16 * WARPS + 2 * S) * (D + PAD) * sizeof(bf16);
    if (smem > SMEM_LIMIT) return -2;
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_bf16<D, WARPS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(S / (16 * WARPS), H, B);
    attention_fwd_bf16<D, WARPS><<<grid, 32 * WARPS, smem, stream>>>(
        a, S, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const FwdArgs<float>& a, int B, int S, int H, float scale,
               cudaStream_t stream) {
    dim3 grid(S / F32_ROWS, H, B);
    attention_fwd_f32<D><<<grid, F32_ROWS, 0, stream>>>(a, S, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const FwdArgs<T>& a, int B, int S, int H, int D, float scale, cudaStream_t st) {
    if (B > MAX_GRID_Z) return -3;
    if constexpr (sizeof(T) == 2) {
        // 128-row tiles read K and V half as often; 64-row tiles take any S % 64 == 0
        const bool wide = (S % 128 == 0);
        if (D == 64) return wide ? launch_bf16<64, 8>(a, B, S, H, scale, st)
                                 : launch_bf16<64, 4>(a, B, S, H, scale, st);
        if (D == 32) return wide ? launch_bf16<32, 8>(a, B, S, H, scale, st)
                                 : launch_bf16<32, 4>(a, B, S, H, scale, st);
    } else {
        if (D == 64) return launch_f32<64>(a, B, S, H, scale, st);
        if (D == 32) return launch_f32<32>(a, B, S, H, scale, st);
    }
    return -1;
}

template <typename T>
int packed_forward(const void* qkv, const void* bias, void* out, int B, int S, int H, int D,
                   float scale, cudaStream_t st) {
    const long long C = (long long)H * D;
    const T* x = static_cast<const T*>(qkv);
    const T* bb = static_cast<const T*>(bias);
    const long long in[3] = {S * 3 * C, 3 * C, D}, o[3] = {S * C, C, D};
    FwdArgs<T> a{operand(x, in), operand(x + C, in), operand(x + 2 * C, in),
                 bb, bb ? bb + C : nullptr, bb ? bb + 2 * C : nullptr,
                 operand(static_cast<T*>(out), o)};
    return launch(a, B, S, H, D, scale, st);
}

template <typename T>
int strided_forward(const void* q, const void* k, const void* v, void* out,
                    const long long* strides, int B, int S, int H, int D, float scale,
                    cudaStream_t st) {
    FwdArgs<T> a{operand(static_cast<const T*>(q), strides),
                 operand(static_cast<const T*>(k), strides + 3),
                 operand(static_cast<const T*>(v), strides + 6), nullptr, nullptr, nullptr,
                 operand(static_cast<T*>(out), strides + 9)};
    return launch(a, B, S, H, D, scale, st);
}

}  // namespace

// The entries below launch on `stream`, do not synchronise, and return the
// CUDA error code of the launch (0 = success), -1 for an unsupported D, -2
// when one head's K and V exceed shared memory, -3 when B exceeds the grid.
// Tensors are of one type: is_bf16 = 1 for bfloat16, 0 for float32. D is 32
// or 64 and S a multiple of 64; the caller checks both, and the alignment.

// K1-fwd. qkv (B, S, 3*H*D) and out (B, S, H*D) contiguous, bias (3*H*D,) or null.
extern "C" int packed_attention_forward(const void* qkv, const void* bias, void* out,
                                        int B, int S, int H, int D, int is_bf16,
                                        float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? packed_forward<bf16>(qkv, bias, out, B, S, H, D, scale, st)
                   : packed_forward<float>(qkv, bias, out, B, S, H, D, scale, st);
}

// K1b-fwd. q, k, v and out are (B, H, S, D) operands given by their base
// pointers and `strides`, twelve element strides: (batch, row, head) for q,
// k, v and out in turn; D is contiguous. Folded (B*H, S, D) tensors are
// H = 1; (B, S, H, D) tensors are read and written in place.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       const long long* strides, int B, int S, int H, int D,
                                       int is_bf16, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? strided_forward<bf16>(q, k, v, out, strides, B, S, H, D, scale, st)
                   : strided_forward<float>(q, k, v, out, strides, B, S, H, D, scale, st);
}

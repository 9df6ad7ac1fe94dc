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
// 56.6 MB (226.5 MB); at 3.35 TB/s that is 0.068 ms, while its
// 4*S*S*D*H*B = 29.0 GFLOP take 0.029 ms at 989 TFLOP/s. A folded
// (768, 256, 64) call reads 75.5 MB and writes 25.2 MB: 0.030 ms against
// 12.9 GFLOP, 0.013 ms. So the kernel must keep the memory system busy from
// its first cycle and touch nothing but the inputs and the output.
//
// bf16 kernel (the design):
//   * one warpgroup (128 threads) per 64 query rows, two per block where
//     S % 128 == 0, so each K/V chunk in shared memory serves 128 rows;
//   * K and V stream through a ring of STAGES = 3 shared-memory stages of
//     64 keys each, filled by 16-byte `cp.async.cg` copies: chunks j + 1 and
//     j + 2 are in flight while chunk j's products run. Shared memory no
//     longer grows with S (65 KB a block at D = 64, where the whole head
//     took 92 KB); registers (about 128 a thread) allow two 256-thread
//     blocks an SM, so one block's loads overlap the other's products. Each
//     thread's copy offsets are computed once (the swizzle's phase is the
//     same for all its rows), so a copy costs an add and the instruction:
//     at these shapes the kernel is bound as much by instructions issued as
//     by bytes. (A persistent grid, each block walking tiles with the next
//     tile's Q and chunks in flight during the last ones, measured slower:
//     more registers and shared memory a block for no better overlap. TMA
//     would save the copy instructions but needs three kinds of tensor map
//     and an mbarrier that hangs on a wrong byte count: left for later.)
//   * both products are `wgmma` with A in registers: S = Q K^T as
//     m64n64k16 (Q's fragments loaded once per tile), O += P V as m64nDk16
//     with P converted in registers from S's accumulator and V read through
//     the descriptor's transpose bit (attention_sm90.cuh);
//   * online softmax in registers (running maximum and sum, rescale of O)
//     in log2 units: the scale folded into the FFMA before `ex2.approx`;
//     P V runs in two halves of 32 keys, the first half's products while
//     the second half's exponentials are computed;
//   * bias folded in algebraically, exact in real arithmetic: bq is added to
//     Q's fragments (fp32 add, one rounding, as a bf16 tensor add rounds);
//     bk adds (q + bq) . bk to every logit of a row, which the softmax
//     cancels, so it is not read; bv comes out as + bv after the
//     normalisation, since each row of P sums to 1. Only rounding points move
//     (the plain version rounds k + bk and v + bv to bf16 first);
//   * the output tile goes through this warp's rows of the Q tile in shared
//     memory and out in 16-byte rows;
//   * when a gradient is wanted, each row's base-2 log-sum-exp m + log2(l)
//     goes to a (B, H, S) fp32 array (attention_common.cuh states its
//     units), which the backward reads instead of recomputing the softmax.
// K and V rows of a head are read once per 128-row tile; the tiles of one
// head are neighbours in the grid, so the repeats are served by the L2 cache.
//
// fp32 kernel (exact fp32, no TF32; its pieces in attention_f32.cuh). What
// bounds it on an H100: the fp32 pipe. At (288, 256, 384, 6) its 29.0 GFLOP
// take 0.433 ms at 67 TFLOP/s, its 453 MB 0.135 ms at 3.35 TB/s. The
// kernel it replaces gave each thread one query row and read one operand of
// every FMA from shared memory, so shared memory set the pace (32 % of the
// bound), and it spilled. This one is FlashAttention-2's structure on the
// fp32 pipe:
//   * 128 threads per 64 query rows (any S % 64 == 0); Q + bq staged once,
//     d-major, so a thread's 4 rows at one d are one 16-byte load;
//   * one K and one V chunk of 64 keys in shared memory (swizzled rows),
//     filled by 16-byte `cp.async.cg` copies: V of chunk j lands while S of
//     chunk j is computed, K of chunk j + 1 while O += P V of chunk j is;
//     bv is added in place by the thread that copied each piece. 64 KB a
//     block at D = 64, so 3 blocks (12 warps) an SM (two stages of both,
//     96 KB and 2 blocks, measured slower on the card);
//   * S = Q K^T and O += P V as register-tiled outer products: a thread owns
//     4 rows x 8 keys of S and 4 rows x D/8 columns of O: per 4 steps of d,
//     12 16-byte loads from shared memory feed 128 FMAs of S, and per key
//     1 + D/32 loads feed D/2 FMAs of O;
//   * online softmax in log2 units (the scale times log2(e) in one multiply,
//     `ex2.approx`), row maxima over the 8 threads that share a row by
//     __shfl_xor_sync; P passes to O += P V through this warp's own rows of
//     a shared tile, with __syncwarp only;
//   * bk dropped and each row's log-sum-exp saved as the bf16 kernel saves
//     them; no atomics, so two calls give the same bits.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"
#include "attention_f32.cuh"
#include "attention_sm90.cuh"

namespace {

constexpr int KEYS = 64;    // keys per chunk, the online softmax's step
constexpr int STAGES = 3;   // K/V chunks in shared memory: one read, two landing

// Dynamic shared memory of the bf16 kernel: 1024-byte alignment slack, the
// Q tiles of WGS warpgroups (later the output), and STAGES x (K, V) chunks.
template <int D, int WGS>
constexpr size_t fwd_smem_bytes() {
    return 1024 + (size_t)(WGS + 2 * STAGES) * KEYS * 2 * D;
}

// grid (S / (64 * WGS), H, B), block 128 * WGS threads, dynamic shared memory
// fwd_smem_bytes<D, WGS>(). Warpgroup w owns query rows 64w..64w+63 of the
// tile; within it warp i rows 16i..16i+15 (the wgmma fragment layout).
template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS, 4 / WGS)
attention_fwd_sm90(const FwdArgs<bf16> a, int S, float scale_log2e) {
    constexpr int NT = 128 * WGS;
    constexpr int ROWS = 64 * WGS;
    constexpr uint32_t TILE = KEYS * 2 * D;  // bytes of a 64-row tile
    constexpr int R = D / 2;                 // O's accumulator registers per thread
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's pattern needs 1024
    unsigned char* const tile_ptr = smem_raw + (base - raw);  // Q tiles, then the output
    const uint32_t ring = base + WGS * TILE;     // stage s: K at 2s tiles, V after it

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t ks = a.k.row_stride, vs = a.v.row_stride;
    const bf16* kg = a.k.at(b, h, 0);
    const bf16* vg = a.v.at(b, h, 0);
    const int chunks = S / KEYS;
    const TileCopy<D, NT> kc(ks), vc(vs);
    auto load_chunk = [&](int n) {  // chunk n into its stage, as one copy group
        if (n < chunks) {
            const uint32_t st = ring + 2 * (n % STAGES) * TILE;
            kc.template issue<KEYS>(st, kg + (size_t)n * KEYS * ks);
            vc.template issue<KEYS>(st + TILE, vg + (size_t)n * KEYS * vs);
        }
        cp_async_commit();
    };

    TileCopy<D, NT>(a.q.row_stride).template issue<ROWS>(base, a.q.at(b, h, (size_t)tile * ROWS));
    cp_async_commit();
#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n) load_chunk(n);

    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // fragment row group / column pair
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile

    // Q's A fragments for all of D, plus bq: loaded once
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    uint32_t qa[D / 16][4];
    const bf16* bq = head_bias(a.bq, h, D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = kk * 16 + (e >> 1) * 8 + 2 * t;
            uint32_t x = *reinterpret_cast<const uint32_t*>(
                tile_ptr + swizzled_pair<D>(r0 + (e & 1) * 8, col));
            qa[kk][e] = bq != nullptr ? add_pair(x, bq + col) : x;
        }
    }
    // scores are maxed before they are scaled: a negative scale goes into Q
    // (exact in bf16) and its magnitude into c
    const float c = fabsf(scale_log2e);
    if (scale_log2e < 0.f) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[kk][e] ^= 0x80008000u;
        }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) fence_regs(qa[kk]);

    float o[R];
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r0 and r0 + 8
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

    for (int j = 0; j < chunks; ++j) {
        cp_async_wait<STAGES - 2>();  // this thread's copies of chunk j have landed
        fence_proxy_async();          // ... and are visible to wgmma
        __syncthreads();              // everyone's; and chunk j - 1's stage is free
        load_chunk(j + STAGES - 1);
        // descriptors of this chunk's K and V tiles; a 16-deep step of K is 32
        // bytes along the row, one of V 16 rows (the start address is in
        // 16-byte units in the descriptor's low bits)
        const uint64_t kdesc = smem_desc<D>(ring + 2 * (j % STAGES) * TILE);
        const uint64_t vdesc = kdesc + (TILE >> 4);

        // S = Q K^T: 64 rows x 64 keys, fp32
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_rs<0>(s, qa[kk], kdesc + kk * (32 >> 4), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // online softmax in log2 units: maxima of the raw scores (c > 0),
        // p = 2^(s c - m) with the scale folded into one FFMA
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
        const float alpha0 = exp2_ftz(m0 - mn0), alpha1 = exp2_ftz(m1 - mn1);
        m0 = mn0; m1 = mn1;
        l0 *= alpha0; l1 *= alpha1;
#pragma unroll
        for (int i = 0; i < R / 4; ++i) {
            o[4 * i] *= alpha0; o[4 * i + 1] *= alpha0;
            o[4 * i + 2] *= alpha1; o[4 * i + 3] *= alpha1;
        }
        fence_regs(o);

        // O += P V in two halves of 32 keys: the first half's products run
        // while the second half's exponentials are computed. P in bf16 is the
        // A fragment of a 16-key step: the accumulator blocks of key octets
        // 2kk and 2kk + 1 are step kk's fragment.
        uint32_t pa[4][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int i = 4 * half; i < 4 * half + 4; ++i) {
                const float p0 = exp2_ftz(fmaf(s[4 * i], c, -m0));
                const float p1 = exp2_ftz(fmaf(s[4 * i + 1], c, -m0));
                const float p2 = exp2_ftz(fmaf(s[4 * i + 2], c, -m1));
                const float p3 = exp2_ftz(fmaf(s[4 * i + 3], c, -m1));
                l0 += p0 + p1;
                l1 += p2 + p3;
                pa[i >> 1][(i & 1) * 2] = pack_bf16(p0, p1);
                pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
            }
            fence_regs(pa[2 * half]);
            fence_regs(pa[2 * half + 1]);
            wgmma_fence();
#pragma unroll
            for (int kk = 2 * half; kk < 2 * half + 2; ++kk) {
                wgmma_rs<1>(o, pa[kk], vdesc + kk * (16 * 2 * D >> 4), 1);
            }
            wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    if (a.lse != nullptr && t == 0) {  // m and the scores are in units of x_ij already
        float* lse = a.lse + ((size_t)b * gridDim.y + h) * S + (size_t)tile * ROWS + r0;
        lse[0] = m0 + log2f(l0);
        lse[8] = m1 + log2f(l1);
    }

    // O / l + bv in bf16 over this warp's own 16 rows of the Q tile (only it
    // read them, into registers), then out 16 bytes a thread
    const bf16* bv = head_bias(a.bv, h, D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (bv != nullptr) {
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bv + col);
            b0 = __low2float(bb);
            b1 = __high2float(bb);
        }
        *reinterpret_cast<uint32_t*>(tile_ptr + swizzled_pair<D>(r0, col)) =
            pack_bf16(o[4 * i] * inv0 + b0, o[4 * i + 1] * inv0 + b1);
        *reinterpret_cast<uint32_t*>(tile_ptr + swizzled_pair<D>(r0 + 8, col)) =
            pack_bf16(o[4 * i + 2] * inv1 + b0, o[4 * i + 3] * inv1 + b1);
    }
    __syncwarp();
    const int row0 = wg * 64 + warp * 16;
    bf16* dst = a.o.at(b, h, (size_t)tile * ROWS + row0);
    for (int i = lane; i < 16 * (D / 8); i += 32) {
        const int r = i / (D / 8), c = i % (D / 8);
        *reinterpret_cast<uint4*>(dst + (size_t)r * a.o.row_stride + c * 8) =
            *reinterpret_cast<const uint4*>(tile_ptr + swizzled<D>(row0 + r, c));
    }
}

// Dynamic shared memory of the fp32 kernel: Q + bq d-major, the tile of
// probabilities, a K chunk and a V + bv chunk.
template <int D>
constexpr size_t f32_smem_bytes() {
    return (size_t)(D * F32_TILE + F32_TILE * F32_TILE + 2 * F32_TILE * D) * 4;
}

// grid (S / 64, H, B), block 128 threads, dynamic shared memory
// f32_smem_bytes<D>(). Thread (ty, tx) (attention_f32.cuh) owns query rows
// 4ty..4ty+3 of the tile: their running maxima and sums, and their O
// columns 4(tx + 8h)..+3; of each 64-key chunk the keys tx + 8j. One K and
// one V chunk in shared memory: V of chunk j lands while S of chunk j is
// computed, K of chunk j + 1 while O += P V of chunk j is.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, D == 64 ? 3 : 4)
attention_fwd_f32(const FwdArgs<float> a, int S, float scale_log2e) {
    extern __shared__ float4 smem_f4[];
    float* const qt = reinterpret_cast<float*>(smem_f4);  // D x 64, d-major
    float* const pt = qt + D * F32_TILE;                  // 64 keys x 64 rows
    float* const kc = pt + F32_TILE * F32_TILE;           // 64 keys x D
    float* const vc = kc + F32_TILE * D;                  // 64 keys x D

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int tx = lane & 7, ty = (threadIdx.x >> 5) * 4 + (lane >> 3);
    const size_t ks = a.k.row_stride, vs = a.v.row_stride;
    const float* kg = a.k.at(b, h, 0);
    const float* vg = a.v.at(b, h, 0);
    const float* bv = head_bias(a.bv, h, D);
    const int chunks = S / F32_TILE;
    const ChunkCopy<D> copy;

    copy.issue(kc, kg, ks);
    cp_async_commit();
    stage_dmajor<D>(qt, a.q.at(b, h, (size_t)tile * F32_TILE), a.q.row_stride,
                    head_bias(a.bq, h, D));

    float o[4][D / 8];
    zero(o);
    float m[4], l[4];  // running maxima (log2 units) and this thread's share of the sums
#pragma unroll
    for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }

    for (int j = 0; j < chunks; ++j) {
        cp_async_wait<0>();  // this thread's copies of K chunk j have landed
        __syncthreads();     // everyone's (and Q); the V chunk is no longer read
        copy.issue(vc, vg + (size_t)j * F32_TILE * vs, vs);
        cp_async_commit();

        float s[4][8];
        zero(s);
        mm_nt<D, 8>(s, qt, kc, ty, tx);

        // online softmax in log2 units: x = s * scale * log2(e), p = 2^(x - m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                s[i][k] *= scale_log2e;
                mx = fmaxf(mx, s[i][k]);
            }
            const float mn = fmaxf(m[i], row_max8(mx));
            const float alpha = exp2_ftz(m[i] - mn);
            m[i] = mn;
            l[i] *= alpha;
#pragma unroll
            for (int c = 0; c < D / 8; ++c) o[i][c] *= alpha;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                s[i][k] = exp2_ftz(s[i][k] - mn);
                l[i] += s[i][k];
            }
        }
        // P through this warp's own rows of the tile
        store_transposed(pt, s, ty, tx);

        cp_async_wait<0>();  // this thread's copies of V chunk j have landed
        if (bv != nullptr) copy.add_bias(vc, bv);
        __syncthreads();     // everyone's; the K chunk is no longer read
        if (j + 1 < chunks) copy.issue(kc, kg + (size_t)(j + 1) * F32_TILE * ks, ks);
        cp_async_commit();
        mm_nn<D, F32_TILE>(o, pt, vc, ty, tx);  // O += P V
    }

    float inv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        l[i] = row_sum8(l[i]);
        inv[i] = 1.f / l[i];
    }
    if (a.lse != nullptr && tx == 0) {
        float* lse = a.lse + ((size_t)b * gridDim.y + h) * S + (size_t)tile * F32_TILE + 4 * ty;
#pragma unroll
        for (int i = 0; i < 4; ++i) lse[i] = m[i] + log2f(l[i]);
    }
    store_tile_rows<D>(a.o, b, h, (size_t)tile * F32_TILE, o, inv, ty, tx);
}

template <int D>
int launch_f32(const FwdArgs<float>& a, int B, int S, int H, float scale,
               cudaStream_t stream) {
    static bool ready[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(attention_fwd_f32<D>, f32_smem_bytes<D>(), ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(S / F32_TILE, H, B);
    attention_fwd_f32<D><<<grid, F32_THREADS, f32_smem_bytes<D>(), stream>>>(a, S,
                                                                             scale * LOG2E);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int attributes_f32(int* out) {
    static bool ready[MAX_DEVICES] = {};
    const cudaError_t err = allow_smem(attention_fwd_f32<D>, f32_smem_bytes<D>(), ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_attributes(attention_fwd_f32<D>, F32_THREADS, f32_smem_bytes<D>(), out);
}

// Allows the bf16 kernel its dynamic shared memory, once per device.
template <int D, int WGS>
cudaError_t prepare_sm90() {
    static bool ready[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < MAX_DEVICES && ready[dev])) return err;
    err = cudaFuncSetAttribute(attention_fwd_sm90<D, WGS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fwd_smem_bytes<D, WGS>());
    if (err == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
    return err;
}

template <int D, int WGS>
int launch_sm90(const FwdArgs<bf16>& a, int B, int S, int H, float scale,
                cudaStream_t stream) {
    cudaError_t err = prepare_sm90<D, WGS>();
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(S / (64 * WGS), H, B);
    attention_fwd_sm90<D, WGS><<<grid, 128 * WGS, fwd_smem_bytes<D, WGS>(), stream>>>(
        a, S, scale * LOG2E);
    return static_cast<int>(cudaGetLastError());
}

// out[0..4]: registers per thread, local (spill) bytes per thread, shared
// memory per block (static + dynamic), resident blocks per SM, threads per block.
template <int D, int WGS>
int attributes_sm90(int* out) {
    cudaError_t err = prepare_sm90<D, WGS>();
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, attention_fwd_sm90<D, WGS>);
    int blocks = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, attention_fwd_sm90<D, WGS>, 128 * WGS, fwd_smem_bytes<D, WGS>());
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)(fa.sharedSizeBytes + fwd_smem_bytes<D, WGS>());
    out[3] = blocks;
    out[4] = 128 * WGS;
    return 0;
}

template <typename T>
int launch(const FwdArgs<T>& a, int B, int S, int H, int D, float scale, cudaStream_t st) {
    if (B > MAX_GRID_Z) return -3;
    if constexpr (sizeof(T) == 2) {
        // 128-row tiles share each K/V chunk between two warpgroups; 64-row
        // tiles take any S % 64 == 0
        const bool wide = (S % 128 == 0);
        if (D == 64) return wide ? launch_sm90<64, 2>(a, B, S, H, scale, st)
                                 : launch_sm90<64, 1>(a, B, S, H, scale, st);
        if (D == 32) return wide ? launch_sm90<32, 2>(a, B, S, H, scale, st)
                                 : launch_sm90<32, 1>(a, B, S, H, scale, st);
    } else {
        if (D == 64) return launch_f32<64>(a, B, S, H, scale, st);
        if (D == 32) return launch_f32<32>(a, B, S, H, scale, st);
    }
    return -1;
}

template <typename T>
int packed_forward(const void* qkv, const void* bias, void* out, float* lse, int B, int S,
                   int H, int D, float scale, cudaStream_t st) {
    const long long C = (long long)H * D;
    const T* x = static_cast<const T*>(qkv);
    const T* bb = static_cast<const T*>(bias);
    const long long in[3] = {S * 3 * C, 3 * C, D}, o[3] = {S * C, C, D};
    FwdArgs<T> a{operand(x, in), operand(x + C, in), operand(x + 2 * C, in),
                 bb, bb ? bb + C : nullptr, bb ? bb + 2 * C : nullptr,
                 operand(static_cast<T*>(out), o), lse};
    return launch(a, B, S, H, D, scale, st);
}

template <typename T>
int strided_forward(const void* q, const void* k, const void* v, void* out, float* lse,
                    const long long* strides, int B, int S, int H, int D, float scale,
                    cudaStream_t st) {
    FwdArgs<T> a{operand(static_cast<const T*>(q), strides),
                 operand(static_cast<const T*>(k), strides + 3),
                 operand(static_cast<const T*>(v), strides + 6), nullptr, nullptr, nullptr,
                 operand(static_cast<T*>(out), strides + 9), lse};
    return launch(a, B, S, H, D, scale, st);
}

}  // namespace

// The entries below launch on `stream`, do not synchronise, and return the
// CUDA error code of the launch (0 = success), -1 for an unsupported D, -3
// when B exceeds the grid. Tensors are of one type: is_bf16 = 1 for
// bfloat16, 0 for float32. D is 32 or 64 and S a multiple of 64 (any size:
// K and V stream through shared memory); the caller checks both, and the
// alignment. `lse` is a (B, H, S) fp32 array for each row's base-2
// log-sum-exp (attention_common.cuh), written when a gradient is wanted, or
// null: nothing is written.

// K1-fwd. qkv (B, S, 3*H*D) and out (B, S, H*D) contiguous, bias (3*H*D,) or null.
extern "C" int packed_attention_forward(const void* qkv, const void* bias, void* out,
                                        void* lse, int B, int S, int H, int D, int is_bf16,
                                        float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    return is_bf16 ? packed_forward<bf16>(qkv, bias, out, l, B, S, H, D, scale, st)
                   : packed_forward<float>(qkv, bias, out, l, B, S, H, D, scale, st);
}

// K1b-fwd. q, k, v and out are (B, H, S, D) operands given by their base
// pointers and `strides`, twelve element strides: (batch, row, head) for q,
// k, v and out in turn; D is contiguous. Folded (B*H, S, D) tensors are
// H = 1; (B, S, H, D) tensors are read and written in place.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const long long* strides, int B, int S,
                                       int H, int D, int is_bf16, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    return is_bf16 ? strided_forward<bf16>(q, k, v, out, l, strides, B, S, H, D, scale, st)
                   : strided_forward<float>(q, k, v, out, l, strides, B, S, H, D, scale, st);
}

// Launch resources of the bf16 kernel for head dim D (32 or 64) with 128-row
// (wide = 1) or 64-row tiles, into out[0..4]: registers per thread, local
// (spill) bytes per thread, shared memory per block, resident blocks per SM,
// threads per block. Returns 0, -1 for an unsupported D, or a CUDA error code.
extern "C" int attention_forward_attributes(int D, int wide, int* out) {
    if (D == 64) return wide ? attributes_sm90<64, 2>(out) : attributes_sm90<64, 1>(out);
    if (D == 32) return wide ? attributes_sm90<32, 2>(out) : attributes_sm90<32, 1>(out);
    return -1;
}

// The same for the fp32 kernel (64-row tiles) for head dim D (32 or 64).
extern "C" int attention_forward_f32_attributes(int D, int* out) {
    if (D == 64) return attributes_f32<64>(out);
    if (D == 32) return attributes_f32<32>(out);
    return -1;
}

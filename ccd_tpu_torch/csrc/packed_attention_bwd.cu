// Backward of multi-head attention for Hopper (sm_90a), on strided operands.
//
// Replaces two Pallas kernels of ccd_tpu/ops/flash_attention.py with one
// device code: `_packed_bwd_kernel` behind the custom VJP of
// `mha_packed_bias` (K1-bwd, `_packed_bwd_rule`), and `_bwd_kernel` behind
// the custom VJP of `flash_attention` (K1b-bwd, `_bwd_rule`). Each operand is
// a base pointer with a batch stride, a row stride and a per-head column
// offset (attention_common.cuh::Operand). For the packed layout, from the
// un-biased qkv projection (B, S, 3C), its bias (3C,), the forward's output
// O (B, S, C) and saved log-sum-exp lse (B, H, S), and the output's
// cotangent dO (B, S, C) it computes per head, in the units of
// attention_common.cuh (x = (q + bq) . k * scale * log2(e), bk left out),
//
//     P     = 2^(x - lse)                             fp32
//     delta = rowsum(dO * (O - bv))                   fp32
//     dP    = dO v^T                                  fp32 (bv left out)
//     dS    = P * (dP - delta) * scale                fp32, cast to the input type
//     dq = dS k      dk = dS^T (q + bq)      dv = P^T dO   (P cast to the input type)
//
// and writes dq | dk | dv at their column offsets of dqkv (B, S, 3C), which is
// the cotangent of the projection's output as it stands: no transposes, and
// nothing of size S x S ever reaches device memory. (The bias' cotangent is
// the sum of dqkv over B and S, taken by the caller.) For folded (B*H, S, D)
// or (B, S, H, D) tensors it reads q, k, v, O, dO and writes dq, dk, dv where
// they lie, without bias.
//
// The bias algebra is exact in real arithmetic. bk: the forward left it out
// of the logits (the softmax cancels it), so lse is of the bk-free logits and
// so is P here; and dq = dS (k + bk) = dS k + (sum_j dS_ij) bk, where
// sum_j dS_ij = scale * (sum_j P_ij dP_ij - delta_i) = 0. bv: dP_ij - delta_i
// is the same with bv in both terms (dO . (v_j + bv) - dO . O) or in neither
// (dO . v_j - dO . (O - bv)), since each row of P sums to 1 and O - bv = P v.
// bq stays in: the dq kernel adds it to Q's register fragments, the dk/dv
// kernel to each Q chunk in shared memory once its copies have landed, both
// rounded once to the input type as the forward rounds them.
//
// What bounds it on an H100: bytes. At (B, S, C, H) = (128, 256, 384, 6) in
// bf16 the function must read qkv (75.5 MB) and dO (25.2 MB) and write dqkv
// (75.5 MB): 176.2 MB, 0.053 ms at 3.35 TB/s, against 5 products of
// 2*S*S*D flop per head = 32.2 GFLOP, 0.033 ms at 989 TFLOP/s. (This design
// also reads the saved O and lse, 26.0 MB more.) A folded (768, 256, 64)
// call moves the same 176.2 MB.
//
// Design (bf16): two kernels, deterministic and without atomics, since dq
// sums over keys while dk and dv sum over query rows: run twice on the same
// inputs they give the same bits. Seven tile products for each 64 x 64 pair
// of query and key tiles, where a one-kernel design with atomically summed dq
// needs five but loses that reproducibility; at these shapes the seven still
// take 45 GFLOP, 0.046 ms at the tensor cores' rate, under the byte bound.
//
//   * dq: one block of one warpgroup (128 threads) per 64 query rows. K and
//     V stream in 64-key chunks through a ring of STAGES = 3 shared-memory
//     stages filled by 16-byte `cp.async` copies (the forward's ring:
//     attention_sm90.cuh). Q (+ bq, added in place once its copies land)
//     and dO stay in shared memory as the A operands of S = Q K^T and
//     dP = dO V^T (`wgmma`, all K-major); delta for the block's rows comes
//     from O and dO at the start and goes to a (B, H, S) scratch array for
//     the second kernel. Per chunk: S and dP as two commit groups, P's
//     exponentials while dP's products run, dS in registers converted to
//     bf16 A fragments as the forward converts P, then dQ += dS K (K read
//     MN-major through the descriptor's transpose bit).
//   * dk, dv: one block of one warpgroup per 64 keys. Q, dO and the chunk's
//     64 lse and delta values stream through the ring (q + bq in place); K
//     and V stay in shared memory as A operands. Per chunk: S^T = K Q^T and
//     dP^T = V dO^T as two groups, P^T while dP^T runs, dV += P^T dO while
//     dS^T is computed (each thread reads lse and delta of its columns from
//     the stage), then dK += dS^T Q (dO and Q MN-major).
// A operands from shared memory keep the registers low enough for 3 blocks
// of each kernel an SM at D = 64. (A in registers, two warpgroups a dq
// block sharing each chunk, and 2 dk/dv blocks an SM were each no faster on
// the card.) Shared memory does not grow with S
// (any S % 64 == 0 runs). The gradients go out through this warp's rows of
// the Q (dq) or K and V (dk, dv) tiles and then in 16-byte rows.
//
// fp32 kernels (exact fp32, no TF32; their pieces in attention_f32.cuh), the
// same two kernels in the same order with the same contract (lse and delta
// read, not recomputed). What bounds them on an H100: the fp32 pipe. At
// (128, 256, 384, 6) the 5 products of the bound take 32.2 GFLOP, 0.481 ms at
// 67 TFLOP/s (the split design runs 7: 0.673 ms), against 0.105 ms for its
// 352 MB. The kernels they replace gave each thread one row and read one
// operand of every FMA from shared memory (9 % of the bound) and spilled.
// These are register-tiled, as the fp32 forward:
//   * one block of 128 threads per 64 own rows (dq: queries; dk/dv: keys),
//     their two operands staged once, d-major (dq: Q + bq and dO; dk/dv: K
//     and V); the other side streams in 32-row chunks through 2 stages
//     filled by 16-byte `cp.async` copies (dq: K and V; dk/dv: Q, + bq in
//     place, and dO). 72 KB a block at D = 64, so 3 blocks an SM (64-row
//     chunks, 112 KB and 2 blocks, measured slower on the card);
//   * every product is a register-tiled outer product: a thread owns 4 own
//     rows x 4 other rows of S, dP (or their transposes) and 4 rows x D/8
//     columns of dQ, or of dK and dV;
//   * dq: S = (Q + bq) K^T and dP = dO V^T, dS = P (dP - delta) scale with P
//     from the saved lse, then dQ += dS K with dS through this warp's rows
//     of a shared tile (__syncwarp only); delta = rowsum(dO (O - bv)) is
//     computed first and written for the second kernel;
//   * dk/dv: S^T and dP^T from the staged K and V, P^T and dS^T from each
//     query's lse and delta, then dV += P^T dO and dK += dS^T (Q + bq)
//     through the same tile.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"
#include "attention_f32.cuh"
#include "attention_sm90.cuh"

namespace {

constexpr int CHUNK = 64;   // rows per tile and streamed chunk: the block's own rows,
                            // the other side's keys (dq) or queries (dk/dv)
constexpr int NT = 128;     // threads per block: one warpgroup
constexpr int STAGES = 3;   // chunks in shared memory: one read, two landing
constexpr int DQ_BLOCKS = 3;  // resident blocks an SM the register budget allows
constexpr int KV_BLOCKS = 3;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return CHUNK * 2 * D; }  // 64 bf16 rows

// Dynamic shared memory: 1024-byte alignment slack, the Q, dO and O tiles,
// and STAGES x (K, V) chunks.
template <int D>
constexpr size_t dq_smem_bytes() {
    return 1024 + (size_t)(3 + 2 * STAGES) * tile_bytes<D>();
}

// 1024-byte alignment slack, the K and V tiles, STAGES x (Q, dO) chunks, and
// STAGES x 64 (lse, delta) pairs.
template <int D>
constexpr size_t dkdv_smem_bytes() {
    return 1024 + (size_t)(2 + 2 * STAGES) * tile_bytes<D>() + STAGES * 2 * CHUNK * 4;
}

__device__ __forceinline__ float lo_f(uint32_t x) {
    return __low2float(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

__device__ __forceinline__ float hi_f(uint32_t x) {
    return __high2float(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// bias[D] added to this thread's own copies (those `copy` made) of the
// swizzled CHUNK-row tile at `tile`: fp32 add, rounded once, as the forward
// rounds q + bq. The thread's 16-byte column chunk is the same in every row
// it copies. Call once its copies have landed, before the proxy fence.
template <int D>
__device__ __forceinline__ void add_bias_in_place(unsigned char* tile,
                                                  const TileCopy<D, NT>& copy,
                                                  const bf16* bias) {
    constexpr int STEP = TileCopy<D, NT>::STEP;
    const uint4 bb = __ldg(reinterpret_cast<const uint4*>(bias + (threadIdx.x % (D / 8)) * 8));
#pragma unroll
    for (int k = 0; k < CHUNK / STEP; ++k) {
        uint4* x = reinterpret_cast<uint4*>(tile + copy.smem + k * STEP * 2 * D);
        uint4 v = *x;
        v.x = add_pair(v.x, reinterpret_cast<const bf16*>(&bb.x));
        v.y = add_pair(v.y, reinterpret_cast<const bf16*>(&bb.y));
        v.z = add_pair(v.z, reinterpret_cast<const bf16*>(&bb.z));
        v.w = add_pair(v.w, reinterpret_cast<const bf16*>(&bb.w));
        *x = v;
    }
}

// The 64-row fp32 accumulator tile of the block (rows r0 and r0 + 8 of this
// thread, D columns) as bf16 over the warp's own 16 rows of the swizzled tile
// at `tile`, then out 16 bytes a thread to `dst` (the warp's first row; row
// stride `stride` elements).
template <int D>
__device__ __forceinline__ void store_rows(unsigned char* tile, const float (&acc)[D / 2],
                                           int r0, int wrow, int t, int lane, bf16* dst,
                                           size_t stride) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * t;
        *reinterpret_cast<uint32_t*>(tile + swizzled_pair<D>(r0, col)) =
            pack_bf16(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<uint32_t*>(tile + swizzled_pair<D>(r0 + 8, col)) =
            pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * (D / 8); i += 32) {
        const int r = i / (D / 8), c = i % (D / 8);
        *reinterpret_cast<uint4*>(dst + (size_t)r * stride + c * 8) =
            *reinterpret_cast<const uint4*>(tile + swizzled<D>(wrow + r, c));
    }
}

// grid (S / 64, H, B), block 128 threads, dynamic shared memory
// dq_smem_bytes<D>(). Warp i owns query rows 16i..16i+15 of the tile (the
// wgmma fragment layout).
template <int D>
__global__ void __launch_bounds__(NT, DQ_BLOCKS)
attention_bwd_dq_sm90(const BwdArgs<bf16> a, int S) {
    constexpr uint32_t TILE = tile_bytes<D>();
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's pattern needs 1024
    unsigned char* const q_tile = smem_raw + (base - raw);  // Q + bq, later dQ
    const unsigned char* const do_tile = q_tile + TILE;
    const unsigned char* const o_tile = do_tile + TILE;
    const uint32_t ring = base + 3 * TILE;  // stage s: K at 2s tiles, V after it

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * CHUNK;
    const size_t ks = a.k.row_stride, vs = a.v.row_stride;
    const bf16* kg = a.k.at(b, h, 0);
    const bf16* vg = a.v.at(b, h, 0);
    const int chunks = S / CHUNK;
    const TileCopy<D, NT> kc(ks), vc(vs);
    auto load_chunk = [&](int n) {  // chunk n into its stage, as one copy group
        if (n < chunks) {
            const uint32_t st = ring + 2 * (n % STAGES) * TILE;
            kc.template issue<CHUNK>(st, kg + (size_t)n * CHUNK * ks);
            vc.template issue<CHUNK>(st + TILE, vg + (size_t)n * CHUNK * vs);
        }
        cp_async_commit();
    };

    const TileCopy<D, NT> qc(a.q.row_stride);
    qc.template issue<CHUNK>(base, a.q.at(b, h, row0));
    TileCopy<D, NT>(a.dout.row_stride).template issue<CHUNK>(base + TILE, a.dout.at(b, h, row0));
    TileCopy<D, NT>(a.o.row_stride).template issue<CHUNK>(base + 2 * TILE, a.o.at(b, h, row0));
    cp_async_commit();
#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n) load_chunk(n);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // fragment row group / column pair
    const int r0 = warp * 16 + g;           // this thread's rows r0 and r0 + 8 of the tile
    const size_t note = ((size_t)b * gridDim.y + h) * S + row0 + r0;
    const float L0 = a.lse[note], L1 = a.lse[note + 8];

    cp_async_wait<STAGES - 1>();
    const bf16* bq = head_bias(a.bq, h, D);
    if (bq != nullptr) add_bias_in_place<D>(q_tile, qc, bq);
    fence_proxy_async();
    __syncthreads();
    // delta = rowsum(dO * (O - bv)) at this thread's fragment positions (a
    // quarter of two rows), summed over the quad
    const bf16* bv = head_bias(a.bv, h, D);
    float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = kk * 16 + (e >> 1) * 8 + 2 * t;
            const uint32_t off = swizzled_pair<D>(r0 + (e & 1) * 8, col);
            const uint32_t o = *reinterpret_cast<const uint32_t*>(o_tile + off);
            const uint32_t d = *reinterpret_cast<const uint32_t*>(do_tile + off);
            float o0 = lo_f(o), o1 = hi_f(o);
            if (bv != nullptr) {
                o0 -= __bfloat162float(bv[col]);
                o1 -= __bfloat162float(bv[col + 1]);
            }
            const float part = fmaf(lo_f(d), o0, hi_f(d) * o1);
            if (e & 1) dl1 += part; else dl0 += part;
        }
    }
    dl0 = quad_sum(dl0);
    dl1 = quad_sum(dl1);
    if (t == 0) {
        a.delta[note] = dl0;
        a.delta[note + 8] = dl1;
    }

    // A operands from shared memory: Q + bq and dO, K-major
    const uint64_t qdesc = smem_desc<D>(base), dodesc = qdesc + (TILE >> 4);
    const float scale = a.scale, c = a.scale * LOG2E;  // x = s * c (either sign)
    float dq[D / 2];
    zero(dq);
    for (int j = 0; j < chunks; ++j) {
        cp_async_wait<STAGES - 2>();  // this thread's copies of chunk j have landed
        fence_proxy_async();          // ... and are visible to wgmma
        __syncthreads();              // everyone's; and chunk j - 1's stage is free
        load_chunk(j + STAGES - 1);
        // a 16-deep step of D is 32 bytes along a row, a 16-key step 16 rows
        // (descriptor start addresses are in 16-byte units)
        const uint64_t kdesc = smem_desc<D>(ring + 2 * (j % STAGES) * TILE);
        const uint64_t vdesc = kdesc + (TILE >> 4);

        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each, fp32, as two
        // groups: P is computed while dP's products run
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_ss<0>(s, qdesc + kk * (32 >> 4), kdesc + kk * (32 >> 4), kk);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_ss<0>(dp, dodesc + kk * (32 >> 4), vdesc + kk * (32 >> 4), kk);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = exp2_ftz(fmaf(s[i], c, (i & 2) ? -L1 : -L0));
        wgmma_wait<0>();
        fence_regs(dp);

        // dS = P (dP - delta) scale in bf16, as the A fragments of four
        // 16-key steps: the accumulator blocks of key octets 2kk and 2kk + 1
        uint32_t dsa[4][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            dsa[i >> 1][(i & 1) * 2] = pack_bf16(s[4 * i] * (dp[4 * i] - dl0) * scale,
                                                 s[4 * i + 1] * (dp[4 * i + 1] - dl0) * scale);
            dsa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(s[4 * i + 2] * (dp[4 * i + 2] - dl1) * scale,
                                                     s[4 * i + 3] * (dp[4 * i + 3] - dl1) * scale);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);

        // dQ += dS K, K read MN-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, dsa[kk], kdesc + kk * (16 * 2 * D >> 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
    }

    // every warp's products have read the Q tile; each warp stages its rows
    // over its own 16 rows of it
    __syncthreads();
    store_rows<D>(q_tile, dq, r0, warp * 16, t, lane, a.dq.at(b, h, row0 + warp * 16),
                  a.dq.row_stride);
}

// grid (S / 64, H, B), block 128 threads, dynamic shared memory
// dkdv_smem_bytes<D>(). Runs after the dq kernel on the same stream and reads
// its delta. Warp i owns keys 16i..16i+15 of the tile.
template <int D>
__global__ void __launch_bounds__(NT, KV_BLOCKS)
attention_bwd_dkdv_sm90(const BwdArgs<bf16> a, int S) {
    constexpr uint32_t TILE = tile_bytes<D>();
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* const k_tile = smem_raw + (base - raw);  // K tile, later dK
    unsigned char* const v_tile = k_tile + TILE;            // V tile, later dV
    const uint32_t ring = base + 2 * TILE;  // stage s: Q at 2s tiles, dO after it
    const uint32_t stats = ring + 2 * STAGES * TILE;  // stage s: 64 lse, then 64 delta
    const float* const stats_ptr = reinterpret_cast<const float*>(smem_raw + (stats - raw));

    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t key0 = (size_t)tile * CHUNK;
    const size_t qs = a.q.row_stride, ds = a.dout.row_stride;
    const bf16* qg = a.q.at(b, h, 0);
    const bf16* dog = a.dout.at(b, h, 0);
    const size_t note0 = ((size_t)b * gridDim.y + h) * S;
    const int chunks = S / CHUNK;
    const TileCopy<D, NT> qc(qs), dc(ds);
    auto load_chunk = [&](int n) {  // query chunk n into its stage, as one copy group
        if (n < chunks) {
            const int st = n % STAGES;
            qc.template issue<CHUNK>(ring + 2 * st * TILE, qg + (size_t)n * CHUNK * qs);
            dc.template issue<CHUNK>(ring + (2 * st + 1) * TILE, dog + (size_t)n * CHUNK * ds);
            if (threadIdx.x < 32) {  // 2 x 64 floats, 16 bytes a thread
                const int i = threadIdx.x;
                const float* src = (i < 16 ? a.lse : a.delta) + note0 + (size_t)n * CHUNK +
                                   (i & 15) * 4;
                cp_async16(stats + st * 2 * CHUNK * 4 + i * 16, src);
            }
        }
        cp_async_commit();
    };
    TileCopy<D, NT>(a.k.row_stride).template issue<CHUNK>(base, a.k.at(b, h, key0));
    TileCopy<D, NT>(a.v.row_stride).template issue<CHUNK>(base + TILE, a.v.at(b, h, key0));
    cp_async_commit();
#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n) load_chunk(n);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's keys r0 and r0 + 8 of the tile
    const bf16* bq = head_bias(a.bq, h, D);
    // A operands from shared memory: K and V, K-major (bk and bv are not
    // needed, see the top)
    const uint64_t kdesc = smem_desc<D>(base), vdesc = kdesc + (TILE >> 4);
    const float scale = a.scale, c = a.scale * LOG2E;
    float dk[D / 2], dv[D / 2];
    zero(dk);
    zero(dv);
    for (int j = 0; j < chunks; ++j) {
        const int st = j % STAGES;
        cp_async_wait<STAGES - 2>();  // this thread's copies of chunk j (and K, V) landed
        if (bq != nullptr) add_bias_in_place<D>(smem_raw + (ring + 2 * st * TILE - raw), qc, bq);
        fence_proxy_async();
        __syncthreads();
        load_chunk(j + STAGES - 1);
        const uint64_t qdesc = smem_desc<D>(ring + 2 * st * TILE);
        const uint64_t dodesc = qdesc + (TILE >> 4);

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, fp32, as
        // two groups; then dV += P^T dO runs while dS^T is computed
        float sT[32], dpT[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_ss<0>(sT, kdesc + kk * (32 >> 4), qdesc + kk * (32 >> 4), kk);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_ss<0>(dpT, vdesc + kk * (32 >> 4), dodesc + kk * (32 >> 4), kk);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sT);

        // P^T (fp32, over S^T) and in bf16 as A fragments; this thread's
        // columns are the queries 8i + 2t and 8i + 2t + 1 of the chunk
        const float* ls = stats_ptr + st * 2 * CHUNK;
        const float* dls = ls + CHUNK;
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float2 L = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * t);
            sT[4 * i] = exp2_ftz(fmaf(sT[4 * i], c, -L.x));
            sT[4 * i + 1] = exp2_ftz(fmaf(sT[4 * i + 1], c, -L.y));
            sT[4 * i + 2] = exp2_ftz(fmaf(sT[4 * i + 2], c, -L.x));
            sT[4 * i + 3] = exp2_ftz(fmaf(sT[4 * i + 3], c, -L.y));
            pa[i >> 1][(i & 1) * 2] = pack_bf16(sT[4 * i], sT[4 * i + 1]);
            pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(sT[4 * i + 2], sT[4 * i + 3]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dv, pa[kk], dodesc + kk * (16 * 2 * D >> 4), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed; dV may still run
        fence_regs(dpT);

#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * i + 2 * t);
            dsa[i >> 1][(i & 1) * 2] = pack_bf16(sT[4 * i] * (dpT[4 * i] - dl.x) * scale,
                                                 sT[4 * i + 1] * (dpT[4 * i + 1] - dl.y) * scale);
            dsa[i >> 1][(i & 1) * 2 + 1] =
                pack_bf16(sT[4 * i + 2] * (dpT[4 * i + 2] - dl.x) * scale,
                          sT[4 * i + 3] * (dpT[4 * i + 3] - dl.y) * scale);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
        // dK += dS^T (Q + bq), Q read MN-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk, dsa[kk], qdesc + kk * (16 * 2 * D >> 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(dsa[kk]);
        }
    }

    // every warp's products have read the K and V tiles; each warp stages its
    // rows over its own 16 rows of them
    __syncthreads();
    const int wrow = warp * 16;
    store_rows<D>(k_tile, dk, r0, wrow, t, lane, a.dk.at(b, h, key0 + wrow), a.dk.row_stride);
    store_rows<D>(v_tile, dv, r0, wrow, t, lane, a.dv.at(b, h, key0 + wrow), a.dv.row_stride);
}

constexpr int F32_STREAM = 32;  // rows of the other side's chunks, fp32 kernels
constexpr int F32_NJ = F32_STREAM / 8;  // of them, per thread

// Dynamic shared memory of each fp32 kernel: two d-major tiles of the
// block's own 64 rows (dq: Q + bq and dO; dk/dv: K and V), the 32 x 64 tile
// of probabilities or dS, and 2 stages of the other side's two 32-row chunks
// (dq: K and V; dk/dv: Q + bq and dO).
template <int D>
constexpr size_t f32_smem_bytes() {
    return (size_t)(2 * D * F32_TILE + F32_STREAM * F32_TILE + 2 * 2 * F32_STREAM * D) * 4;
}

// Pointers into a fp32 kernel's dynamic shared memory.
template <int D>
struct F32Smem {
    static constexpr int OWN = F32_TILE * D;      // floats of an own-row tile
    static constexpr int CHUNK = F32_STREAM * D;  // floats of a streamed chunk
    float* own0;  // d-major, D x 64
    float* own1;
    float* pt;    // 32 x 64, indexed [other side's row][own row]
    float* ring;  // stage s: the first chunk at 2s chunks, the second after it

    __device__ __forceinline__ explicit F32Smem(float* base)
        : own0(base), own1(base + OWN), pt(base + 2 * OWN),
          ring(base + 2 * OWN + F32_STREAM * F32_TILE) {}

    __device__ __forceinline__ float* stage(int n) const { return ring + (n & 1) * 2 * CHUNK; }
};

// grid (S / 64, H, B), block 128 threads, dynamic shared memory
// f32_smem_bytes<D>(). Thread (ty, tx) (attention_f32.cuh) owns query rows
// 4ty..4ty+3 of the tile (their lse and delta in registers, their dQ
// columns 4(tx + 8h)..+3) and, of each 32-key chunk, keys tx + 8j. Writes
// delta for the tile's rows.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, D == 64 ? 3 : 4)
attention_bwd_dq_f32(const BwdArgs<float> a, int S) {
    extern __shared__ float4 smem_f4[];
    const F32Smem<D> sm(reinterpret_cast<float*>(smem_f4));
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int tx = lane & 7, ty = (threadIdx.x >> 5) * 4 + (lane >> 3);
    const size_t row0 = (size_t)tile * F32_TILE;
    const float scale = a.scale, c = a.scale * LOG2E;
    const size_t ks = a.k.row_stride, vs = a.v.row_stride;
    const float* kg = a.k.at(b, h, 0);
    const float* vg = a.v.at(b, h, 0);
    const int chunks = S / F32_STREAM;
    const ChunkCopy<D, F32_STREAM> copy;
    auto load_chunk = [&](int n) {  // K and V chunk n into stage n % 2, as one copy group
        if (n < chunks) {
            float* st = sm.stage(n);
            copy.issue(st, kg + (size_t)n * F32_STREAM * ks, ks);
            copy.issue(st + F32Smem<D>::CHUNK, vg + (size_t)n * F32_STREAM * vs, vs);
        }
        cp_async_commit();
    };

    load_chunk(0);
    stage_dmajor<D>(sm.own0, a.q.at(b, h, row0), a.q.row_stride, head_bias(a.bq, h, D));
    stage_dmajor<D>(sm.own1, a.dout.at(b, h, row0), a.dout.row_stride, nullptr);

    // delta = rowsum(dO * (O - bv)) of this thread's rows: each of the eight
    // threads sharing them sums its columns, then the eight together
    const float* bv = head_bias(a.bv, h, D);
    const size_t note = ((size_t)b * gridDim.y + h) * S + row0 + 4 * ty;
    float L[4], dl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float* op = a.o.at(b, h, row0 + 4 * ty + i);
        const float* dop = a.dout.at(b, h, row0 + 4 * ty + i);
        float acc = 0.f;
#pragma unroll
        for (int hh = 0; hh < D / 32; ++hh) {
            const int col = 4 * (tx + 8 * hh);
            float4 o4 = ldg4(op + col);
            if (bv != nullptr) {
                const float4 b4 = ldg4(bv + col);
                o4.x -= b4.x; o4.y -= b4.y; o4.z -= b4.z; o4.w -= b4.w;
            }
            const float4 d4 = ldg4(dop + col);
            acc = fmaf(d4.x, o4.x, acc);
            acc = fmaf(d4.y, o4.y, acc);
            acc = fmaf(d4.z, o4.z, acc);
            acc = fmaf(d4.w, o4.w, acc);
        }
        dl[i] = row_sum8(acc);
        L[i] = a.lse[note + i];
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a.delta[note + i] = dl[i];
    }

    float dq[4][D / 8];
    zero(dq);
    for (int j = 0; j < chunks; ++j) {
        cp_async_wait<0>();  // this thread's copies of chunk j have landed
        __syncthreads();     // everyone's (and Q, dO); chunk j - 1's stage is free
        load_chunk(j + 1);   // in flight while chunk j is computed
        const float* kc = sm.stage(j);
        const float* vc = kc + F32Smem<D>::CHUNK;

        float s[4][F32_NJ], dp[4][F32_NJ];
        zero(s);
        mm_nt<D, F32_NJ>(s, sm.own0, kc, ty, tx);   // S = (Q + bq) K^T
        zero(dp);
        mm_nt<D, F32_NJ>(dp, sm.own1, vc, ty, tx);  // dP = dO V^T
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < F32_NJ; ++k) {      // dS = P * (dP - delta) * scale
                s[i][k] = exp2_ftz(fmaf(s[i][k], c, -L[i])) * (dp[i][k] - dl[i]) * scale;
            }
        }
        store_transposed(sm.pt, s, ty, tx);
        __syncwarp();
        mm_nn<D, F32_STREAM>(dq, sm.pt, kc, ty, tx);  // dQ += dS K
    }
    const float one[4] = {1.f, 1.f, 1.f, 1.f};
    store_tile_rows<D>(a.dq, b, h, row0, dq, one, ty, tx);
}

// grid (S / 64, H, B), block 128 threads, dynamic shared memory
// f32_smem_bytes<D>(). Thread (ty, tx) owns key rows 4ty..4ty+3 of the tile
// (their dK and dV columns 4(tx + 8h)..+3) and, of each 32-query chunk,
// queries tx + 8j (their lse and delta in registers).
template <int D>
__global__ void __launch_bounds__(F32_THREADS, D == 64 ? 3 : 4)
attention_bwd_dkdv_f32(const BwdArgs<float> a, int S) {
    extern __shared__ float4 smem_f4[];
    const F32Smem<D> sm(reinterpret_cast<float*>(smem_f4));
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int tx = lane & 7, ty = (threadIdx.x >> 5) * 4 + (lane >> 3);
    const size_t row0 = (size_t)tile * F32_TILE;
    const float scale = a.scale, c = a.scale * LOG2E;
    const size_t qs = a.q.row_stride, ds = a.dout.row_stride;
    const float* qg = a.q.at(b, h, 0);
    const float* dg = a.dout.at(b, h, 0);
    const float* bq = head_bias(a.bq, h, D);
    const int chunks = S / F32_STREAM;
    const ChunkCopy<D, F32_STREAM> copy;
    auto load_chunk = [&](int n) {  // Q and dO chunk n into stage n % 2, as one copy group
        if (n < chunks) {
            float* st = sm.stage(n);
            copy.issue(st, qg + (size_t)n * F32_STREAM * qs, qs);
            copy.issue(st + F32Smem<D>::CHUNK, dg + (size_t)n * F32_STREAM * ds, ds);
        }
        cp_async_commit();
    };

    load_chunk(0);
    stage_dmajor<D>(sm.own0, a.k.at(b, h, row0), a.k.row_stride, nullptr);
    stage_dmajor<D>(sm.own1, a.v.at(b, h, row0), a.v.row_stride, nullptr);
    const size_t note0 = ((size_t)b * gridDim.y + h) * S + tx;

    float dk[4][D / 8], dv[4][D / 8];
    zero(dk);
    zero(dv);
    for (int j = 0; j < chunks; ++j) {
        cp_async_wait<0>();  // this thread's copies of chunk j have landed
        float* const qc = sm.stage(j);
        const float* doc = qc + F32Smem<D>::CHUNK;
        if (bq != nullptr) copy.add_bias(qc, bq);
        __syncthreads();     // everyone's (and K, V); chunk j - 1's stage is free
        load_chunk(j + 1);   // in flight while chunk j is computed

        const float* lse = a.lse + note0 + (size_t)j * F32_STREAM;
        const float* delta = a.delta + note0 + (size_t)j * F32_STREAM;
        float L[F32_NJ], dl[F32_NJ];
#pragma unroll
        for (int k = 0; k < F32_NJ; ++k) {
            L[k] = __ldg(lse + 8 * k);
            dl[k] = __ldg(delta + 8 * k);
        }
        float p[4][F32_NJ], dp[4][F32_NJ];
        zero(p);
        mm_nt<D, F32_NJ>(p, sm.own0, qc, ty, tx);    // S^T = K (Q + bq)^T
        zero(dp);
        mm_nt<D, F32_NJ>(dp, sm.own1, doc, ty, tx);  // dP^T = V dO^T
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < F32_NJ; ++k) {
                p[i][k] = exp2_ftz(fmaf(p[i][k], c, -L[k]));
                dp[i][k] = p[i][k] * (dp[i][k] - dl[k]) * scale;  // dS^T
            }
        }
        store_transposed(sm.pt, p, ty, tx);
        __syncwarp();
        mm_nn<D, F32_STREAM>(dv, sm.pt, doc, ty, tx);  // dV += P^T dO
        __syncwarp();  // the warp's reads of P^T are done
        store_transposed(sm.pt, dp, ty, tx);
        __syncwarp();
        mm_nn<D, F32_STREAM>(dk, sm.pt, qc, ty, tx);   // dK += dS^T (Q + bq)
    }
    const float one[4] = {1.f, 1.f, 1.f, 1.f};
    store_tile_rows<D>(a.dk, b, h, row0, dk, one, ty, tx);
    store_tile_rows<D>(a.dv, b, h, row0, dv, one, ty, tx);
}

// Allows both bf16 kernels their dynamic shared memory, once per device.
template <int D>
cudaError_t prepare_sm90() {
    static bool ready[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < MAX_DEVICES && ready[dev])) return err;
    err = cudaFuncSetAttribute(attention_bwd_dq_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem_bytes<D>());
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(attention_bwd_dkdv_sm90<D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)dkdv_smem_bytes<D>());
    }
    if (err == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
    return err;
}

template <int D>
int launch_bf16(const BwdArgs<bf16>& a, int B, int S, int H, cudaStream_t stream) {
    cudaError_t err = prepare_sm90<D>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(S / CHUNK, H, B);
    attention_bwd_dq_sm90<D><<<grid, NT, dq_smem_bytes<D>(), stream>>>(a, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_sm90<D><<<grid, NT, dkdv_smem_bytes<D>(), stream>>>(a, S);
    return static_cast<int>(cudaGetLastError());
}

// Allows both fp32 kernels their dynamic shared memory, once per device.
template <int D>
cudaError_t prepare_f32() {
    static bool dq_ready[MAX_DEVICES] = {}, kv_ready[MAX_DEVICES] = {};
    cudaError_t err = allow_smem(attention_bwd_dq_f32<D>, f32_smem_bytes<D>(), dq_ready);
    if (err == cudaSuccess) {
        err = allow_smem(attention_bwd_dkdv_f32<D>, f32_smem_bytes<D>(), kv_ready);
    }
    return err;
}

template <int D>
int launch_f32(const BwdArgs<float>& a, int B, int S, int H, cudaStream_t stream) {
    cudaError_t err = prepare_f32<D>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(S / F32_TILE, H, B);
    attention_bwd_dq_f32<D><<<grid, F32_THREADS, f32_smem_bytes<D>(), stream>>>(a, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_f32<D><<<grid, F32_THREADS, f32_smem_bytes<D>(), stream>>>(a, S);
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

template <int D>
int attributes(int is_bf16, int kernel, int* out) {
    if (!is_bf16) {
        const cudaError_t err = prepare_f32<D>();
        if (err != cudaSuccess) return static_cast<int>(err);
        return kernel == 0
            ? launch_attributes(attention_bwd_dq_f32<D>, F32_THREADS, f32_smem_bytes<D>(), out)
            : launch_attributes(attention_bwd_dkdv_f32<D>, F32_THREADS, f32_smem_bytes<D>(), out);
    }
    const cudaError_t err = prepare_sm90<D>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return kernel == 0
        ? launch_attributes(attention_bwd_dq_sm90<D>, NT, dq_smem_bytes<D>(), out)
        : launch_attributes(attention_bwd_dkdv_sm90<D>, NT, dkdv_smem_bytes<D>(), out);
}

template <typename T>
int packed_backward(const void* qkv, const void* bias, const void* out, const void* lse,
                    const void* dout, void* dqkv, void* delta, int B, int S, int H, int D,
                    float scale, cudaStream_t st) {
    const long long C = (long long)H * D;
    const T* x = static_cast<const T*>(qkv);
    const T* bb = static_cast<const T*>(bias);
    T* dx = static_cast<T*>(dqkv);
    const long long in[3] = {S * 3 * C, 3 * C, D}, o[3] = {S * C, C, D};
    BwdArgs<T> a{operand(x, in), operand(x + C, in), operand(x + 2 * C, in),
                 operand(static_cast<const T*>(out), o), operand(static_cast<const T*>(dout), o),
                 bb, bb ? bb + C : nullptr, bb ? bb + 2 * C : nullptr,
                 operand(dx, in), operand(dx + C, in), operand(dx + 2 * C, in),
                 static_cast<const float*>(lse), static_cast<float*>(delta), scale};
    return launch(a, B, S, H, D, st);
}

template <typename T>
int strided_backward(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, void* dq, void* dk, void* dv, const void* lse,
                     void* delta, const long long* strides, int B, int S, int H, int D,
                     float scale, cudaStream_t st) {
    BwdArgs<T> a{operand(static_cast<const T*>(q), strides),
                 operand(static_cast<const T*>(k), strides + 3),
                 operand(static_cast<const T*>(v), strides + 6),
                 operand(static_cast<const T*>(out), strides + 9),
                 operand(static_cast<const T*>(dout), strides + 12),
                 nullptr, nullptr, nullptr,
                 operand(static_cast<T*>(dq), strides + 15),
                 operand(static_cast<T*>(dk), strides + 18),
                 operand(static_cast<T*>(dv), strides + 21),
                 static_cast<const float*>(lse), static_cast<float*>(delta), scale};
    return launch(a, B, S, H, D, st);
}

}  // namespace

// The entries below launch both kernels on `stream`, do not synchronise, and
// return the CUDA error code of the launches (0 = success), -1 for an
// unsupported D, -3 when B exceeds the grid. Tensors are of one type:
// is_bf16 = 1 for bfloat16, 0 for float32. `out` and `lse` are what the
// forward returned and saved for these inputs (lse in the units of
// attention_common.cuh); `delta` is (B, H, S) fp32 scratch that the first
// kernel fills and the second reads. D is 32 or 64 and S a multiple of 64
// (any size: the other side's rows stream through shared memory); the
// caller checks both, and the alignment.

// K1-bwd. qkv and dqkv (B, S, 3*H*D), out and dout (B, S, H*D) contiguous,
// bias (3*H*D,) or null, lse (B, H, S).
extern "C" int packed_attention_backward(const void* qkv, const void* bias, const void* out,
                                         const void* lse, const void* dout, void* dqkv,
                                         void* delta, int B, int S, int H, int D, int is_bf16,
                                         float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? packed_backward<bf16>(qkv, bias, out, lse, dout, dqkv, delta, B, S, H, D, scale, st)
        : packed_backward<float>(qkv, bias, out, lse, dout, dqkv, delta, B, S, H, D, scale,
                                 st);
}

// K1b-bwd. q, k, v, out, dout, dq, dk and dv are (B, H, S, D) operands given
// by their base pointers and `strides`, twenty-four element strides: (batch,
// row, head) for each in that order; D is contiguous. lse (B, H, S).
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, void* dq, void* dk,
                                        void* dv, const void* lse, void* delta,
                                        const long long* strides, int B, int S, int H, int D,
                                        int is_bf16, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? strided_backward<bf16>(q, k, v, out, dout, dq, dk, dv, lse, delta,
                                            strides, B, S, H, D, scale, st)
                   : strided_backward<float>(q, k, v, out, dout, dq, dk, dv, lse, delta,
                                             strides, B, S, H, D, scale, st);
}

// Launch resources of one backward kernel (kernel 0: dq, 1: dk/dv) for head
// dim D (32 or 64), bf16 (is_bf16 = 1) or fp32, into out[0..4]: registers per
// thread, local (spill) bytes per thread, shared memory per block, resident
// blocks per SM, threads per block. Returns 0, -1 for an unsupported D, or a
// CUDA error code.
extern "C" int attention_backward_attributes(int D, int is_bf16, int kernel, int* out) {
    if (D == 64) return attributes<64>(is_bf16, kernel, out);
    if (D == 32) return attributes<32>(is_bf16, kernel, out);
    return -1;
}

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
// fp32 kernels: scalar FMA, one row per thread, exact fp32 (no TF32), the
// same contract: they read lse and delta instead of recomputing them.
//
// Plain C interface, loaded with ctypes; see ccd_tpu_torch/ops/flash_attention.py.

#include "attention_common.cuh"
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

constexpr int F32_ROWS = 64;     // rows (= threads) per block, fp32 kernels
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
// so the threads' rows fall into different banks). Writes delta for its row.
template <int D>
__global__ void __launch_bounds__(F32_ROWS)
attention_bwd_dq_f32(const BwdArgs<float> a, int S) {
    __shared__ __align__(16) float Ks[F32_KEYS * D];
    __shared__ __align__(16) float Vs[F32_KEYS * D];
    __shared__ float dOs[F32_ROWS * (D + 1)];
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * F32_ROWS, row = row0 + threadIdx.x;
    const float scale = a.scale, c = a.scale * LOG2E;

    float q[D];
    load_row_f32<D>(q, a.q.at(b, h, row), head_bias(a.bq, h, D));
    load_rows_f32<D>(dOs, D + 1, a.dout.at(b, h, row0), a.dout.row_stride, F32_ROWS, nullptr);
    __syncthreads();
    const float* dO = dOs + threadIdx.x * (D + 1);
    const float* op = a.o.at(b, h, row);
    const float* bv = head_bias(a.bv, h, D);
    float dl = 0.f;  // rowsum(dO * (O - bv))
#pragma unroll
    for (int d = 0; d < D; ++d) dl = fmaf(dO[d], op[d] - (bv != nullptr ? bv[d] : 0.f), dl);
    const size_t note = ((size_t)b * gridDim.y + h) * S + row;
    const float L = a.lse[note];
    a.delta[note] = dl;

    float dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    for (int k0 = 0; k0 < S; k0 += F32_KEYS) {
        __syncthreads();  // the previous chunk is no longer read
        load_rows_f32<D>(Ks, D, a.k.at(b, h, k0), a.k.row_stride, F32_KEYS, nullptr);
        load_rows_f32<D>(Vs, D, a.v.at(b, h, k0), a.v.row_stride, F32_KEYS, nullptr);
        __syncthreads();
        for (int j = 0; j < F32_KEYS; ++j) {
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                s = fmaf(q[d], Ks[j * D + d], s);
                dp = fmaf(dO[d], Vs[j * D + d], dp);
            }
            const float ds = exp2f(fmaf(s, c, -L)) * (dp - dl) * scale;
#pragma unroll
            for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, Ks[j * D + d], dq[d]);
        }
    }
    store_row_f32<D>(a.dq.at(b, h, row), dq);
}

// grid (S / 64, H, B), block 64 threads; thread r owns key row r of the
// tile: its k and v rows in shared memory (row stride D + 1), dk and dv in
// registers; queries stream through shared memory 16 at a time.
template <int D>
__global__ void __launch_bounds__(F32_ROWS)
attention_bwd_dkdv_f32(const BwdArgs<float> a, int S) {
    __shared__ float Kt[F32_ROWS * (D + 1)];
    __shared__ float Vt[F32_ROWS * (D + 1)];
    __shared__ __align__(16) float Qc[F32_QUERIES * D];
    __shared__ __align__(16) float dOc[F32_QUERIES * D];
    __shared__ float Lc[F32_QUERIES], Dc[F32_QUERIES];
    const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const size_t row0 = (size_t)tile * F32_ROWS;
    const float scale = a.scale, c = a.scale * LOG2E;
    load_rows_f32<D>(Kt, D + 1, a.k.at(b, h, row0), a.k.row_stride, F32_ROWS, nullptr);
    load_rows_f32<D>(Vt, D + 1, a.v.at(b, h, row0), a.v.row_stride, F32_ROWS, nullptr);
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
            const float p = exp2f(fmaf(s, c, -Lc[i]));
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

template <int D>
int launch_f32(const BwdArgs<float>& a, int B, int S, int H, cudaStream_t stream) {
    dim3 grid(S / F32_ROWS, H, B);
    attention_bwd_dq_f32<D><<<grid, F32_ROWS, 0, stream>>>(a, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkdv_f32<D><<<grid, F32_ROWS, 0, stream>>>(a, S);
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

// out[0..4] of `kernel`: registers per thread, local (spill) bytes per
// thread, shared memory per block (static + dynamic), resident blocks per
// SM, threads per block.
template <typename K>
int kernel_attributes(K kernel, int threads, size_t dynamic_smem, int* out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    int blocks = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                            dynamic_smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)(fa.sharedSizeBytes + dynamic_smem);
    out[3] = blocks;
    out[4] = threads;
    return 0;
}

template <int D>
int attributes(int is_bf16, int kernel, int* out) {
    if (!is_bf16) {
        return kernel == 0 ? kernel_attributes(attention_bwd_dq_f32<D>, F32_ROWS, 0, out)
                           : kernel_attributes(attention_bwd_dkdv_f32<D>, F32_ROWS, 0, out);
    }
    const cudaError_t err = prepare_sm90<D>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return kernel == 0
        ? kernel_attributes(attention_bwd_dq_sm90<D>, NT, dq_smem_bytes<D>(), out)
        : kernel_attributes(attention_bwd_dkdv_sm90<D>, NT, dkdv_smem_bytes<D>(), out);
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

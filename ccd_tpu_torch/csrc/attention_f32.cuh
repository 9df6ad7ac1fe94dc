// Pieces of the fp32 attention kernels (forward and backward): 64-row fp32
// tiles in shared memory, their 16-byte asynchronous copies, and the two
// register-tiled products that every fp32 kernel is made of.
//
// Threads. A block has 128 threads (four warps). Thread (ty, tx), with
// ty = 4 * warp + lane / 8 (0..15) and tx = lane % 8, owns rows 4ty..4ty+3
// of its block's 64-row tile and, of a chunk of the other side (64 rows in
// the forward, 32 in the backward), rows tx + 8j: a 4 x 8 (or 4 x 4)
// micro-tile of every such product (S, dP and their transposes), and
// 4 rows x D/8 columns (4(tx + 8h) .. 4(tx + 8h) + 3, h < D/32) of every
// 64 x D product (O, dQ, dK, dV). The eight threads that share rows are
// lanes of one warp, so row maxima and sums go through __shfl_xor_sync over
// lane bits 0..2, and a tile of probabilities passes from the threads that
// computed it to those that multiply it through the warp's own rows of a
// shared tile, with __syncwarp only.
//
// Tiles in shared memory (fp32):
//   * row-major, R rows x W floats (W = D for a chunk of K, V, Q or dO;
//     W = 64 for a tile of probabilities indexed [other side][own row]):
//     16-byte chunk c of row r is stored at chunk c ^ (r % 8). Threads
//     reading chunk c of rows tx + 8j (one row per lane group) and threads
//     reading eight chunks of one row both meet eight distinct bank groups;
//   * d-major, D rows x 64 floats (the block's own rows as columns): a
//     thread's four rows at one d are one 16-byte load. Staged once per
//     block with ordinary loads (consecutive threads on consecutive rows,
//     so the transposing stores do not conflict).
// Every FMA takes both operands from registers: per 4 steps of d a thread
// loads 8 + 4 (or 4 + 4) 16-byte values for 128 (or 64) FMAs of S, and per
// row of the other side 1 + D/32 values for D/2 FMAs of O, so the fp32
// pipe, not shared memory, sets the pace.
#pragma once

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace {

constexpr int F32_TILE = 64;      // rows of every tile and chunk
constexpr int F32_THREADS = 128;  // threads per block of every fp32 kernel

// Float offset of 16-byte chunk `chunk` of row `row` in a row-major tile W
// floats wide.
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
    return row * W + ((chunk ^ (row & 7)) << 2);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    return a;
}

// max / sum over the eight threads that share rows (lane bits 0..2)
__device__ __forceinline__ float row_max8(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// This thread's share of the 16-byte copies of a ROWS-row chunk of D floats
// a row into a row-major tile: chunk `chunk` of rows row0, row0 + STEP, ...
// (the same chunk in every row, so the swizzle's phase is fixed).
template <int D, int ROWS = F32_TILE>
struct ChunkCopy {
    static constexpr int PER_ROW = D / 4;                  // 16-byte chunks a row
    static constexpr int STEP = F32_THREADS / PER_ROW;     // 8 (D = 64) or 16 rows
    int chunk, row0;

    __device__ __forceinline__ ChunkCopy()
        : chunk(threadIdx.x % PER_ROW), row0(threadIdx.x / PER_ROW) {}

    __device__ __forceinline__ void issue(float* tile, const float* src, size_t stride) const {
        const uint32_t dst = smem_u32(tile + swz<D>(row0, chunk));
        const float* s = src + (size_t)row0 * stride + chunk * 4;
#pragma unroll
        for (int i = 0; i < ROWS / STEP; ++i) {
            cp_async16(dst + i * STEP * D * 4, s + (size_t)i * STEP * stride);
        }
    }

    // bias[D] added to this thread's own copies, once they have landed:
    // one fp32 add, as the plain version adds it
    __device__ __forceinline__ void add_bias(float* tile, const float* bias) const {
        const float4 b = ldg4(bias + chunk * 4);
        float* t = tile + swz<D>(row0, chunk);
#pragma unroll
        for (int i = 0; i < ROWS / STEP; ++i) {
            float4* x = reinterpret_cast<float4*>(t + i * STEP * D);
            *x = add4(*x, b);
        }
    }
};

// 64 rows of D floats (plus bias[D] where given) from device memory into a
// d-major tile: element (row, d) at d * 64 + row. All threads together.
template <int D>
__device__ __forceinline__ void stage_dmajor(float* tile, const float* src, size_t stride,
                                             const float* bias) {
#pragma unroll 4
    for (int i = threadIdx.x; i < F32_TILE * (D / 4); i += F32_THREADS) {
        const int r = i & (F32_TILE - 1), c = i / F32_TILE;
        float4 v = ldg4(src + (size_t)r * stride + c * 4);
        if (bias != nullptr) v = add4(v, ldg4(bias + c * 4));
        float* t = tile + 4 * c * F32_TILE + r;
        t[0] = v.x;
        t[F32_TILE] = v.y;
        t[2 * F32_TILE] = v.z;
        t[3 * F32_TILE] = v.w;
    }
}

// acc[i][j] += sum_d A(4ty + i, d) * B(tx + 8j, d), j < NJ: A a d-major
// tile of the block's rows, B a row-major chunk of 8 NJ rows D wide (whose
// rows tx + 8j have swizzle phase tx).
template <int D, int NJ>
__device__ __forceinline__ void mm_nt(float (&acc)[4][NJ], const float* A, const float* B,
                                      int ty, int tx) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
        float4 b[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = lds4(B + (tx + 8 * j) * D + ((c ^ tx) << 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float4 a = lds4(A + (4 * c + e) * F32_TILE + 4 * ty);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float bj = lane_of(b[j], e);
                acc[0][j] = fmaf(a.x, bj, acc[0][j]);
                acc[1][j] = fmaf(a.y, bj, acc[1][j]);
                acc[2][j] = fmaf(a.z, bj, acc[2][j]);
                acc[3][j] = fmaf(a.w, bj, acc[3][j]);
            }
        }
    }
}

// acc[i][4h + e] += sum_k P(k, 4ty + i) * V(k, 4(tx + 8h) + e), k < ROWS:
// P a row-major ROWS x 64 tile indexed [k][own row], V a row-major chunk
// of ROWS rows D wide.
template <int D, int ROWS>
__device__ __forceinline__ void mm_nn(float (&acc)[4][D / 8], const float* P, const float* V,
                                      int ty, int tx) {
#pragma unroll 2
    for (int k0 = 0; k0 < ROWS; k0 += 8) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {  // s = k % 8, the rows' swizzle phase
            const int k = k0 + s;
            const float4 p = lds4(P + k * F32_TILE + ((ty ^ s) << 2));
#pragma unroll
            for (int h = 0; h < D / 32; ++h) {
                const float4 v = lds4(V + k * D + (((tx + 8 * h) ^ s) << 2));
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float ve = lane_of(v, e);
                    acc[0][4 * h + e] = fmaf(p.x, ve, acc[0][4 * h + e]);
                    acc[1][4 * h + e] = fmaf(p.y, ve, acc[1][4 * h + e]);
                    acc[2][4 * h + e] = fmaf(p.z, ve, acc[2][4 * h + e]);
                    acc[3][4 * h + e] = fmaf(p.w, ve, acc[3][4 * h + e]);
                }
            }
        }
    }
}

// This thread's 4 x NJ micro-tile x[i][j] (own row 4ty + i, other row
// tx + 8j) into an 8 NJ x 64 row-major tile indexed [other row][own row],
// as mm_nn reads it.
template <int NJ>
__device__ __forceinline__ void store_transposed(float* tile, const float (&x)[4][NJ], int ty,
                                                 int tx) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<float4*>(tile + (tx + 8 * j) * F32_TILE + ((ty ^ tx) << 2)) =
            make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    }
}

// Rows 4ty..4ty+3 of a 64 x D product (this thread's columns), times
// scale[i], to the operand's rows row0 + 4ty + i.
template <int D>
__device__ __forceinline__ void store_tile_rows(const Operand<float>& dst, int b, int h,
                                                size_t row0, const float (&x)[4][D / 8],
                                                const float (&scale)[4], int ty, int tx) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float* row = dst.at(b, h, row0 + 4 * ty + i);
#pragma unroll
        for (int hh = 0; hh < D / 32; ++hh) {
            *reinterpret_cast<float4*>(row + 4 * (tx + 8 * hh)) =
                make_float4(x[i][4 * hh] * scale[i], x[i][4 * hh + 1] * scale[i],
                            x[i][4 * hh + 2] * scale[i], x[i][4 * hh + 3] * scale[i]);
        }
    }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&x)[R][C]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < C; ++j) x[i][j] = 0.f;
    }
}

// Allows `kernel` `bytes` of dynamic shared memory, once per device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&ready)[MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < MAX_DEVICES && ready[dev])) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
    return err;
}

// out[0..4] of `kernel`: registers per thread, local (spill) bytes per
// thread, shared memory per block (static + dynamic), resident blocks per
// SM, threads per block.
template <typename K>
int launch_attributes(K kernel, int threads, size_t dynamic_smem, int* out) {
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

}  // namespace

// Blocked Cholesky factorization and solve of one SPD f32 matrix, shared by
// cholesky.cu, schur_solve.cu and gn_step.cu.
//
// Replaces the factorization core of boslam/ops/pallas_cholesky.py
// (_make_kernel, _chol_tile, _tri_inv) and the tile routines of
// boslam/ops/pallas_gn_step.py (_chol_rec, _chol8, _tri_inv), which keep the
// whole matrix in TPU VMEM inside one program.  On the H100 a 1024^2..1664^2
// f32 matrix is 4..11 MB, far above the 227 KB of shared memory one block
// holds, so its T x T tiles (T = TILE = 32) are spread over a persistent
// grid: ONE cooperative launch per solve, whose phases are separated by
// grid-wide barriers (cooperative_groups::this_grid().sync()):
//
//   factor phase c = 0 .. nb-1 (nb = n / T), right-looking with look-ahead:
//     column units, one per tile row i >= c: apply update c-1 to the
//         diagonal tile (in shared memory, redundantly in every unit), factor
//         it and invert it; the unit of row c stores L_cc^-1 and solves
//         y_c = L_cc^-1 (b_c - sum_k<c L_ck y_k), the unit of row i > c
//         applies update c-1 to its tile and its rhs and stores the panel
//         tile L_ic = A_ic L_cc^-T (a product with the inverse);
//     trailing units, one per lower tile (i, j) with j > c: A_ij -= L_i,c-1
//         L_j,c-1^T.
//   So b rides along as an extra column and y comes out of the sweep.
//   backward phase i = nb-1 .. 0: every block with work computes x_i =
//     m_i o (L_ii^-T y_i) from the stored inverse; unit k < i then updates
//     y_k -= L_ik^T x_i, one block per tile of the row.
// Per-tile ready counters with look-ahead in place of the barriers (a unit
// waiting only on the tiles it reads) were not measured: no timing of them
// was kept.  The chain of column units is what a barrier waits on.
//
// Inside a unit the diagonal tile is factored and inverted by one warp in
// registers, without a block barrier: lane r holds row r, each of the 32
// column steps is a pivot shuffle, an rsqrt and one shuffle per row below;
// then lane c solves column c of the inverse, right-looking.  The other
// seven warps meanwhile apply the update to the panel tile, which does not
// need the factor.  At T = 32 one warp holds the whole tile, so the
// recursion of _chol_rec and _tri_inv has no level left to run; T = 64
// (32-wide blocked steps, then one level of recursive block inversion)
// measured 1.6-1.9x slower on the H100 at n = 1024-2048 (PERF.md).
//
// What bounds it on the H100: neither arithmetic (n = 1280: n^3/6 = 3.5e8
// FMA, ~10 us at the 67 TFLOP/s f32 CUDA-core peak) nor bytes (the 6.5 MB
// matrix lives in the 50 MB L2), but the dependent chain of 2 nb - 1 phases
// (79 at n = 1280), each a few microseconds: a round of tile loads from L2,
// the one-warp factor, two small tile products, and a grid barrier.  The
// grid holds as many blocks as are resident at once (occupancy x SMs),
// capped by the largest phase's unit count.  Tensor cores
// are not used: TF32 turns the Cholesky of the ~1e7-conditioned normal
// matrix into NaN, and the chain, not the FMA rate, sets the time; all
// arithmetic is f32 FMA on the CUDA cores.
//
// Semantics kept from the TPU kernel: only the lower triangle is read or
// written; a non-positive pivot yields NaN or inf (rsqrt of a negative
// number or of 0), which then propagates to the solution: callers read a
// non-finite x as "not SPD".  Nothing is clamped, and no barrier or loop
// depends on a value of the data.  No atomics in any sum: every tile and
// every rhs entry receives its updates in the same order on every run.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace boslam {

// Lower-triangular tile index t -> (i', j') with j' <= i'.
__device__ __forceinline__ void tri_decode(int t, int &ip, int &jp) {
  ip = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((ip + 1) * (ip + 2) / 2 <= t) ++ip;
  while (ip * (ip + 1) / 2 > t) --ip;
  jp = t - ip * (ip + 1) / 2;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

namespace chol {

constexpr int TILE = 32;      // tile edge, one warp wide (ops/cholesky.py TILE)
constexpr int THREADS = 256;  // threads per block
constexpr unsigned FULL = 0xffffffffu;

constexpr size_t SMEM_BYTES = 5 * (size_t)TILE * (TILE + 1) * sizeof(float);  // D, X, Q, P, A

using Tile = float (*)[TILE + 1];

// S = the T x T tile of L at (i0, j0), by 16-byte loads through L2 (other
// blocks of the launch write L, so nothing is read through L1).
__device__ __forceinline__ void load_tile(Tile S, const float *L, int n, int i0, int j0,
                                          bool lower_only) {
  for (int e = threadIdx.x; e < TILE * TILE / 4; e += THREADS) {
    const int r = e / (TILE / 4), c = 4 * (e % (TILE / 4));
    const float4 q = __ldcg(reinterpret_cast<const float4 *>(L + (size_t)(i0 + r) * n + j0 + c));
    const float w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) S[r][c + k] = (!lower_only || c + k <= r) ? w[k] : 0.0f;
  }
}

// acc[u][v] = sum_m A[tr + 16 u][m] B[tc + 16 v][m]: the tile product A B^T.
__device__ __forceinline__ void mm_nt(const Tile A, const Tile B,
                                      float (&acc)[TILE / 16][TILE / 16]) {
  constexpr int R = TILE / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int v = 0; v < R; ++v) acc[u][v] = 0.0f;
#pragma unroll 8
  for (int m = 0; m < TILE; ++m) {
    float a[R], b[R];
#pragma unroll
    for (int u = 0; u < R; ++u) a[u] = A[tr + 16 * u][m];
#pragma unroll
    for (int v = 0; v < R; ++v) b[v] = B[tc + 16 * v][m];
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int v = 0; v < R; ++v) acc[u][v] += a[u] * b[v];
  }
}

// One warp, no block barrier: factor the tile D in registers (lane r holds
// row r; each column step is a pivot shuffle, an rsqrt and one shuffle per
// row below), store L in D, then invert it into X (lane c solves column c
// right-looking, its running column in registers, L broadcast from shared
// memory).
__device__ __forceinline__ void tile_factor_invert(Tile D, Tile X, int lane) {
  float a[TILE];
#pragma unroll
  for (int k = 0; k < TILE; ++k) a[k] = (k <= lane) ? D[lane][k] : 0.0f;
  float rinv = 0.0f;  // 1 / L_rr of this lane's row
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    const float dinv = rsqrtf(__shfl_sync(FULL, a[j], j));
    if (lane == j) rinv = dinv;
    a[j] = (lane >= j) ? a[j] * dinv : 0.0f;  // L_jj = p rsqrt(p), L_rj = a_rj rsqrt(p)
#pragma unroll
    for (int k = j + 1; k < TILE; ++k) {
      const float lkj = __shfl_sync(FULL, a[j], k);
      if (lane >= k) a[k] -= a[j] * lkj;
    }
  }
#pragma unroll
  for (int k = 0; k < TILE; ++k)
    if (k <= lane) D[lane][k] = a[k];
  __syncwarp();
  float v[TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i) v[i] = (i == lane) ? 1.0f : 0.0f;
#pragma unroll
  for (int m = 0; m < TILE; ++m) {
    v[m] *= __shfl_sync(FULL, rinv, m);
#pragma unroll
    for (int i = m + 1; i < TILE; ++i) v[i] -= D[i][m] * v[m];
  }
#pragma unroll
  for (int i = 0; i < TILE; ++i) X[i][lane] = (i >= lane) ? v[i] : 0.0f;
}

// The panel-row work of a column unit that needs no factor: A -= P Q^T
// (update c-1 of tile (i, c)) and the rhs y_i -= L_i,c-1 y_c-1 (y_i = b_i in
// phase 0), by warps 1-7 while warp 0 factors the diagonal tile.
__device__ __forceinline__ void panel_update(Tile A, const Tile P, const Tile Q,
                                             const float *b, float *y, int c, int i0, int p0) {
  const int t = threadIdx.x - 32, nt = THREADS - 32;
  if (c > 0) {
    for (int e = t; e < TILE * TILE; e += nt) {
      const int r = e / TILE, s = e % TILE;
      float acc = 0.0f;
#pragma unroll 8
      for (int m = 0; m < TILE; ++m) acc += P[r][m] * Q[s][m];
      A[r][s] -= acc;
    }
  }
  for (int r = t; r < TILE; r += nt) {
    if (c == 0) {
      y[i0 + r] = b[i0 + r];
    } else {
      float s = 0.0f;
      for (int m = 0; m < TILE; ++m) s += P[r][m] * __ldcg(y + p0 + m);
      y[i0 + r] = __ldcg(y + i0 + r) - s;
    }
  }
}

// Column unit of factor phase c, tile row i >= c.
__device__ void column_unit(float *L, float *Linv, const float *b, float *y, int n, int c,
                            int i, Tile D, Tile X, Tile Q, Tile P, Tile A,
                            float *vec) {
  constexpr int R = TILE / 16;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16, warp = tid >> 5;
  const int c0 = c * TILE, i0 = i * TILE, p0 = (c - 1) * TILE;
  const bool diag = i == c;
  float acc[R][R];
  // every tile this unit reads, in one round of loads
  load_tile(D, L, n, c0, c0, true);
  if (c > 0) load_tile(Q, L, n, c0, p0, false);  // L_c,c-1
  if (!diag) {
    load_tile(A, L, n, i0, c0, false);            // A_ic
    if (c > 0) load_tile(P, L, n, i0, p0, false);  // L_i,c-1
  }
  __syncthreads();
  if (c > 0) {
    mm_nt(Q, Q, acc);
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int v = 0; v < R; ++v)
        if (tc + 16 * v <= tr + 16 * u) D[tr + 16 * u][tc + 16 * v] -= acc[u][v];
    __syncthreads();
  }
  // warp 0 factors and inverts the diagonal tile while the others update
  // the panel tile, which does not need the factor
  if (warp == 0)
    tile_factor_invert(D, X, tid);
  else if (!diag)
    panel_update(A, P, Q, b, y, c, i0, p0);
  __syncthreads();
  if (diag) {
    if (tid < TILE) {
      float t = (c == 0) ? b[c0 + tid] : __ldcg(y + c0 + tid);
      if (c > 0) {
        float s = 0.0f;
        for (int m = 0; m < TILE; ++m) s += Q[tid][m] * __ldcg(y + p0 + m);
        t -= s;
      }
      vec[tid] = t;
    }
    __syncthreads();
    if (tid < TILE) {
      float s = 0.0f;
      for (int m = 0; m <= tid; ++m) s += X[tid][m] * vec[m];
      y[c0 + tid] = s;
    }
    float *Lc = Linv + (size_t)c * TILE * TILE;
    for (int e = tid; e < TILE * TILE; e += THREADS) Lc[e] = X[e / TILE][e % TILE];
    return;
  }
  mm_nt(A, X, acc);  // L_ic = A_ic L_cc^-T
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int v = 0; v < R; ++v) L[(size_t)(i0 + tr + 16 * u) * n + c0 + tc + 16 * v] = acc[u][v];
}

// Trailing unit t of factor phase c >= 1: A_ij -= L_i,c-1 L_j,c-1^T.
__device__ void trailing_unit(float *L, int n, int c, int t, Tile P, Tile Q) {
  constexpr int R = TILE / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  int ip, jp;
  tri_decode(t, ip, jp);
  const int i = c + 1 + ip, j = c + 1 + jp, p0 = (c - 1) * TILE;
  load_tile(P, L, n, i * TILE, p0, false);
  load_tile(Q, L, n, j * TILE, p0, false);
  __syncthreads();
  float acc[R][R];
  mm_nt(P, Q, acc);
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int v = 0; v < R; ++v) {
      const int r = tr + 16 * u, s = tc + 16 * v;
      float *Lrs = L + (size_t)(i * TILE + r) * n + j * TILE + s;
      if (i != j || s <= r) *Lrs = __ldcg(Lrs) - acc[u][v];
    }
}

// x_i = m_i o (L_ii^-T y_i) into xs (and x, by block 0), then y_k -= L_ik^T
// x_i for the units k < i this block owns.
__device__ void backward_phase(const float *L, const float *Linv, float *y, float *x,
                               const float *mask, int n, int i, float (*red)[TILE], float *xs) {
  constexpr int G = THREADS / TILE;
  const int tid = threadIdx.x, g = tid / TILE, r = tid % TILE, i0 = i * TILE;
  const float *Li = Linv + (size_t)i * TILE * TILE;
  float s = 0.0f;
  for (int m = g; m < TILE; m += G) s += __ldcg(Li + (size_t)m * TILE + r) * __ldcg(y + i0 + m);
  red[g][r] = s;
  __syncthreads();
  if (tid < TILE) {
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < G; ++q) v += red[q][tid];
    if (mask) v *= mask[i0 + tid];
    xs[tid] = v;
    if (blockIdx.x == 0) x[i0 + tid] = v;
  }
  __syncthreads();
  for (int k = blockIdx.x; k < i; k += gridDim.x) {
    const int k0 = k * TILE;
    float t = 0.0f;
    for (int m = g; m < TILE; m += G) t += __ldcg(L + (size_t)(i0 + m) * n + k0 + r) * xs[m];
    red[g][r] = t;
    __syncthreads();
    if (tid < TILE) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < G; ++q) v += red[q][tid];
      y[k0 + tid] = __ldcg(y + k0 + tid) - v;
    }
    __syncthreads();
  }
}

// L, y, x and Linv are written and read by other blocks of this launch, so
// they are read through L2 (__ldcg), never through L1 or __ldg.  Factor
// phase c: blocks 0 .. ncol-1 take the column units, the other blocks the
// trailing units round-robin (all blocks, if the column units take every
// block), so a column unit, the chain, never queues behind another unit.
// A grid-wide barrier closes every phase.
__global__ void __launch_bounds__(THREADS, 2)
chol_solve_kernel(float *L, float *Linv, const float *b, float *y, float *x, const float *mask,
                  int n) {
  extern __shared__ float smem[];
  __shared__ float red[THREADS / TILE][TILE];
  __shared__ float vec[TILE];
  Tile D = reinterpret_cast<Tile>(smem);
  Tile X = D + TILE, Q = X + TILE, P = Q + TILE, A = P + TILE;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int nb = n / TILE, G = gridDim.x, blk = blockIdx.x;
  for (int c = 0; c < nb; ++c) {
    const int ncol = nb - c, m = nb - c - 1;
    const int ntr = c > 0 ? m * (m + 1) / 2 : 0;
    if (blk < ncol) {
      column_unit(L, Linv, b, y, n, c, c + blk, D, X, Q, P, A, vec);
      __syncthreads();
    }
    const int first = ncol < G ? ncol : 0, span = G - first;
    if (blk >= first) {
      for (int t = blk - first; t < ntr; t += span) {
        trailing_unit(L, n, c, t, P, Q);
        __syncthreads();
      }
    }
    for (int u = blk + G; u < ncol; u += G) {  // only when ncol > G
      column_unit(L, Linv, b, y, n, c, c + u, D, X, Q, P, A, vec);
      __syncthreads();
    }
    grid.sync();
  }
  for (int i = nb - 1; i >= 0; --i) {
    if (blk < (i > 0 ? i : 1)) backward_phase(L, Linv, y, x, mask, n, i, red, vec);
    if (i > 0) grid.sync();
  }
}

// Work units of the largest phase: the grid never needs more blocks.
inline int max_units(int nb) {
  const int phase1 = (nb - 1) + (nb - 2) * (nb - 1) / 2;
  return nb > phase1 ? nb : phase1;
}

// Blocks of chol_solve_kernel resident at once on the current device
// (occupancy x SMs), queried once per device; 0 means it cannot launch.
// static: every library that includes this header sets the attribute of
// its own copy of the kernel and keeps its own cache (an inline function's
// local static would be one object across all loaded libraries).
static cudaError_t resident_blocks(int &blocks) {
  static int cached[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    blocks = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_solve_kernel, THREADS,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  blocks = per_sm * sms;
  if (blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < 64) cached[dev] = blocks;
  return cudaSuccess;
}

// Factor the lower triangle of L (n x n, n % TILE == 0) in place and solve
// L L^T x = b in one cooperative launch on `stream`.  On return the
// off-diagonal tiles of L hold the factor; the diagonal factor tiles are
// represented only by their inverses in Linv (n * TILE floats of scratch).
// y: n floats of scratch.  mask (nullable) multiplies each solved tile of x
// before later tiles read it, as the TPU Schur kernel does.
inline cudaError_t factor_solve(float *L, float *Linv, const float *b, float *y, float *x,
                                const float *mask, int n, cudaStream_t stream) {
  if (n <= 0 || n % TILE) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = resident_blocks(blocks);
  if (err != cudaSuccess) return err;
  const int grid = blocks < max_units(n / TILE) ? blocks : max_units(n / TILE);
  void *args[] = {&L, &Linv, &b, &y, &x, &mask, &n};
  err = cudaLaunchCooperativeKernel((const void *)chol_solve_kernel, dim3(grid), dim3(THREADS),
                                    args, SMEM_BYTES, stream);
  if (err != cudaSuccess) cudaGetLastError();  // clear it for later launches' checks
  return err;
}

}  // namespace chol

// The solve every caller takes.
inline cudaError_t cholesky_factor_solve(float *L, float *Linv, const float *b, float *y,
                                         float *x, const float *mask, int n,
                                         cudaStream_t stream) {
  return chol::factor_solve(L, Linv, b, y, x, mask, n, stream);
}

}  // namespace boslam

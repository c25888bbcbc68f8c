// Blocked Cholesky factorization and triangular solves for one SPD f32
// matrix, shared by cholesky.cu and schur_solve.cu.
//
// Replaces the factorization core of boslam/ops/pallas_cholesky.py
// (_make_kernel, _chol_tile, _tri_inv), which keeps the whole matrix in
// TPU VMEM inside one program.  On the H100 a 1024^2..1664^2 f32 matrix is
// 4..11 MB, far above the 227 KB of shared memory one block can hold, so
// the work is tiled across blocks, one launch per phase:
//
//   for each 64-wide panel k:
//     chol_panel_kernel  (nb-k blocks)  every block factors the diagonal
//         tile in shared memory and inverts it; block 0 stores L_kk^-1,
//         block b >= 1 solves tile row k+b of the panel as A_ik L_kk^-T
//         (a product with the inverse, as the TPU kernel does);
//     chol_update_kernel (one block per lower trailing tile)
//         A_ij -= L_ik L_jk^T.
//   chol_solve_kernel (one block): forward L y = b and backward
//         L^T x = y by 64-row tiles, through the stored tile inverses.
//
// What bounds it on the H100: an N^3/6 FMA factorization (N = 1024: 0.18
// GFMA, ~5 us at the 67 TFLOP/s f32 CUDA-core peak) whose 3 N/64 launches
// run one after another, and a diagonal-tile factorization that is a
// 64-step chain of block barriers.  The design is latency-bound, not
// FLOP-bound, at these sizes: it keeps every launch simple and all f32 FMA
// on the CUDA cores (no tensor cores: TF32 turns the Cholesky of the
// ~1e7-conditioned normal matrix into NaN), and the redundant per-block
// factorization of the diagonal tile removes one launch per panel.
//
// Semantics kept from the TPU kernel: only the lower triangle is read or
// written; a non-positive pivot yields NaN (sqrtf of a negative number, or
// 1/0), which then propagates to the solution: callers read NaN as "not
// SPD".  Nothing is clamped.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace boslam {

constexpr int T = 64;     // tile edge
constexpr int NT = 256;   // threads per block for tile kernels
constexpr int SOLVE_THREADS = 1024;

// Lower-triangular tile index t -> (i', j') with j' <= i'.
__device__ __forceinline__ void tri_decode(int t, int &ip, int &jp) {
  ip = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((ip + 1) * (ip + 2) / 2 <= t) ++ip;
  while (ip * (ip + 1) / 2 > t) --ip;
  jp = t - ip * (ip + 1) / 2;
}

__global__ void __launch_bounds__(NT)
chol_panel_kernel(float *__restrict__ L, float *__restrict__ Linv, int n, int k) {
  __shared__ float D[T][T + 1];
  __shared__ float X[T][T + 1];
  const int tid = threadIdx.x;
  const int k0 = k * T;

  for (int e = tid; e < T * T; e += NT) {
    const int r = e / T, c = e % T;
    D[r][c] = (c <= r) ? L[(size_t)(k0 + r) * n + k0 + c] : 0.0f;
  }
  __syncthreads();

  // Unblocked right-looking Cholesky of the diagonal tile.  Thread c < T
  // keeps column c in registers (the loops are unrolled so that the
  // array stays in registers); step j's owner scales its column and
  // publishes it in X[j & 1], and the columns right of it take the
  // rank-1 update.  Two pivot buffers: one barrier per step.
  const int c = tid;
  float v[T];
#pragma unroll
  for (int r = 0; r < T; ++r) v[r] = (c < T) ? D[r][c < T ? c : 0] : 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float *P = X[j & 1];
    if (c == j) {
      const float s = sqrtf(v[j]);
      const float inv = 1.0f / s;
      v[j] = s;
      P[j] = s;
#pragma unroll
      for (int r = j + 1; r < T; ++r) {
        v[r] *= inv;
        P[r] = v[r];
      }
    }
    __syncthreads();
    if (c > j && c < T) {
      const float ljc = P[c];
#pragma unroll
      for (int r = j + 1; r < T; ++r) v[r] -= P[r] * ljc;
    }
  }
  __syncthreads();
  if (c < T) {
#pragma unroll
    for (int r = 0; r < T; ++r) D[r][c] = (r >= c) ? v[r] : 0.0f;
  }
  __syncthreads();

  // X = D^-1 by forward substitution, one column per thread, the column
  // in registers; every thread reads the same row of D (a broadcast).
  if (c < T) {
#pragma unroll
    for (int r = 0; r < T; ++r) {
      float s = (r == c) ? 1.0f : 0.0f;
#pragma unroll
      for (int m = 0; m < r; ++m) s -= D[r][m] * v[m];
      v[r] = s / D[r][r];
    }
#pragma unroll
    for (int r = 0; r < T; ++r) X[r][c] = v[r];
  }
  __syncthreads();

  // Block 0 stores only the inverse: the substitutions read diagonal tiles
  // through it, and leaving the diagonal tile of L untouched keeps it
  // intact for the other blocks of this launch, which load it.
  if (blockIdx.x == 0) {
    for (int e = tid; e < T * T; e += NT) Linv[(size_t)k * T * T + e] = X[e / T][e % T];
    return;
  }

  // panel tile i: P = A_ik X^T, reusing D for A_ik
  const int i0 = (k + blockIdx.x) * T;
  for (int e = tid; e < T * T; e += NT) {
    const int r = e / T, c = e % T;
    D[r][c] = L[(size_t)(i0 + r) * n + k0 + c];
  }
  __syncthreads();
  const int tr = tid / 16, tc = tid % 16;
  float acc[4][4] = {};
  for (int m = 0; m < T; ++m) {
    float a[4], x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = D[tr + 16 * u][m];
#pragma unroll
    for (int v = 0; v < 4; ++v) x[v] = X[tc + 16 * v][m];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * x[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      L[(size_t)(i0 + tr + 16 * u) * n + k0 + tc + 16 * v] = acc[u][v];
}

__global__ void __launch_bounds__(NT)
chol_update_kernel(float *__restrict__ L, int n, int k) {
  __shared__ float Pi[T][T + 1];
  __shared__ float Pj[T][T + 1];
  const int tid = threadIdx.x;
  int ip, jp;
  tri_decode(blockIdx.x, ip, jp);
  const int i0 = (k + 1 + ip) * T, j0 = (k + 1 + jp) * T, k0 = k * T;

  for (int e = tid; e < T * T; e += NT) {
    const int r = e / T, c = e % T;
    Pi[r][c] = L[(size_t)(i0 + r) * n + k0 + c];
    Pj[r][c] = L[(size_t)(j0 + r) * n + k0 + c];
  }
  __syncthreads();
  const int tr = tid / 16, tc = tid % 16;
  float acc[4][4] = {};
  for (int m = 0; m < T; ++m) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = Pi[tr + 16 * u][m];
#pragma unroll
    for (int v = 0; v < 4; ++v) b[v] = Pj[tc + 16 * v][m];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      L[(size_t)(i0 + tr + 16 * u) * n + j0 + tc + 16 * v] -= acc[u][v];
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One block.  y is an n-float scratch; mask (nullable) multiplies each
// solved tile of x before later tiles read it, as the TPU Schur kernel does.
__global__ void __launch_bounds__(SOLVE_THREADS)
chol_solve_kernel(const float *__restrict__ L, const float *__restrict__ Linv,
                  const float *__restrict__ b, float *y, float *x,
                  const float *__restrict__ mask, int n) {
  __shared__ float part[SOLVE_THREADS / T][T + 1];
  __shared__ float acc[T];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = n / T;
  constexpr int ROWS_PER_WARP = T / (SOLVE_THREADS / 32);  // 2

  // forward: L y = b
  for (int i = 0; i < nb; ++i) {
    const int i0 = i * T;
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int r = warp * ROWS_PER_WARP + q;
      const float *Lr = L + (size_t)(i0 + r) * n;
      float s = 0.0f;
      for (int m = lane; m < i0; m += 32) s += Lr[m] * y[m];
      s = warp_sum(s);
      if (lane == 0) acc[r] = b[i0 + r] - s;
    }
    __syncthreads();
    if (tid < T) {
      const float *Li = Linv + (size_t)i * T * T + (size_t)tid * T;
      float s = 0.0f;
      for (int m = 0; m <= tid; ++m) s += Li[m] * acc[m];
      y[i0 + tid] = s;
    }
    __syncthreads();
  }

  // backward: L^T x = y
  constexpr int G = SOLVE_THREADS / T;  // 16 row groups
  const int c = tid % T, g = tid / T;
  for (int i = nb - 1; i >= 0; --i) {
    const int i0 = i * T, i1 = i0 + T;
    float s = 0.0f;
    for (int m = i1 + g; m < n; m += G) s += L[(size_t)m * n + i0 + c] * x[m];
    part[g][c] = s;
    __syncthreads();
    if (tid < T) {
      float t = y[i0 + tid];
      for (int q = 0; q < G; ++q) t -= part[q][tid];
      acc[tid] = t;
    }
    __syncthreads();
    if (tid < T) {
      const float *Li = Linv + (size_t)i * T * T;
      float s2 = 0.0f;
      for (int r = tid; r < T; ++r) s2 += Li[(size_t)r * T + tid] * acc[r];
      x[i0 + tid] = mask ? mask[i0 + tid] * s2 : s2;
    }
    __syncthreads();
  }
}

// Factor the lower triangle of L (n x n) in place and solve L L^T x = b.
// On return the off-diagonal tiles of L hold the factor; the diagonal
// factor tiles are represented only by their inverses in Linv (nb*T*T
// floats of scratch).  y: n floats of scratch.
inline cudaError_t cholesky_factor_solve(float *L, float *Linv, const float *b,
                                         float *y, float *x, const float *mask,
                                         int n, cudaStream_t stream) {
  const int nb = n / T;
  for (int k = 0; k < nb; ++k) {
    chol_panel_kernel<<<nb - k, NT, 0, stream>>>(L, Linv, n, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int m = nb - k - 1;
    if (m > 0) {
      chol_update_kernel<<<m * (m + 1) / 2, NT, 0, stream>>>(L, n, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  chol_solve_kernel<<<1, SOLVE_THREADS, 0, stream>>>(L, Linv, b, y, x, mask, n);
  return cudaGetLastError();
}

}  // namespace boslam

// Stage kernels of the exact Schur solve of the reduced pose system,
// shared by schur_solve.cu (the solve alone) and gn_step.cu (the whole GN
// iteration).  Port of the Schur half of _make_fused_kernel in
// boslam/ops/pallas_schur.py:
//
//   W   = U Hll^-1                   schur_w_kernel: Hll^-1 is block-diagonal
//                                    2x2, so each column pair of U is scaled
//                                    by one 2x2 block (not a dense product)
//   S   = m m^T o (Hpp + lam I - W U^T) + diag(1 - m)
//                                    schur_s_kernel: tiled f32 GEMM over the
//                                    lower 64x64 tiles of S within `band`
//                                    tiles of the diagonal: all of them on
//                                    the dense route, the band's on the band
//                                    route (band_cholesky.cuh), which never
//                                    reads the others
//   rhs = m o (W bl - bp)            schur_rhs_kernel: one warp per row
//   dl  = Hll^-1 (-bl - U^T x)       schur_dl_kernel: column reduction of U
//                                    plus the 2x2 block apply
//
// Hll^-1 comes as its [Ml/2, 2, 2] diagonal blocks, Hb.  Np % 64 == 0 and
// Ml % 64 == 0; nothing else bounds the sizes.  factor_solve() picks the
// route: band::factor_solve (band_cholesky.cuh) for a band bt >= 0, the dense
// factor-solve of cholesky.cuh for bt < 0.
#pragma once

#include "band_cholesky.cuh"

namespace boslam {

// The stage kernels' own tiling, independent of the factorization's tile.
constexpr int T = 64;     // tile edge of the S GEMM and the dl reduction
constexpr int NT = 256;   // threads per block of the S GEMM
constexpr int SOLVE_THREADS = 1024;
constexpr int KC = 32;  // depth of one GEMM stage

// W[r, 2l + c] = U[r, 2l] Hb[l, 0, c] + U[r, 2l + 1] Hb[l, 1, c]
__global__ void schur_w_kernel(const float *__restrict__ U, const float *__restrict__ Hb,
                               float *__restrict__ W, int np, int ml) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)np * ml) return;
  const int r = (int)(idx / ml), col = (int)(idx % ml), l2 = col & ~1, c = col & 1;
  const float *Ur = U + (size_t)r * ml;
  const float *Hl = Hb + 2 * l2;
  W[idx] = Ur[l2] * Hl[c] + Ur[l2 + 1] * Hl[2 + c];
}

// Lower T-tile t of S within `band` tiles of the diagonal (band < nt): the
// first band + 1 rows are a triangle, every later row has band + 1 tiles.
__device__ __forceinline__ void band_decode(int t, int band, int &ip, int &jp) {
  const int tri = (band + 1) * (band + 2) / 2;
  if (t < tri) return tri_decode(t, ip, jp);
  t -= tri;
  ip = band + 1 + t / (band + 1);
  jp = ip - band + t % (band + 1);
}

// The T-tile band of S that covers a band of bt chol::TILE tiles (every
// T-tile when bt < 0): a 32-tile (i, j) with i - j <= bt lies in the 64-tile
// (i/2, j/2), at most (bt + 1) / 2 from the diagonal.  And its count of
// lower tiles.
static_assert(T == 2 * chol::TILE, "s_band assumes two factorization tiles per S tile");
inline int s_band(int bt, int nt) {
  const int b = bt < 0 ? nt - 1 : (bt + 1) / 2;
  return b < nt - 1 ? b : nt - 1;
}
inline int s_tiles(int band, int nt) {
  return (band + 1) * (band + 2) / 2 + (nt - band - 1) * (band + 1);
}

__global__ void __launch_bounds__(NT)
schur_s_kernel(const float *__restrict__ Hpp, const float *__restrict__ W,
               const float *__restrict__ U, const float *__restrict__ mask,
               const float *__restrict__ lam, float *__restrict__ S, int np, int ml, int band) {
  __shared__ float Wt[T][KC + 1];
  __shared__ float Ut[T][KC + 1];
  int ip, jp;
  band_decode(blockIdx.x, band, ip, jp);
  const int i0 = ip * T, j0 = jp * T;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float acc[4][4] = {};
  for (int kk = 0; kk < ml; kk += KC) {
    for (int e = tid; e < T * KC; e += NT) {
      const int r = e / KC, m = e % KC;
      Wt[r][m] = W[(size_t)(i0 + r) * ml + kk + m];
      Ut[r][m] = U[(size_t)(j0 + r) * ml + kk + m];
    }
    __syncthreads();
#pragma unroll 8
    for (int m = 0; m < KC; ++m) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = Wt[tr + 16 * u][m];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = Ut[tc + 16 * v][m];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
    __syncthreads();
  }
  const float l = *lam;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = i0 + tr + 16 * u;
    const float mr = mask[r];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = j0 + tc + 16 * v;
      float s = Hpp[(size_t)r * np + c] - acc[u][v];
      if (r == c) s += l;
      s = s * (mr * mask[c]);
      if (r == c) s += 1.0f - mr;
      S[(size_t)r * np + c] = s;
    }
  }
}

__global__ void schur_rhs_kernel(const float *__restrict__ W, const float *__restrict__ bl,
                                 const float *__restrict__ bp, const float *__restrict__ mask,
                                 float *__restrict__ rhs, int np, int ml) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt >> 5, lane = gt & 31;
  if (row >= np) return;
  const float *Wr = W + (size_t)row * ml;
  float s = 0.0f;
  for (int k = lane; k < ml; k += 32) s += Wr[k] * bl[k];
  s = warp_sum(s);
  if (lane == 0) rhs[row] = mask[row] * (s - bp[row]);
}

__global__ void __launch_bounds__(SOLVE_THREADS)
schur_dl_kernel(const float *__restrict__ U, const float *__restrict__ Hb,
                const float *__restrict__ bl, const float *__restrict__ x,
                float *__restrict__ dl, int np, int ml) {
  constexpr int G = SOLVE_THREADS / T;
  __shared__ float part[G][T + 1];
  __shared__ float t[T];
  const int tid = threadIdx.x, c = tid % T, g = tid / T, c0 = blockIdx.x * T;
  float s = 0.0f;
  for (int r = g; r < np; r += G) s += U[(size_t)r * ml + c0 + c] * x[r];
  part[g][c] = s;
  __syncthreads();
  if (tid < T) {
    float v = -bl[c0 + tid];
    for (int q = 0; q < G; ++q) v -= part[q][tid];
    t[tid] = v;
  }
  __syncthreads();
  if (tid < T) {
    // row (col & 1) of block col / 2: Hb[2 col], Hb[2 col + 1]
    const int col = c0 + tid, l2 = tid & ~1;
    dl[col] = Hb[2 * col] * t[l2] + Hb[2 * col + 1] * t[l2 + 1];
  }
}

// S (np x np, lower tiles of the route's band) factored in place and
// solved for x; y is the dense route's scratch.
inline cudaError_t factor_solve(float *S, float *Linv, const float *rhs, float *y, float *x,
                                const float *mask, int np, int bt, cudaStream_t stream) {
  if (bt >= 0) return band::factor_solve(S, Linv, rhs, x, mask, np, bt, stream);
  return cholesky_factor_solve(S, Linv, rhs, y, x, mask, np, stream);
}

// The S GEMM over the route's band, then the factor-solve.
inline cudaError_t s_factor_solve(const float *Hpp, const float *W, const float *U,
                                  const float *mask, const float *lam, float *S, float *Linv,
                                  const float *rhs, float *y, float *x, int np, int ml, int bt,
                                  cudaStream_t stream) {
  const int nt = np / T, band = s_band(bt, nt);
  schur_s_kernel<<<s_tiles(band, nt), NT, 0, stream>>>(Hpp, W, U, mask, lam, S, np, ml, band);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return factor_solve(S, Linv, rhs, y, x, mask, np, bt, stream);
}

}  // namespace boslam

// Exact Schur solve of the reduced pose system: the Hopper port of
// fused_schur_solve_padded / _make_fused_kernel in
// boslam/ops/pallas_schur.py.  Plain C interface, loaded with ctypes by
// boslam_torch/ops/schur_solve.py.
//
//   W   = U Hll^-1                   schur_w_kernel: Hll^-1 is block-diagonal
//                                    2x2, so each column pair of U is scaled
//                                    by one 2x2 block (not a dense product)
//   S   = m m^T o (Hpp + lam I - W U^T) + diag(1 - m)
//                                    schur_s_kernel: tiled f32 GEMM over the
//                                    lower 64x64 tiles of S only
//   rhs = m o (W bl - bp)            schur_rhs_kernel: one warp per row
//   x   = S^-1 rhs                   cholesky.cuh, masked tile by tile
//   dl  = Hll^-1 (-bl - U^T x)       schur_dl_kernel: column reduction of U
//                                    plus the 2x2 block apply
//
// What bounds it on the H100: the Np^3/6 FMA Cholesky and the Np^2 Ml / 2
// FMA product W U^T (Np = 1024, Ml = 384: 0.18 + 0.20 GFMA, ~11 us at the
// f32 CUDA-core peak), behind 2 Np/64 + 4 dependent launches.  As in
// cholesky.cuh the design is latency-bound at these sizes; the GEMM skips
// the upper tiles (the factorization reads only the lower triangle) and
// all arithmetic is f32 FMA on the CUDA cores, never TF32.
//
// The TPU kernel takes Hll^-1 as a dense [Ml, Ml] block-diagonal matrix;
// this one takes its [Ml/2, 2, 2] diagonal blocks, Hb.
#include "cholesky.cuh"

namespace boslam {

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

__global__ void __launch_bounds__(NT)
schur_s_kernel(const float *__restrict__ Hpp, const float *__restrict__ W,
               const float *__restrict__ U, const float *__restrict__ mask,
               const float *__restrict__ lam, float *__restrict__ S, int np, int ml) {
  __shared__ float Wt[T][KC + 1];
  __shared__ float Ut[T][KC + 1];
  int ip, jp;
  tri_decode(blockIdx.x, ip, jp);
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

}  // namespace boslam

extern "C" {

// Inputs: Hpp [np,np], U [np,ml], Hb [ml/2,2,2], bp [np], bl [ml], mask [np],
// lam [1] (device scalar).  Scratch: W [np,ml], S [np,np], Linv
// [(np/64)*64*64], rhs [np], y [np].  Outputs: x [np], dl [ml].
// np % 64 == 0, ml % 64 == 0.  Returns the first failed launch's error, else 0.
int boslam_schur_solve(const float *Hpp, const float *U, const float *Hb, const float *bp,
                       const float *bl, const float *mask, const float *lam, float *W,
                       float *S, float *Linv, float *rhs, float *y, float *x, float *dl,
                       int np, int ml, void *stream_ptr) {
  using namespace boslam;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t nw = (size_t)np * ml;
  schur_w_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, stream>>>(U, Hb, W, np, ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = np / T;
  schur_s_kernel<<<nt * (nt + 1) / 2, NT, 0, stream>>>(Hpp, W, U, mask, lam, S, np, ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  schur_rhs_kernel<<<(np * 32 + 255) / 256, 256, 0, stream>>>(W, bl, bp, mask, rhs, np, ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cholesky_factor_solve(S, Linv, rhs, y, x, mask, np, stream)) != cudaSuccess)
    return (int)err;
  schur_dl_kernel<<<ml / T, SOLVE_THREADS, 0, stream>>>(U, Hb, bl, x, dl, np, ml);
  return (int)cudaGetLastError();
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// f32 CUDA-core peak), behind 5 dependent launches, the Cholesky one
// cooperative launch of 2 Np/32 - 1 grid-barrier phases.  As in
// cholesky.cuh the design is latency-bound at these sizes; the GEMM skips
// the upper tiles (the factorization reads only the lower triangle) and
// all arithmetic is f32 FMA on the CUDA cores, never TF32.
//
// The TPU kernel takes Hll^-1 as a dense [Ml, Ml] block-diagonal matrix;
// this one takes its [Ml/2, 2, 2] diagonal blocks, Hb.  The stage kernels
// live in schur.cuh, which gn_step.cu shares.
#include "schur.cuh"

extern "C" {

// Inputs: Hpp [np,np], U [np,ml], Hb [ml/2,2,2], bp [np], bl [ml], mask [np],
// lam [1] (device scalar).  Scratch: W [np,ml], S [np,np], Linv
// [np * chol::TILE], rhs [np], y [np].  Outputs: x [np], dl [ml].
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

// Exact Schur solve of the reduced pose system: the Hopper port of
// fused_schur_solve_padded / _make_fused_kernel in
// boslam/ops/pallas_schur.py.  Plain C interface, loaded with ctypes by
// boslam_torch/ops/schur_solve.py.
//
//   W   = U Hll^-1                   schur_w_kernel: Hll^-1 is block-diagonal
//                                    2x2, so each column pair of U is scaled
//                                    by one 2x2 block (not a dense product)
//   rhs = m o (W bl - bp)            schur_rhs_kernel: one warp per row
//   S   = m m^T o (Hpp + lam I - W U^T) + diag(1 - m)
//                                    schur_s_kernel: tiled f32 GEMM over the
//                                    lower 64x64 tiles of S in the route's band
//   x   = S^-1 rhs                   masked tile by tile: band_cholesky.cuh
//                                    (one block) or cholesky.cuh (dense)
//   dl  = Hll^-1 (-bl - U^T x)       schur_dl_kernel: column reduction of U
//                                    plus the 2x2 block apply
//
// Two routes, the caller's choice (ops/schur_solve.py): for a band bt >= 0
// (S zero more than bt 32-wide tiles below the diagonal, as a graph's
// reduced system in pose order is, and a window that fits one block's
// shared memory) S is built on the band's tiles only and factored and
// solved in one launch of one block; for bt < 0, on every lower tile and
// by the cooperative dense factor-solve.  Both give the same bits where x
// is finite.  What bounds the band route on the H100: the factor-solve's
// chain of 2 Np/32 dependent one-warp tile factors and substitution rows
// (band_cholesky.cuh); its arithmetic (Np = 1024, Ml = 384, bt = 3: the
// band of W U^T ~0.06 GFMA, the band factor ~0.01) is ~2 us at the f32
// CUDA-core peak.  The dense route is bound by its 2 Np/32 - 1 grid
// barriers (cholesky.cuh).  All arithmetic is f32 FMA on the CUDA cores,
// never TF32.
//
// The TPU kernel takes Hll^-1 as a dense [Ml, Ml] block-diagonal matrix;
// this one takes its [Ml/2, 2, 2] diagonal blocks, Hb.  The stage kernels
// live in schur.cuh, which gn_step.cu shares.
#include "schur.cuh"

extern "C" {

// Inputs: Hpp [np,np], U [np,ml], Hb [ml/2,2,2], bp [np], bl [ml], mask [np],
// lam [1] (device scalar).  Scratch: W [np,ml], S [np,np], Linv
// [np * chol::TILE], rhs [np], y [np].  Outputs: x [np], dl [ml].
// np % 64 == 0, ml % 64 == 0.  band: S's band in 32-wide tiles for the band
// route, -1 for the dense route.  Returns the first failed launch's error
// (a band whose window does not fit: cudaErrorInvalidValue), else 0.
int boslam_schur_solve(const float *Hpp, const float *U, const float *Hb, const float *bp,
                       const float *bl, const float *mask, const float *lam, float *W,
                       float *S, float *Linv, float *rhs, float *y, float *x, float *dl,
                       int np, int ml, int band, void *stream_ptr) {
  using namespace boslam;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t nw = (size_t)np * ml;
  schur_w_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, stream>>>(U, Hb, W, np, ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  schur_rhs_kernel<<<(np * 32 + 255) / 256, 256, 0, stream>>>(W, bl, bp, mask, rhs, np, ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = s_factor_solve(Hpp, W, U, mask, lam, S, Linv, rhs, y, x, np, ml, band, stream)) !=
      cudaSuccess)
    return (int)err;
  schur_dl_kernel<<<ml / T, SOLVE_THREADS, 0, stream>>>(U, Hb, bl, x, dl, np, ml);
  return (int)cudaGetLastError();
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

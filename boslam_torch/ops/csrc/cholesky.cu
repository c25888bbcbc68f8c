// Dense SPD solve H x = b by blocked Cholesky: the Hopper port of
// cholesky_solve_padded in boslam/ops/pallas_cholesky.py.  The kernels and
// the note on what bounds them are in cholesky.cuh.  Plain C interface,
// loaded with ctypes by boslam_torch/ops/cholesky.py.
#include "cholesky.cuh"

extern "C" {

// L: n*n floats holding H on entry (a working copy; factored in place).
// Linv: n * chol::TILE floats, y: n floats of scratch.  n % chol::TILE == 0.
// One cooperative launch; returns its cudaError_t, else 0.
int boslam_cholesky_solve(float *L, float *Linv, const float *b, float *y, float *x, int n,
                          void *stream) {
  return (int)boslam::cholesky_factor_solve(L, Linv, b, y, x, nullptr, n, (cudaStream_t)stream);
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

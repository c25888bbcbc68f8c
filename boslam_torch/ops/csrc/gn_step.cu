// One whole Gauss-Newton iteration of the exact-Schur path: the Hopper port
// of _fused_gn_call / _make_kernel in boslam/ops/pallas_gn_step.py.  Plain C
// interface, loaded with ctypes by boslam_torch/ops/gn_step.py.  One C call
// runs the iteration as a short pipeline of launches on one stream:
//
//   gn_edge_kernel      one thread per bearing and per odometry edge: gather,
//                       error (atan2f), Jacobians, robust weights, and the
//                       edge's pieces of H and b ("planes"), its chi2,
//                       robust cost and clamp flag
//   gn_assemble_kernel  owner-computes sums, each in a fixed order and with
//                       no atomics, so every run gives the same bits:
//                       pose diagonal blocks and bp; landmark blocks, damped,
//                       to a closed-form 2x2 inverse, and bl; the U block of
//                       each (pose, landmark) pair; the odometry coupling of
//                       each unordered pose pair
//   schur.cuh           W = U Hll^-1, rhs, S = m m^T o (Hpp + lam I - W U^T)
//                       + diag(1 - m) on the route's band of tiles, the
//                       factor-solve (band_cholesky.cuh: one block; or the
//                       dense cholesky.cuh), dl
//   gn_finish_kernel    one block: boxplus, the non-finite guard (the old
//                       state is kept), and this step's stats row
//
// The ownership lists (edges sorted by pose, by landmark, by pair) are built
// once per solve on the device by the wrapper.  Hpp, U and bp are zeroed once
// per solve too: every step writes the same positions, so what stays zero
// stays zero.  The state is interleaved (3p + c, 2l + c), as the port keeps
// it; the TPU kernel's component-major layout is a symmetric permutation of
// the same system.  Padding landmark lanes get Hll^-1 = 0 and are never
// inverted, so a zero damping stays finite (the TPU kernel divides by their
// zero determinant).  The odometry b-side weight is the unfused path's,
// J^T Omega (w_b e); the TPU kernel also multiplies it by w_H.
//
// The route (GNStepArgs::band, decided on the host once per solve by
// ops/gn_step.py tile_band): S's band bt in 32-wide tiles when the band's
// window fits one block's shared memory (bt <= 5 at these sizes: graphs
// of up to ~300 poses in pose order, bt 3-4 at 301/141), else -1, the
// dense route (the 512-pose cap graph: bt 42).  Both routes give the same
// bits where the step is finite.
//
// What bounds it on the H100: neither arithmetic nor bytes.  At the
// reference size (301 poses, 141 landmarks; Np = 1024, Ml = 384) the step
// needs ~2e6 FMAs when the sparsity of U and the envelope of S are counted;
// the band route does ~8e7 (W U^T on the band's 64-wide tiles, 9e6 for
// the band factor), the dense route ~4e8: a few microseconds at the f32
// CUDA-core peak either way, and the inputs are ~60 KB.  The pipeline is
// latency-bound: 8 dependent launches, the longest the factor-solve, whose
// chain on the band route is 2 Np/32 dependent steps inside one block (the
// one-warp factor of each diagonal tile, then each backward row), on the
// dense route 2 Np/32 - 1 grid-barrier phases.  The design keeps the whole
// iteration in one host call, so the host never holds the card back, and
// every launch simple; all arithmetic is f32 FMA on the CUDA cores, never
// TF32.
#include <cfloat>

#include "schur.cuh"

namespace boslam {

constexpr int GN_MAX_POSES = 512;      // fused_gn_fits: pad128(poses) <= 512
constexpr int GN_MAX_LANDMARKS = 512;  // and pad128(landmarks) <= that
constexpr int EDGE_THREADS = 256;
constexpr int FIN_THREADS = 1024;
constexpr float PI_F = 3.141592653589793f;
constexpr float TWO_PI_F = 6.283185307179586f;

// Field order is mirrored by _Args in boslam_torch/ops/gn_step.py.
struct GNStepArgs {
  // edges, fixed for a solve
  const int *b_pose, *b_lm;
  const float *b_meas, *b_omega;
  const int *o_src, *o_dst;
  const float *o_meas;   // [no, 3]
  const float *o_omega;  // [no, 6]: 00 01 02 11 12 22
  // ownership lists, fixed for a solve
  const int *pose_order, *pose_off;  // contributions sorted by pose; [np_ + 1]
  const int *lm_order, *lm_off;      // bearing edges sorted by landmark; [nl + 1]
  const int *u_order, *u_key;        // bearing edges sorted by pose * nl + lm
  const int *c_order, *c_key;        // odometry edges sorted by lo * np_ + hi
  const float *mask;                 // [Np] gauge and padding mask
  const float *scal;                 // [2] damping, kernel threshold
  // state, updated in place
  float *poses, *lms;
  // workspace
  float *planes;  // 23 nb + 30 no floats, see the offsets below
  float *Hpp, *U, *Hb, *bp, *bl, *W, *S, *Linv, *rhs, *y, *x, *dl;
  float *stats;  // [8]: chi2_b, chi2_o, chi2_robust, clamped_b, clamped_o, |delta|^2, ok, 0
  int np_, nl, nb, no, Np, Ml, robust, quirk;  // robust: 0 none, 1 threshold, 2 huber
  int band;  // S's band in 32-wide tiles (the band route), -1: the dense route
};

// Plane sections.  A pose contribution id is e (bearing edge e), nb + e
// (odometry edge e at its source) or nb + no + e (at its destination).
__device__ __forceinline__ float *pose_planes(const GNStepArgs &a) { return a.planes; }
__device__ __forceinline__ float *lm_planes(const GNStepArgs &a) {
  return a.planes + (size_t)9 * (a.nb + 2 * a.no);
}
__device__ __forceinline__ float *u_planes(const GNStepArgs &a) {
  return lm_planes(a) + (size_t)5 * a.nb;
}
__device__ __forceinline__ float *c_planes(const GNStepArgs &a) {
  return u_planes(a) + (size_t)6 * a.nb;
}
__device__ __forceinline__ float *edge_stats(const GNStepArgs &a) {
  return c_planes(a) + (size_t)9 * a.no;
}

__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

__device__ __forceinline__ float wrap_angle(float v) {
  return v - TWO_PI_F * floorf((v + PI_F) / TWO_PI_F);
}

// Per-edge IRLS weights (w_H, w_b) from chi2 = e^T Omega e.
__device__ __forceinline__ void robust_weights(float chi2, float kt, int robust, int quirk,
                                               float &wH, float &wb) {
  wH = wb = 1.0f;
  if (robust == 0) return;
  const float w = chi2 > kt ? sqrtf(kt / fmaxf(chi2, FLT_MIN)) : 1.0f;
  wb = w;
  wH = (robust == 1 && quirk) ? 1.0f : w;
}

__device__ __forceinline__ float robust_cost(float chi2, float kt, int robust) {
  if (robust == 0) return chi2;
  if (robust == 1) return fminf(chi2, kt);
  return chi2 > kt ? 2.0f * sqrtf(kt * fmaxf(chi2, FLT_MIN)) - kt : chi2;
}

__device__ void bearing_edge(const GNStepArgs &a, int e) {
  const int p = a.b_pose[e], l = a.b_lm[e];
  const float px = a.poses[3 * p], py = a.poses[3 * p + 1], pth = a.poses[3 * p + 2];
  const float lx = a.lms[2 * l], ly = a.lms[2 * l + 1];
  float s, c;
  sincosf(pth, &s, &c);
  const float dx = lx - px, dy = ly - py;
  const float gx = c * dx + s * dy, gy = -s * dx + c * dy;
  const float err = wrap_angle(atan2f(gy, gx) - a.b_meas[e]);
  const float omega = a.b_omega[e];
  const float chi2 = omega * err * err;
  const float kt = a.scal[1];
  float wH, wb;
  robust_weights(chi2, kt, a.robust, a.quirk, wH, wb);

  // d atan2 / d g = [-gy, gx] / |g|^2, guarded at the pose == landmark point
  const float inv_n2 = 1.0f / fmaxf(gx * gx + gy * gy, FLT_MIN);
  const float ax = -gy * inv_n2, ay = gx * inv_n2;
  const float gRx = ax * c - ay * s, gRy = ax * s + ay * c;
  const float col_x = c * ly - s * lx, col_y = -s * ly - c * lx;
  const float jp[3] = {-gRx, -gRy, ax * col_x + ay * col_y};
  const float jl[2] = {gRx, gRy};
  const float om = omega * wH, coef = omega * wb * err;

  float *pp = pose_planes(a) + (size_t)9 * e;
  int q = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) pp[q++] = om * jp[i] * jp[j];
#pragma unroll
  for (int i = 0; i < 3; ++i) pp[6 + i] = coef * jp[i];
  float *lp = lm_planes(a) + (size_t)5 * e;
  lp[0] = om * jl[0] * jl[0];
  lp[1] = om * jl[0] * jl[1];
  lp[2] = om * jl[1] * jl[1];
  lp[3] = coef * jl[0];
  lp[4] = coef * jl[1];
  float *up = u_planes(a) + (size_t)6 * e;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    up[2 * i] = om * jp[i] * jl[0];
    up[2 * i + 1] = om * jp[i] * jl[1];
  }
  float *st = edge_stats(a) + (size_t)3 * e;
  st[0] = chi2;
  st[1] = robust_cost(chi2, kt, a.robust);
  st[2] = chi2 > kt ? 1.0f : 0.0f;
}

__device__ void odometry_edge(const GNStepArgs &a, int e) {
  const int si = a.o_src[e], di = a.o_dst[e];
  const float sx = a.poses[3 * si], sy = a.poses[3 * si + 1], sth = a.poses[3 * si + 2];
  const float tdx = a.poses[3 * di], tdy = a.poses[3 * di + 1], dth = a.poses[3 * di + 2];
  const float *m = a.o_meas + (size_t)3 * e;
  const float *w6 = a.o_omega + (size_t)6 * e;
  const float Om[3][3] = {{w6[0], w6[1], w6[2]}, {w6[1], w6[3], w6[4]}, {w6[2], w6[4], w6[5]}};
  float s, c;
  sincosf(sth, &s, &c);
  const float rx = tdx - sx, ry = tdy - sy;
  const float ev[3] = {(c * rx + s * ry) - m[0], (-s * rx + c * ry) - m[1],
                       wrap_angle(wrap_angle(dth - sth) - m[2])};
  float chi2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) t += Om[i][j] * ev[j];
    chi2 += ev[i] * t;
  }
  const float kt = a.scal[1];
  float wH, wb;
  robust_weights(chi2, kt, a.robust, a.quirk, wH, wb);

  const float thd_x = -c * tdy + s * tdx, thd_y = s * tdy + c * tdx;
  const float js[3][3] = {{-c, -s, -thd_x}, {s, -c, -thd_y}, {0.0f, 0.0f, -1.0f}};
  const float jd[3][3] = {{c, s, thd_x}, {-s, c, thd_y}, {0.0f, 0.0f, 1.0f}};
  // Om_w J for both ends, then J^T Om_w J
  float OJs[3][3], OJd[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float ts = 0.0f, td = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ts += Om[i][j] * wH * js[j][k];
        td += Om[i][j] * wH * jd[j][k];
      }
      OJs[i][k] = ts;
      OJd[i][k] = td;
    }
  float Hss[3][3], Hdd[3][3], Hsd[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float ss = 0.0f, dd = 0.0f, sd = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ss += js[i][j] * OJs[i][k];
        dd += jd[i][j] * OJd[i][k];
        sd += js[i][j] * OJd[i][k];
      }
      Hss[j][k] = ss;
      Hdd[j][k] = dd;
      Hsd[j][k] = sd;
    }
  float ew[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) t += Om[i][j] * (wb * ev[j]);
    ew[i] = t;
  }
  float *ps = pose_planes(a) + (size_t)9 * (a.nb + e);
  float *pd = pose_planes(a) + (size_t)9 * (a.nb + a.no + e);
  int q = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      // an edge from a pose to itself couples the pose with itself
      ps[q] = Hss[i][j] + (si == di ? Hsd[i][j] + Hsd[j][i] : 0.0f);
      pd[q] = Hdd[i][j];
      ++q;
    }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float bs = 0.0f, bd = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      bs += js[i][j] * ew[i];
      bd += jd[i][j] * ew[i];
    }
    ps[6 + j] = bs;
    pd[6 + j] = bd;
  }
  float *cp = c_planes(a) + (size_t)9 * e;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) cp[3 * i + j] = Hsd[i][j];
  float *st = edge_stats(a) + (size_t)3 * (a.nb + e);
  st[0] = chi2;
  st[1] = robust_cost(chi2, kt, a.robust);
  st[2] = chi2 > kt ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(EDGE_THREADS) gn_edge_kernel(const GNStepArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.nb)
    bearing_edge(a, t);
  else if (t < a.nb + a.no)
    odometry_edge(a, t - a.nb);
}

// Pose p: its diagonal 3x3 block of Hpp (undamped) and bp.
__device__ void pose_owner(const GNStepArgs &a, int p) {
  float h[9] = {};
  const float *planes = pose_planes(a);
  for (int j = a.pose_off[p]; j < a.pose_off[p + 1]; ++j) {
    const float *pl = planes + (size_t)9 * a.pose_order[j];
#pragma unroll
    for (int q = 0; q < 9; ++q) h[q] += pl[q];
  }
  const int r = 3 * p;
  float *H = a.Hpp + (size_t)r * a.Np + r;
  const int n = a.Np;
  H[0] = h[0];         H[1] = h[1];         H[2] = h[2];
  H[n] = h[1];         H[n + 1] = h[3];     H[n + 2] = h[4];
  H[2 * n] = h[2];     H[2 * n + 1] = h[4]; H[2 * n + 2] = h[5];
  a.bp[r] = h[6];
  a.bp[r + 1] = h[7];
  a.bp[r + 2] = h[8];
}

// Landmark lane l: Hll^-1 of its damped 2x2 block, and bl.  Padding lanes
// (l >= nl) get zeros and are never inverted.
__device__ void landmark_owner(const GNStepArgs &a, int l) {
  float *hb = a.Hb + 4 * (size_t)l;
  if (l >= a.nl) {
    hb[0] = hb[1] = hb[2] = hb[3] = 0.0f;
    a.bl[2 * l] = a.bl[2 * l + 1] = 0.0f;
    return;
  }
  float h[5] = {};
  const float *planes = lm_planes(a);
  for (int j = a.lm_off[l]; j < a.lm_off[l + 1]; ++j) {
    const float *pl = planes + (size_t)5 * a.lm_order[j];
#pragma unroll
    for (int q = 0; q < 5; ++q) h[q] += pl[q];
  }
  const float damping = a.scal[0];
  const float p = h[0] + damping, b = h[1], d = h[2] + damping;
  const float inv_det = 1.0f / (p * d - b * b);
  hb[0] = d * inv_det;
  hb[1] = -b * inv_det;
  hb[2] = -b * inv_det;
  hb[3] = p * inv_det;
  a.bl[2 * l] = h[3];
  a.bl[2 * l + 1] = h[4];
}

// Sorted position j of the (pose, landmark) keys: the first edge of a run
// sums the run into the pair's 3x2 block of U.
__device__ void pair_owner(const GNStepArgs &a, int j) {
  const int key = a.u_key[j];
  if (j > 0 && a.u_key[j - 1] == key) return;
  float u[6] = {};
  const float *planes = u_planes(a);
  for (int k = j; k < a.nb && a.u_key[k] == key; ++k) {
    const float *pl = planes + (size_t)6 * a.u_order[k];
#pragma unroll
    for (int q = 0; q < 6; ++q) u[q] += pl[q];
  }
  const int p = key / a.nl, l = key % a.nl;
  float *Ur = a.U + (size_t)(3 * p) * a.Ml + 2 * l;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Ur[(size_t)i * a.Ml] = u[2 * i];
    Ur[(size_t)i * a.Ml + 1] = u[2 * i + 1];
  }
}

// Sorted position j of the unordered odometry pair keys: the first edge of a
// run sums the run's coupling, oriented from the lower pose to the higher,
// and writes the block and its transpose.  Edges a->b and b->a land in one
// sum.
__device__ void coupling_owner(const GNStepArgs &a, int j) {
  const int key = a.c_key[j];
  if (j > 0 && a.c_key[j - 1] == key) return;
  const int lo = key / a.np_, hi = key % a.np_;
  if (lo == hi) return;  // folded into the pose's own block by the edge kernel
  float C[9] = {};
  const float *planes = c_planes(a);
  for (int k = j; k < a.no && a.c_key[k] == key; ++k) {
    const int e = a.c_order[k];
    const float *pl = planes + (size_t)9 * e;
    const bool forward = a.o_src[e] == lo;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) C[3 * r + c] += forward ? pl[3 * r + c] : pl[3 * c + r];
  }
  const int n = a.Np;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.Hpp[(size_t)(3 * lo + r) * n + 3 * hi + c] = C[3 * r + c];
      a.Hpp[(size_t)(3 * hi + c) * n + 3 * lo + r] = C[3 * r + c];
    }
}

__global__ void __launch_bounds__(EDGE_THREADS) gn_assemble_kernel(const GNStepArgs a) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.np_) return pose_owner(a, t);
  t -= a.np_;
  if (t < a.Ml / 2) return landmark_owner(a, t);
  t -= a.Ml / 2;
  if (t < a.nb) return pair_owner(a, t);
  t -= a.nb;
  if (t < a.no) coupling_owner(a, t);
}

// One block: boxplus into shared memory, then the sums (each thread a fixed
// strided share, then a fixed tree), then the state is written if finite.
__global__ void __launch_bounds__(FIN_THREADS) gn_finish_kernel(const GNStepArgs a) {
  __shared__ float np_s[3 * GN_MAX_POSES];
  __shared__ float nl_s[2 * GN_MAX_LANDMARKS];
  __shared__ float part[FIN_THREADS / 32][8];
  __shared__ float total[8];
  const int tid = threadIdx.x;
  float acc[8] = {};  // chi2_b, chi2_o, rob_b, rob_o, clamped_b, clamped_o, |delta|^2, bad
  for (int p = tid; p < a.np_; p += FIN_THREADS) {
    const float *d = a.x + 3 * p, *o = a.poses + 3 * p;
    float s, c;
    sincosf(d[2], &s, &c);
    const float nx = c * o[0] - s * o[1] + d[0];
    const float ny = s * o[0] + c * o[1] + d[1];
    const float nt = wrap_angle(o[2] + d[2]);
    np_s[3 * p] = nx;
    np_s[3 * p + 1] = ny;
    np_s[3 * p + 2] = nt;
    if (!(finite(nx) && finite(ny) && finite(nt))) acc[7] = 1.0f;
  }
  for (int l = tid; l < a.nl; l += FIN_THREADS) {
    const float lx = a.lms[2 * l] + a.dl[2 * l], ly = a.lms[2 * l + 1] + a.dl[2 * l + 1];
    nl_s[2 * l] = lx;
    nl_s[2 * l + 1] = ly;
    if (!(finite(lx) && finite(ly))) acc[7] = 1.0f;
  }
  const float *est = edge_stats(a);
  for (int e = tid; e < a.nb; e += FIN_THREADS) {
    acc[0] += est[3 * e];
    acc[2] += est[3 * e + 1];
    acc[4] += est[3 * e + 2];
  }
  for (int e = tid; e < a.no; e += FIN_THREADS) {
    const float *st = est + (size_t)3 * (a.nb + e);
    acc[1] += st[0];
    acc[3] += st[1];
    acc[5] += st[2];
  }
  for (int i = tid; i < a.Np; i += FIN_THREADS) acc[6] += a.x[i] * a.x[i];
  for (int i = tid; i < a.Ml; i += FIN_THREADS) acc[6] += a.dl[i] * a.dl[i];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float v = warp_sum(acc[q]);
    if ((tid & 31) == 0) part[tid >> 5][q] = v;
  }
  __syncthreads();
  if (tid < 8) {
    float v = 0.0f;
    for (int w = 0; w < FIN_THREADS / 32; ++w) v += part[w][tid];
    total[tid] = v;
  }
  __syncthreads();
  const bool ok = total[7] == 0.0f;
  if (tid == 0) {
    a.stats[0] = total[0];
    a.stats[1] = total[1];
    a.stats[2] = total[2] + total[3];
    a.stats[3] = total[4];
    a.stats[4] = total[5];
    a.stats[5] = total[6];
    a.stats[6] = ok ? 1.0f : 0.0f;
    a.stats[7] = 0.0f;
  }
  if (!ok) return;
  for (int i = tid; i < 3 * a.np_; i += FIN_THREADS) a.poses[i] = np_s[i];
  for (int i = tid; i < 2 * a.nl; i += FIN_THREADS) a.lms[i] = nl_s[i];
}

}  // namespace boslam

extern "C" {

// One GN iteration on the state a->poses [np_, 3], a->lms [nl, 2], updated
// in place; this step's stats go to a->stats.  Hpp, U and bp must be zero
// where no block is written (zeroed once per solve).  Returns the first
// failed launch's error, or cudaErrorInvalidValue for sizes out of range
// or a band whose window does not fit, else 0.
int boslam_gn_step(const boslam::GNStepArgs *args, void *stream_ptr) {
  using namespace boslam;
  const GNStepArgs a = *args;
  if (a.np_ < 1 || a.np_ > GN_MAX_POSES || a.nl < 1 || a.nl > GN_MAX_LANDMARKS ||
      a.Np % T || a.Ml % T || 3 * a.np_ > a.Np || 2 * a.nl > a.Ml || a.nb < 0 || a.no < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int ne = a.nb + a.no;
  if (ne > 0) {
    gn_edge_kernel<<<(ne + EDGE_THREADS - 1) / EDGE_THREADS, EDGE_THREADS, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int na = a.np_ + a.Ml / 2 + ne;
  gn_assemble_kernel<<<(na + EDGE_THREADS - 1) / EDGE_THREADS, EDGE_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t nw = (size_t)a.Np * a.Ml;
  schur_w_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, stream>>>(a.U, a.Hb, a.W, a.Np, a.Ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  schur_rhs_kernel<<<(a.Np * 32 + 255) / 256, 256, 0, stream>>>(a.W, a.bl, a.bp, a.mask, a.rhs,
                                                                a.Np, a.Ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // scal[0], the damping, is the lam the S kernel adds on the diagonal
  if ((err = s_factor_solve(a.Hpp, a.W, a.U, a.mask, a.scal, a.S, a.Linv, a.rhs, a.y, a.x, a.Np,
                            a.Ml, a.band, stream)) != cudaSuccess)
    return (int)err;
  schur_dl_kernel<<<a.Ml / T, SOLVE_THREADS, 0, stream>>>(a.U, a.Hb, a.bl, a.x, a.dl, a.Np,
                                                          a.Ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gn_finish_kernel<<<1, FIN_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

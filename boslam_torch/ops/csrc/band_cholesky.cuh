// The band route of the factor-solve: the Cholesky factorization and solve
// of an SPD f32 matrix whose lower triangle is zero more than bt tiles
// below the diagonal, in ONE thread block with no grid barrier.  Shared by
// schur_solve.cu and gn_step.cu; cholesky.cuh's cooperative dense route
// stays for every system whose band does not fit.
//
// Why a band: the reduced pose system S = Hpp + lam I - U Hll^-1 U^T of a
// graph, in the port's pose order (3p + c), couples two poses only through
// an odometry edge or a landmark both observe.  At 301 poses (Np = 1024,
// 32 tiles of TILE = 32) its band is bt = 3-4 tiles; the dense route's
// 2 Np/32 - 1 grid barriers (cholesky.cuh) then wait on chains of tiles
// that are exact zeros.  The right-looking algorithm makes no fill outside
// the band, so every tile it skips would only receive sums of exact zeros:
// the band route computes every entry by the dense route's sums (the tile
// products of mm_nt, chol::tile_factor_invert, the substitutions of
// backward_phase), each in the same order, and gives the same bits
// wherever the result is finite.
//
// The block: 384 threads, so that the one-warp factor keeps its row in
// registers (168 per thread; at 512 and 1024 threads the caps of 128 and
// 64 spill it, and the factor took 1.3x and 2.1x as long: PERF.md, §6).
// Team 0 (warps 0-3, one on each of the SM's four schedulers) carries the
// chain; six product teams of one warp each, none on warp 0's scheduler,
// do the rest.  Panel c = 0
// .. nb-1 (nb = n / TILE), m = min(bt, nb-1-c):
//   team 0: L_c+1,c = A_c+1,c L_cc^-T, published to the product teams; the
//       look-ahead update A_c+1,c+1 -= L_c+1,c L_c+1,c^T; then warp 0
//       factors and inverts that tile in registers (factor_invert) while
//       warps 1-3 solve y_c = L_cc^-1 t_c (b rides along: t_c is b_c less
//       the earlier panels' updates), apply y_i -= L_ic y_c, store L_cc^-1
//       for the backward sweep and copy the band's next tile row in from L2
//       (cp.async);
//   product teams, once L_c+1,c is out (so they do not slow the chain's
//       products): L_ic = A_ic L_cc^-T for i = c+2 .. c+m, then the
//       trailing update A_ij -= L_ic L_jc^T of every other tile of the
//       window, while warp 0 factors.
// One block barrier per panel; the teams meet on named barriers (1: team
// 0; 2: warps 1-3; 3: L_c+1,c published; 4: the product teams; 5: their
// panel tiles published to warps 1-3).  The backward sweep, row i = nb-1
// .. 0: warp 0 computes x_i = m_i o (L_ii^-T y_i), warps 1..bt recompute
// it in registers and each applies y_k -= L_ik^T x_i for one k (no barrier
// between), while warps 8-11 copy row i-2's tiles in; one block barrier
// per row.
//
// The window: tile (i, j), i - j <= bt, lives in slot (i mod K) K + (i - j),
// K = bt + 1, as a TILE x (TILE + 4) tile (rows 16-byte aligned, so tile
// products load four entries per instruction and the copies move 16
// bytes, and rows 4 banks apart); then two tile inverses and y [n].  The
// route rule: the band route takes a system when its window, smem_bytes(),
// fits the 227 KB one H100 block may opt into (bt <= 5 up to n = 1536);
// its numbers are in band_window.h, which ops/cholesky.py band_fits reads.
// A launch past that is refused by cudaFuncSetAttribute and returned,
// never run on the dense route.
//
// What bounds it: the chain.  At bt = 3 the factor needs ~9e6 FMAs, ~0.3
// us of one SM; the sweep is nb dependent panels, each a tile product, a
// look-ahead product and the one-warp factor and inverse of a 32 x 32 tile
// (32 pivot steps of shuffles and an rsqrt, then a 32-step substitution
// per lane), then nb backward rows.  Semantics of cholesky.cuh: only the
// lower triangle is read; a non-positive pivot gives NaN or inf, which
// reaches x; no atomics, no barrier or loop that depends on a value; f32
// FMA on the CUDA cores only.
#pragma once

#include "band_window.h"
#include "cholesky.cuh"

namespace boslam {
namespace band {

using chol::TILE;
constexpr int LD = BOSLAM_BAND_LD;  // a window tile's row stride, in floats
static_assert(LD == TILE + 4, "rows of TILE floats, 16-byte aligned, 4 banks apart");
using Tile = float (*)[LD];

constexpr int THREADS = 384;
constexpr int TEAM = 128;  // team 0: warps 0-3, one per scheduler, carries the chain
// Product teams: the six single warps 5, 6, 7, 9, 10, 11, none on warp 0's
// scheduler (warp % 4 != 0), so the one-warp factor shares its scheduler
// only with warps that copy tiles.  A warp computes a whole tile product,
// 8 x 4 entries a lane: 12 shared-memory loads of 16 bytes per 128 FMAs,
// since the products are bound by the SM's one shared-memory pipe, which
// the factor's shuffles use too.
constexpr int QT = 32;
constexpr int NQ = 6;
constexpr int G = chol::THREADS / TILE;  // partial sums per column, as in backward_phase
constexpr int TILE_FLOATS = TILE * LD;
constexpr int PREFETCH = 8;           // warps 8-11 copy the backward rows in
constexpr int MAX_BT = PREFETCH - 1;  // warps 0..bt run the backward substitution

// Shared memory of the band route at band bt for an n x n system: the
// window's (bt + 1)^2 tiles, the spare tiles (two tile inverses) and y [n];
// ops/cholesky.py band_smem_bytes reads the same numbers from band_window.h.
inline size_t smem_bytes(int bt, int n) {
  const size_t k = (size_t)bt + 1;
  return sizeof(float) * ((k * k + BOSLAM_BAND_SPARE_TILES) * TILE_FLOATS + (size_t)n);
}

// Cycle counts of the sweep's parts, summed over the panels by the threads
// that run them into band_prof, when built with -DBOSLAM_BAND_PROFILE
// (tools/port_band_probe.py, which names the slots); otherwise every call
// is empty.  Slots 0-6 by thread 0, 7 by thread 32 (warps 1-3), 8-10 by
// thread 160 (a product team).
constexpr int PROF_SLOTS = 11;
#ifdef BOSLAM_BAND_PROFILE
__device__ unsigned long long band_prof[PROF_SLOTS];
struct Prof {
  long long t;
  int tid;
  __device__ void init(int thread) {
    tid = thread;
    t = clock64();
  }
  __device__ void lap(int k) {
    const long long now = clock64();
    if ((tid == 0 && k < 7) || (tid == 32 && k == 7) || (tid == 5 * 32 && k >= 8))
      atomicAdd(&band_prof[k], (unsigned long long)(now - t));
    t = now;
  }
};
#else
struct Prof {
  __device__ void init(int) {}
  __device__ void lap(int) {}
};
#endif

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// acc[u][v] = sum_m A[tr + (NT/8) u][m] B[tc + 8 v][m] (tr = t / 8, tc =
// t % 8) by NT threads t: the tile product A B^T, every entry summed in m
// order as chol::mm_nt sums it.
template <int NT>
using Acc = float[256 / NT][4];

template <int NT>
__device__ __forceinline__ void mm_nt(const Tile A, const Tile B, Acc<NT> &acc, int t) {
  constexpr int U = 256 / NT, S = NT / 8;
  const int tr = t / 8, tc = t % 8;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
#pragma unroll 2
  for (int m0 = 0; m0 < TILE; m0 += 4) {
    float4 a[U], b[4];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = *reinterpret_cast<const float4 *>(&A[tr + S * u][m0]);
#pragma unroll
    for (int v = 0; v < 4; ++v) b[v] = *reinterpret_cast<const float4 *>(&B[tc + 8 * v][m0]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[u][v] += a[u].x * b[v].x;
        acc[u][v] += a[u].y * b[v].y;
        acc[u][v] += a[u].z * b[v].z;
        acc[u][v] += a[u].w * b[v].w;
      }
  }
}

// chol::tile_factor_invert with its chain reordered, the same sums in the
// same order on every entry it keeps (so the same bits): each pivot step
// first updates the next column's entry and starts the next pivot's
// shuffle and rsqrt, then the other columns' updates issue, unpredicated,
// while those are in flight; the inverse takes every 1 / L_mm in one round
// of shuffles first.  One warp, no barrier.
__device__ __forceinline__ void factor_invert(Tile D, Tile X, int lane) {
  using chol::FULL;
  float a[TILE];
#pragma unroll
  for (int k = 0; k < TILE; ++k) a[k] = (k <= lane) ? D[lane][k] : 0.0f;
  float rinv = 0.0f;  // 1 / L_rr of this lane's row
  float dinv = rsqrtf(__shfl_sync(FULL, a[0], 0));
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    if (lane == j) rinv = dinv;
    a[j] = (lane >= j) ? a[j] * dinv : 0.0f;
    // (lanes above the diagonal update their zeroed entries too: those are
    // reset to 0 at their own step before any use, and never stored)
    if (j + 1 < TILE) {
      a[j + 1] -= a[j] * __shfl_sync(FULL, a[j], j + 1);
      dinv = rsqrtf(__shfl_sync(FULL, a[j + 1], j + 1));
    }
#pragma unroll
    for (int k = j + 2; k < TILE; ++k) a[k] -= a[j] * __shfl_sync(FULL, a[j], k);
  }
#pragma unroll
  for (int k = 0; k < TILE; ++k)
    if (k <= lane) D[lane][k] = a[k];
  __syncwarp();
  float r[TILE];
#pragma unroll
  for (int m = 0; m < TILE; ++m) r[m] = __shfl_sync(FULL, rinv, m);
  float v[TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i) v[i] = (i == lane) ? 1.0f : 0.0f;
#pragma unroll
  for (int m = 0; m < TILE; ++m) {
    v[m] *= r[m];
#pragma unroll
    for (int i = m + 1; i < TILE; ++i) v[i] -= D[i][m] * v[m];
  }
#pragma unroll
  for (int i = 0; i < TILE; ++i) X[i][lane] = (i >= lane) ? v[i] : 0.0f;
}

// The entries of acc into the tile C (and into the global tile at Cg, row
// stride ld, unless null), or subtracted from C with `sub`.
template <int NT>
__device__ __forceinline__ void put(Tile C, float *Cg, int ld, const Acc<NT> &acc, int t,
                                    bool sub) {
  constexpr int U = 256 / NT, S = NT / 8;
  const int tr = t / 8, tc = t % 8;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = tr + S * u, s = tc + 8 * v;
      if (sub) {
        C[r][s] -= acc[u][v];
      } else {
        C[r][s] = acc[u][v];
        if (Cg) Cg[(size_t)r * ld + s] = acc[u][v];
      }
    }
}

// Threads t = 0 .. nt-1 copy `tiles` consecutive tiles of one tile row,
// tile q from src + q * step (row stride ld), into dst(q), by the card's
// asynchronous copy (cp.async, 16 bytes, through L2): every copy is in
// flight at once and no register holds the data.  The copies are one
// commit group; with `wait` each thread waits for all of its groups, else
// for all but this one.
template <typename Dst>
__device__ __forceinline__ void load_row(Dst dst, const float *src, int ld, int step, int tiles,
                                         int t, int nt, bool wait = true) {
  constexpr int V = TILE * TILE / 4;  // 16-byte pieces of a tile
  for (int e = t; e < tiles * V; e += nt) {
    const int q = e / V, f = e % V, r = f / (TILE / 4), c = 4 * (f % (TILE / 4));
    const unsigned to = (unsigned)__cvta_generic_to_shared(&dst(q)[r][c]);
    const float *from = src + (size_t)q * step + (size_t)r * ld + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(from) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (wait)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// L (n x n, row-major): the band of the lower triangle of S on entry; on
// return the off-diagonal tiles of the band hold the factor.  Linv [nb, T,
// T]: the diagonal factors' inverses.  b [n] in, x [n] out; mask (nullable)
// multiplies each solved tile of x, as backward_phase does.
__global__ void __launch_bounds__(THREADS, 1)
band_solve_kernel(float *L, float *Linv, const float *b, float *x, const float *mask, int n,
                  int bt) {
  extern __shared__ float smem[];
  const int K = bt + 1, nb = n / TILE;
  Tile win = reinterpret_cast<Tile>(smem);
  Tile Xs = win + (size_t)K * K * TILE;  // two tile inverses
  float *ys = smem + (size_t)(K * K + BOSLAM_BAND_SPARE_TILES) * TILE_FLOATS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tt = tid % TEAM;
  // product team qq = 0..5 (warps 5-7, 9-11; its lane is its thread), or -1
  const int qq = warp >= 4 && warp % 4 ? 3 * (warp / 4 - 1) + warp % 4 - 1 : -1, qt = lane;
  auto slot = [&](int i, int d) { return win + (size_t)((i % K) * K + d) * TILE; };
  auto X = [&](int c) { return Xs + (size_t)(c & 1) * TILE; };
  auto Lg = [&](int i, int j) { return L + (size_t)i * TILE * n + (size_t)j * TILE; };
  Prof prof;
  prof.init(tid);

  // rows 0 .. min(bt, nb-1) of the band, and y = b
  for (int i = 0; i < nb && i <= bt; ++i)
    load_row([&](int q) { return slot(i, i - q); }, Lg(i, 0), n, TILE, i + 1, tid, THREADS);
  for (int r = tid; r < n; r += THREADS) ys[r] = b[r];
  __syncthreads();
  if (warp == 0) factor_invert(slot(0, 0), X(0), lane);
  __syncthreads();
  prof.lap(0);

  for (int c = 0; c < nb; ++c) {
    const int m = min(bt, nb - 1 - c), c0 = c * TILE;
    const Tile Xc = X(c);
    if (warp < 4) {
      if (m > 0) {
        // the chain's panel tile, published to the product teams ...
        Acc<TEAM> acc;
        mm_nt<TEAM>(slot(c + 1, 1), Xc, acc, tt);
        prof.lap(1);
        bar_sync(1, TEAM);
        put<TEAM>(slot(c + 1, 1), Lg(c + 1, c), n, acc, tt, false);
        bar_arrive(3, TEAM + NQ * QT);
        bar_sync(1, TEAM);
        prof.lap(2);
        // ... and the look-ahead update of the next diagonal tile
        mm_nt<TEAM>(slot(c + 1, 1), slot(c + 1, 1), acc, tt);
        put<TEAM>(slot(c + 1, 0), nullptr, 0, acc, tt, true);
      } else if (c + 1 < nb) {  // bt = 0: the next diagonal tile, alone in the window
        load_row([&](int) { return slot(c + 1, 0); }, Lg(c + 1, c + 1), n, 0, 1, tt, TEAM);
      }
      bar_sync(1, TEAM);
      prof.lap(3);
      if (warp == 0) {
        if (c + 1 < nb) factor_invert(slot(c + 1, 0), X(c + 1), lane);
        prof.lap(4);
      } else {
        // y_c = L_cc^-1 t_c, recomputed by each warp that applies it
        const float t = ys[c0 + lane];
        float yc = 0.0f;
#pragma unroll
        for (int k = 0; k < TILE; ++k) {
          const float tk = __shfl_sync(chol::FULL, t, k);
          if (k <= lane) yc += Xc[lane][k] * tk;
        }
        bar_sync(2, TEAM - 32);
        if (warp == 1) ys[c0 + lane] = yc;
        if (m > 1) bar_sync(5, NQ * QT + TEAM - 32);  // the other panel tiles are in
        for (int w = warp; w <= m; w += 3) {  // y_c+w -= L_c+w,c y_c
          const Tile P = slot(c + w, w);
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < TILE; ++k) s += P[lane][k] * __shfl_sync(chol::FULL, yc, k);
          ys[(c + w) * TILE + lane] -= s;
        }
        float *Lc = Linv + (size_t)c * TILE * TILE;
        for (int e = tid - 32; e < TILE * TILE; e += TEAM - 32) Lc[e] = Xc[e / TILE][e % TILE];
        const int i = c + 1 + bt;  // the band's next tile row, into row c's slots
        if (bt > 0 && i < nb)
          load_row([&](int q) { return slot(i, bt - q); }, Lg(i, c + 1), n, TILE, K, tid - 32,
                   TEAM - 32);
        prof.lap(7);
      }
    } else if (qq >= 0 && m > 0) {
      // after the chain's products: the other panel tiles, then the trailing
      // update, while warp 0 factors
      bar_sync(3, TEAM + NQ * QT);
      prof.lap(8);
      for (int d0 = 2; d0 <= m; d0 += NQ) {  // a round: one panel tile per team
        const int d = d0 + qq;
        Acc<QT> acc;
        if (d <= m) mm_nt<QT>(slot(c + d, d), Xc, acc, qt);
        bar_sync(4, NQ * QT);
        if (d <= m) put<QT>(slot(c + d, d), Lg(c + d, c), n, acc, qt, false);
      }
      if (m > 1) {
        bar_arrive(5, NQ * QT + TEAM - 32);
        bar_sync(4, NQ * QT);  // every panel tile is in
      }
      prof.lap(9);
      const int ntr = m * (m + 1) / 2;
      for (int t = 1 + qq; t < ntr; t += NQ) {
        int ip, jp;
        tri_decode(t, ip, jp);
        const int i = c + 1 + ip, j = c + 1 + jp;
        Acc<QT> a;
        mm_nt<QT>(slot(i, i - c), slot(j, j - c), a, qt);
        put<QT>(slot(i, i - j), nullptr, 0, a, qt, true);
      }
      prof.lap(10);
    }
    __syncthreads();
    prof.lap(5);
  }

  // the backward sweep; row i's tiles in buffer i % 3: Linv_i, then L_i,i-d.
  // Row i-2's copies are issued at row i, so each has a row's time to land.
  auto buf = [&](int i, int d) { return win + (size_t)((i % 3) * K + d) * TILE; };
  auto load_back = [&](int i, int t, int nt, bool wait) {
    const int lo = i - bt > 0 ? i - bt : 0;
    // Linv_i and the tiles k = lo .. i-1 (tile q = k - lo: buffer d = i - k), one group
    for (int e = t; e < TILE * TILE / 4; e += nt) {
      const int r = e / (TILE / 4), c = 4 * (e % (TILE / 4));
      const unsigned to = (unsigned)__cvta_generic_to_shared(&buf(i, 0)[r][c]);
      const float *from = Linv + (size_t)i * TILE * TILE + 4 * e;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(from) : "memory");
    }
    load_row([&](int q) { return buf(i, i - lo - q); }, Lg(i, lo), n, TILE, i - lo, t, nt, wait);
  };
  load_back(nb - 1, tid, THREADS, true);
  if (warp >= PREFETCH && nb > 1)
    load_back(nb - 2, tid - PREFETCH * 32, THREADS - PREFETCH * 32, false);
  __syncthreads();
  float mk = mask ? mask[(nb - 1) * TILE + lane] : 1.0f;  // row i's mask, read a row ahead
  for (int i = nb - 1; i >= 0; --i) {
    const int i0 = i * TILE;
    const float mi = mk;
    if (mask && i > 0) mk = mask[i0 - TILE + lane];
    if (warp <= bt && warp <= i) {
      // x_i = m_i o (L_ii^-T y_i), each column as backward_phase sums it
      const Tile Li = buf(i, 0);
      float xv = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int k = g; k < TILE; k += G) s += Li[k][lane] * ys[i0 + k];
        xv += s;
      }
      if (mask) xv *= mi;
      if (warp == 0) {
        x[i0 + lane] = xv;
      } else {  // y_k -= L_ik^T x_i, k = i - warp
        const Tile Pk = buf(i, warp);
        float v = 0.0f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int k = g; k < TILE; k += G) s += Pk[k][lane] * __shfl_sync(chol::FULL, xv, k);
          v += s;
        }
        ys[(i - warp) * TILE + lane] -= v;
      }
    } else if (warp >= PREFETCH && i > 0) {  // row i-1 lands, row i-2 is issued
      if (i > 1)
        load_back(i - 2, tid - PREFETCH * 32, THREADS - PREFETCH * 32, false);
      else
        asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
  }
  prof.lap(6);
}

// Factor and solve on `stream` in one launch of one block; returns the
// launch's error (cudaErrorInvalidValue when the window does not fit).
inline cudaError_t factor_solve(float *L, float *Linv, const float *b, float *x,
                                const float *mask, int n, int bt, cudaStream_t stream) {
  if (n <= 0 || n % TILE || bt < 0 || bt > MAX_BT) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(bt, n);
  cudaError_t err = cudaFuncSetAttribute(band_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it for later launches' checks
    return err;
  }
  band_solve_kernel<<<1, THREADS, bytes, stream>>>(L, Linv, b, x, mask, n, bt);
  return cudaGetLastError();
}

}  // namespace band
}  // namespace boslam

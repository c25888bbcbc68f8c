// One iteration of block-Jacobi PCG on the packed Schur system, committed
// where the loop still runs and frozen elsewhere: the body of
// boslam_torch/solver/schur.py pcg with the matvec of
// boslam_torch/solver/schur_packed.py packed_s_matvec, as four launches,
// on an odometry that is a chain prefix and any number of loop-closure
// edges past it.  Plain C interface, loaded with ctypes by
// boslam_torch/ops/pcg_body.py; its plain twin is
// boslam_torch/solver/schur_packed.py plain_cg_body, the same iteration in
// PyTorch.
//
// It replaces no TPU kernel: the JAX package runs this body as XLA's fused
// operations inside a while_loop on the device.  In PyTorch the body was
// ~76 small operations (cuBLAS's batched 3x3 and 3x2 products, reductions,
// selects), replayed from a CUDA graph: ~0.18 ms of device time a body on
// the 10k graphs, nearly all of it launch latency and kernel tails.
//
// What bounds it on the H100: latency.  A body reads the coupling blocks
// once (Bp [np, kp, 3, 2], Bl [nlv, kl, 3, 2], ~1.7 MB each at 10k poses),
// their slot indices, the 3x3 and 2x2 blocks and a few [np, 3] vectors:
// ~8 MB, which the 50 MB L2 holds, so ~3 us at the HBM rate.  What the
// design can cut is the chain of dependent launches: a CG iteration has
// three grid-wide dependencies (every landmark's z before the pose rows,
// p^T A p before alpha, r^T r and r^T z before beta), so four launches:
//
//   1. landmark rows:  zrow[v] = sum_k Bl[v,k]^T (p m)[l_pose[v,k]]
//   2. pose rows:      w = Hll^-1 (sum of the landmark's rows of zrow),
//                      computed per gathered landmark; A p = Hpp p m + the
//                      chain shifts + the row's loop closures
//                      - sum_k Bp[p,k] w[p_lm[p,k]], masked; p^T A p
//                      partials per block
//   3. elementwise:    alpha; x + alpha p, r - alpha A p, z = M^-1 r; the
//                      old scalars copied aside; r^T r, r^T z partials
//   4. commit:         beta; x, r, z, p, x_best where the loop runs, the
//                      scalars by block 0
//
// A grid row is taken by a group of G lanes (G the slot count rounded up
// to a power of two, 4 to 32), each lane summing every G-th slot, the
// group then reduced by shuffles.  Every reduction runs in a fixed order:
// a group's butterfly, a block's tree, and each block of the next launch
// summing the same partials in the same order, so the result does not
// depend on scheduling and a body repeats to the bit; there is no float
// atomic.  All arithmetic is f32 (FMA contraction allowed).
//
// A loop-closure edge e (pose s -> d, coupling Ho[e]) is listed twice in a
// per-pose CSR built once a solve (boslam_torch/graph/packed.py LoopRows):
// on row s as Ho[e] (p m)[d] and on row d as Ho[e]^T (p m)[s], each row's
// entries in the order of their edge index.  The row's group sums them as
// it sums the slots (each lane every G-th entry, then the butterfly), and
// lane 0 adds that sum after the chain shifts, so the loop terms too are
// summed in a fixed order without atomics.  On a chain alone nothing is
// added, and the body's bits are those it had without loop rows.  The list
// is checked on the host when it is built (every neighbour a pose, every
// edge past the chain); the kernel reads it as it is.
//
// A grid with a windowed-gather plan reads its gathered vector through the
// plan's window (boslam_torch/ops/windowed_gather.py): a block of ROWS rows
// lies in one row tile and stages values[starts[tile] : + window] in shared
// memory (p m for the landmark grid, w for the pose grid), and a slot whose
// index falls outside the window, or past the values, contributes exact
// zeros.  A grid without a plan reads by index, from L2 (its padding slots
// index row 0, as values[idx] does, and their zero blocks cancel it).
#include <cuda_runtime.h>

// Field order is mirrored by _Args in boslam_torch/ops/pcg_body.py.
struct PCGBodyArgs {
  // the packed system, fixed for a pcg call
  const float *hpp;      // [np, 3, 3] damped pose blocks
  const float *minv;     // [np, 3, 3] block-Jacobi inverses
  const float *ho;       // [no, 3, 3] odometry couplings: the chain's first
                         // (edge e < nc: pose e -> e + 1), then the loop closures
  const float *mask;     // [np] gauge mask
  const float *hll_inv;  // [nl, 2, 2]
  const float *bp;       // [np, kp, 3, 2] pose-packed coupling blocks
  const int *p_lm;       // [np, kp]
  const float *bl;       // [nlv, kl, 3, 2] landmark-packed coupling blocks
  const int *l_pose;     // [nlv, kl]
  const int *virt_order; // [nlv] grid rows by landmark (stable); null: row v is landmark v
  const int *virt_start; // [nl + 1] each landmark's first entry of virt_order
  const int *p_starts;   // the pose grid's window starts, null: plain gathers
  const int *l_starts;   // the landmark grid's
  const int *loop_start; // [np + 1] each pose's first loop entry, null: no loop closure
  const int *loop_edge;  // [loop entries] e: Ho[e] (p m)[nbr]; ~e: Ho[e]^T (p m)[nbr]
  const int *loop_nbr;   // [loop entries] the edge's other pose
  const float *b2;       // [] |rhs|^2, clamped
  // the state read, in schur.CGState's order: iterate, residual,
  // preconditioned residual, direction, r^T z, r^T r, breakdowns,
  // iterations, best iterate and its r^T r, active
  const float *x, *r, *z, *p, *rz, *rr;
  const int *nbrk, *k;
  const float *x_best, *rr_best;
  const unsigned char *active;
  // the state written (the same buffers as those read, or others)
  float *x_o, *r_o, *z_o, *p_o, *rz_o, *rr_o;
  int *nbrk_o, *k_o;
  float *x_best_o, *rr_best_o;
  unsigned char *active_o;
  // workspace
  float *zrow;                // [nlv, 2]
  float *ap, *xn, *rn, *zn;   // [np, 3]
  float *part;                // [pose blocks + 2 * elementwise blocks]
  float *snap;                // [8]: rz, rr, rr_best, pAp, nbrk, k, active (as bits)
  int np, nl, nlv, kp, kl, nc, no;  // kp, kl: slots of a pose, landmark row
  int p_window, p_tile_rows, l_window, l_tile_rows;
  int restarts, max_iters;
  float tol2, tiny;
};

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;           // grid rows a block of launches 1 and 2 takes
constexpr int MAX_WINDOW = 1024;   // plan_windows' largest window
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pose_blocks(const PCGBodyArgs &a) {
  return (a.np + ROWS - 1) / ROWS;
}
__device__ __forceinline__ int elem_blocks(const PCGBodyArgs &a) {
  return (a.np + THREADS - 1) / THREADS;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, G);
  return v;
}

// The block's THREADS values summed by a fixed tree; every thread gets it.
__device__ float block_sum(float v, float *red) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// The sum of n partials, the same bits in every block.
__device__ float partials_sum(const float *part, int n, float *red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += THREADS) s += part[i];
  return block_sum(s, red);
}

// w[l] = Hll^-1[l] (the sum of landmark l's rows of zrow, in row order).
__device__ __forceinline__ void landmark_w(const PCGBodyArgs &a, int l, float &w0, float &w1) {
  float z0, z1;
  if (a.virt_order == nullptr) {
    z0 = a.zrow[2 * l];
    z1 = a.zrow[2 * l + 1];
  } else {
    z0 = z1 = 0.0f;
    for (int j = a.virt_start[l], e = a.virt_start[l + 1]; j < e; ++j) {
      const int v = a.virt_order[j];
      z0 += a.zrow[2 * v];
      z1 += a.zrow[2 * v + 1];
    }
  }
  const float *h = a.hll_inv + 4 * l;
  w0 = h[0] * z0 + h[1] * z1;
  w1 = h[2] * z0 + h[3] * z1;
}

// 1. zrow[v] = sum_k Bl[v,k]^T (p m)[l_pose[v,k]] ("lkij,lki->lj").
template <int G>
__global__ void __launch_bounds__(THREADS) pcg_lm_rows_kernel(const PCGBodyArgs a) {
  __shared__ float stage[MAX_WINDOW * 3];
  const int row0 = blockIdx.x * ROWS;
  const bool windowed = a.l_starts != nullptr;
  int start = 0;
  if (windowed) {
    start = a.l_starts[row0 / a.l_tile_rows];
    for (int j = threadIdx.x; j < a.l_window; j += THREADS) {
      const int i = start + j;
      const float m = i < a.np ? a.mask[i] : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) stage[3 * j + c] = i < a.np ? a.p[3 * i + c] * m : 0.0f;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x % G, group = threadIdx.x / G;
  for (int q = group; q < ROWS; q += THREADS / G) {
    const int v = row0 + q;
    const bool live = v < a.nlv;
    float z0 = 0.0f, z1 = 0.0f;
    for (int s = lane; live && s < a.kl; s += G) {
      const size_t slot = (size_t)v * a.kl + s;
      const int i = a.l_pose[slot];
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      if (windowed) {
        const int j = i - start;
        if (j >= 0 && j < a.l_window && i >= 0 && i < a.np) {
          x0 = stage[3 * j];
          x1 = stage[3 * j + 1];
          x2 = stage[3 * j + 2];
        }
      } else if (i >= 0 && i < a.np) {
        const float m = a.mask[i];
        x0 = a.p[3 * i] * m;
        x1 = a.p[3 * i + 1] * m;
        x2 = a.p[3 * i + 2] * m;
      }
      const float *B = a.bl + 6 * slot;  // [3][2]
      z0 += B[0] * x0 + B[2] * x1 + B[4] * x2;
      z1 += B[1] * x0 + B[3] * x1 + B[5] * x2;
    }
    z0 = group_sum<G>(z0);
    z1 = group_sum<G>(z1);
    if (live && lane == 0) {
      a.zrow[2 * v] = z0;
      a.zrow[2 * v + 1] = z1;
    }
  }
}

// 2. A p for ROWS poses and their p^T A p partial.
template <int G>
__global__ void __launch_bounds__(THREADS) pcg_pose_rows_kernel(const PCGBodyArgs a) {
  __shared__ float stage[MAX_WINDOW * 2];
  __shared__ float pap[ROWS];
  const int row0 = blockIdx.x * ROWS;
  const bool windowed = a.p_starts != nullptr;
  int start = 0;
  if (windowed) {
    start = a.p_starts[row0 / a.p_tile_rows];
    for (int j = threadIdx.x; j < a.p_window; j += THREADS) {
      const int l = start + j;
      float w0 = 0.0f, w1 = 0.0f;
      if (l < a.nl) landmark_w(a, l, w0, w1);
      stage[2 * j] = w0;
      stage[2 * j + 1] = w1;
    }
  }
  if (threadIdx.x < ROWS) pap[threadIdx.x] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x % G, group = threadIdx.x / G;
  for (int q = group; q < ROWS; q += THREADS / G) {
    const int i = row0 + q;
    const bool live = i < a.np;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;  // sum_k Bp w ("pkij,pkj->pi")
    for (int s = lane; live && s < a.kp; s += G) {
      const size_t slot = (size_t)i * a.kp + s;
      const int l = a.p_lm[slot];
      float w0 = 0.0f, w1 = 0.0f;
      if (windowed) {
        const int j = l - start;
        if (j >= 0 && j < a.p_window && l >= 0 && l < a.nl) {
          w0 = stage[2 * j];
          w1 = stage[2 * j + 1];
        }
      } else if (l >= 0 && l < a.nl) {
        landmark_w(a, l, w0, w1);
      }
      const float *B = a.bp + 6 * slot;  // [3][2]
      c0 += B[0] * w0 + B[1] * w1;
      c1 += B[2] * w0 + B[3] * w1;
      c2 += B[4] * w0 + B[5] * w1;
    }
    c0 = group_sum<G>(c0);
    c1 = group_sum<G>(c1);
    c2 = group_sum<G>(c2);
    // the row's loop closures, each lane every G-th entry (see the header)
    float loop[3] = {0.0f, 0.0f, 0.0f};
    if (a.loop_start != nullptr) {  // the same in every block
      const int j_end = live ? a.loop_start[i + 1] : 0;
      for (int j = (live ? a.loop_start[i] : 0) + lane; j < j_end; j += G) {
        const int code = a.loop_edge[j], n = a.loop_nbr[j];
        const float *H = a.ho + 9 * (code >= 0 ? code : ~code);
        const int rs = code >= 0 ? 3 : 1, cs = code >= 0 ? 1 : 3;  // H[rs c + cs k]
        const float mn = a.mask[n];
        const float x0 = a.p[3 * n] * mn, x1 = a.p[3 * n + 1] * mn, x2 = a.p[3 * n + 2] * mn;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          loop[c] += H[rs * c] * x0 + H[rs * c + cs] * x1 + H[rs * c + 2 * cs] * x2;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) loop[c] = group_sum<G>(loop[c]);
    }
    if (live && lane == 0) {
      const float m = a.mask[i];
      float pm[3], pv[3], y[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pv[c] = a.p[3 * i + c];
        pm[c] = pv[c] * m;
      }
      // the chain: Ho[i] (p m)[i + 1], then Ho[i - 1]^T (p m)[i - 1]
      if (i < a.nc) {
        const float *H = a.ho + 9 * i;
        const float mn = a.mask[i + 1];
        const float n0 = a.p[3 * i + 3] * mn, n1 = a.p[3 * i + 4] * mn, n2 = a.p[3 * i + 5] * mn;
#pragma unroll
        for (int c = 0; c < 3; ++c) y[c] += H[3 * c] * n0 + H[3 * c + 1] * n1 + H[3 * c + 2] * n2;
      }
      if (i >= 1 && i <= a.nc) {
        const float *H = a.ho + 9 * (i - 1);
        const float mb = a.mask[i - 1];
        const float b0 = a.p[3 * i - 3] * mb, b1 = a.p[3 * i - 2] * mb, b2 = a.p[3 * i - 1] * mb;
#pragma unroll
        for (int c = 0; c < 3; ++c) y[c] += H[c] * b0 + H[3 + c] * b1 + H[6 + c] * b2;
      }
      if (a.loop_start != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) y[c] += loop[c];
      }
      const float corr[3] = {c0, c1, c2};
      const float *Hp = a.hpp + 9 * i;
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float yc = Hp[3 * c] * pm[0] + Hp[3 * c + 1] * pm[1] + Hp[3 * c + 2] * pm[2] +
                         (y[c] - corr[c]);
        const float apc = yc * m + pv[c] * (1.0f - m);
        a.ap[3 * i + c] = apc;
        dot += pv[c] * apc;
      }
      pap[q] = dot;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int q = 0; q < ROWS; ++q) s += pap[q];
    a.part[blockIdx.x] = s;
  }
}

// 3. alpha, the candidate x, r and z = M^-1 r, their r^T r and r^T z
//    partials; block 0 sets the old scalars aside for launch 4.
__global__ void __launch_bounds__(THREADS) pcg_update_kernel(const PCGBodyArgs a) {
  __shared__ float red[THREADS];
  const float pAp = partials_sum(a.part, pose_blocks(a), red);
  const bool curv_ok = pAp > 0.0f;
  const float alpha = (curv_ok ? *a.rz : 0.0f) / (curv_ok ? pAp : 1.0f);
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float rr = 0.0f, rz = 0.0f;
  if (i < a.np) {
    float rn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float pc = a.p[3 * i + c];
      a.xn[3 * i + c] = a.x[3 * i + c] + alpha * pc;
      rn[c] = a.r[3 * i + c] - alpha * a.ap[3 * i + c];
      a.rn[3 * i + c] = rn[c];
    }
    const float *M = a.minv + 9 * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float zc = M[3 * c] * rn[0] + M[3 * c + 1] * rn[1] + M[3 * c + 2] * rn[2];
      a.zn[3 * i + c] = zc;
      rr += rn[c] * rn[c];
      rz += rn[c] * zc;
    }
  }
  float *part = a.part + pose_blocks(a);
  rr = block_sum(rr, red);
  rz = block_sum(rz, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = rr;
    part[elem_blocks(a) + blockIdx.x] = rz;
    if (blockIdx.x == 0) {
      a.snap[0] = *a.rz;
      a.snap[1] = *a.rr;
      a.snap[2] = *a.rr_best;
      a.snap[3] = pAp;
      a.snap[4] = __int_as_float(*a.nbrk);
      a.snap[5] = __int_as_float(*a.k);
      a.snap[6] = __int_as_float((int)*a.active);
    }
  }
}

// 4. beta and the commit: the new state where the loop was running, the old
//    one elsewhere; block 0 writes the scalars and the loop condition.
__global__ void __launch_bounds__(THREADS) pcg_commit_kernel(const PCGBodyArgs a) {
  __shared__ float red[THREADS];
  const float *part = a.part + pose_blocks(a);
  const float rr_n = partials_sum(part, elem_blocks(a), red);
  const float rz_new = partials_sum(part + elem_blocks(a), elem_blocks(a), red);
  const float rz = a.snap[0], rr = a.snap[1], rr_best = a.snap[2], pAp = a.snap[3];
  const int nbrk = __float_as_int(a.snap[4]), k = __float_as_int(a.snap[5]);
  const bool active = __float_as_int(a.snap[6]) != 0;
  const bool curv_ok = pAp > 0.0f, rz_ok = rz_new > 0.0f, healthy = curv_ok && rz_ok;
  const bool better = rr_n < rr_best;
  // torch.clamp(rz, min=tiny), which keeps a NaN
  const float beta = (healthy ? rz_new : 0.0f) / (rz < a.tiny ? a.tiny : rz);
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.np) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int e = 3 * i + c;
      if (active) {
        const float xn = a.xn[e], rn = a.rn[e];
        const float z_eff = rz_ok ? a.zn[e] : rn;
        a.p_o[e] = z_eff + beta * a.p[e];
        a.x_best_o[e] = better ? xn : a.x_best[e];
        a.x_o[e] = xn;
        a.r_o[e] = rn;
        a.z_o[e] = z_eff;
      } else {
        a.p_o[e] = a.p[e];
        a.x_best_o[e] = a.x_best[e];
        a.x_o[e] = a.x[e];
        a.r_o[e] = a.r[e];
        a.z_o[e] = a.z[e];
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float rz_t = active ? (rz_ok ? rz_new : rr_n) : rz;
    const float rr_t = active ? rr_n : rr;
    const int nbrk_t = active ? nbrk + (healthy ? 0 : 1) : nbrk;
    const int k_t = active ? k + 1 : k;
    *a.rz_o = rz_t;
    *a.rr_o = rr_t;
    *a.nbrk_o = nbrk_t;
    *a.k_o = k_t;
    *a.rr_best_o = active ? (better ? rr_n : rr_best) : rr_best;
    *a.active_o = (unsigned char)(active && nbrk_t <= a.restarts && k_t < a.max_iters &&
                                  rr_t / *a.b2 > a.tol2);
  }
}

int group_width(int slots) { return slots <= 4 ? 4 : slots <= 8 ? 8 : slots <= 16 ? 16 : 32; }

#define BOSLAM_BY_GROUP(G, KERNEL, BLOCKS)                                   \
  switch (G) {                                                               \
    case 4: KERNEL<4><<<(BLOCKS), THREADS, 0, stream>>>(a); break;          \
    case 8: KERNEL<8><<<(BLOCKS), THREADS, 0, stream>>>(a); break;          \
    case 16: KERNEL<16><<<(BLOCKS), THREADS, 0, stream>>>(a); break;        \
    default: KERNEL<32><<<(BLOCKS), THREADS, 0, stream>>>(a); break;        \
  }

bool plan_fits(const int *starts, int window, int tile_rows) {
  return starts == nullptr || (window >= 1 && window <= MAX_WINDOW && tile_rows >= ROWS &&
                               tile_rows % ROWS == 0);
}

}  // namespace

extern "C" {

// One CG body on `stream`: four launches (three when the landmark grid has
// no rows).  Every pointer is on the device and contiguous; the state read
// and the state written may be the same buffers.  Returns the first failed
// launch's error, or cudaErrorInvalidValue for sizes or plans it does not
// take, else 0.
int boslam_pcg_body(const PCGBodyArgs *args, void *stream_ptr) {
  const PCGBodyArgs a = *args;
  if (a.np < 1 || a.nl < 0 || a.nlv < 0 || a.kp < 1 || a.kl < 1 || a.nc < 0 || a.nc > a.np - 1 ||
      a.nc > a.no || (a.virt_order == nullptr && a.nlv != a.nl) ||
      !plan_fits(a.p_starts, a.p_window, a.p_tile_rows) ||
      !plan_fits(a.l_starts, a.l_window, a.l_tile_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int n_pose = (a.np + ROWS - 1) / ROWS, n_elem = (a.np + THREADS - 1) / THREADS;
  if (a.nlv > 0) {
    BOSLAM_BY_GROUP(group_width(a.kl), pcg_lm_rows_kernel, (a.nlv + ROWS - 1) / ROWS);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  BOSLAM_BY_GROUP(group_width(a.kp), pcg_pose_rows_kernel, n_pose);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pcg_update_kernel<<<n_elem, THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pcg_commit_kernel<<<n_elem, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

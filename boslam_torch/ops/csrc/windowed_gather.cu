// Windowed gather out[r, k, :] = values[idx[r, k], :]: the Hopper port of
// _windowed_take_padded / _gather_kernel in boslam/ops/windowed_gather.py.
// Plain C interface, loaded with ctypes by boslam_torch/ops/windowed_gather.py.
//
// Each row tile t of `tile_rows` rows reads its indices through one window
// values[starts[t] : starts[t] + window]: an index inside the window takes
// its value row, any other (padding, -1, a poisoned slot) gives exact zeros,
// and window rows past M read as zero, so window > M is fine.
//
// The TPU kernel pads values to 128 lanes, DMAs the window into VMEM and
// gathers by one-hot MXU matmuls into a [R, K, 128] output.  Here one thread
// takes one slot (r, k): the grid is (slot blocks of a tile, tiles), so a
// block lies inside one tile, reads that tile's start once and needs no
// division.  A thread reads its index with a coalesced load, tests it
// against the window and reads its value row straight from L2 (__ldg; the
// value arrays are 0.3-1.2 MB at the 100k graphs, resident in the 50 MB L2,
// so staging a window in shared memory would only add a barrier), then
// stores C floats: one float2 (C = 2) or float4 (C = 4) per slot; for C = 3
// a warp stages its 96 floats in shared memory and stores them as 24
// float4s, or by scalars where the warp is partial or unaligned.  No
// barrier precedes a store.
//
// What bounds it on the H100: bytes.  Per call it reads idx (4 R K bytes)
// and at most the values (4 M C) and writes the output (4 R K C); there is
// no arithmetic to speak of.  R K / 256 blocks (~3600 on the 100k landmark
// grid) keep every SM busy.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(THREADS)
    windowed_take_kernel(const float *__restrict__ values, int m, const int *__restrict__ idx,
                         long long slots, const int *__restrict__ starts, int window,
                         int tile_slots, float *__restrict__ out) {
  const int local = blockIdx.x * THREADS + threadIdx.x;  // slot within tile blockIdx.y
  const long long s = (long long)blockIdx.y * tile_slots + local;
  const bool live = local < tile_slots && s < slots;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = 0.0f;
  if (live) {
    const int i = __ldg(idx + s);
    const int j = i - __ldg(starts + blockIdx.y);
    if (j >= 0 && j < window && i >= 0 && i < m) {
      if constexpr (C == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2 *>(values) + i);
        v[0] = q.x;
        v[1] = q.y;
      } else if constexpr (C == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4 *>(values) + i);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = __ldg(values + (size_t)i * C + c);
      }
    }
  }
  if constexpr (C == 2) {
    if (live) reinterpret_cast<float2 *>(out)[s] = make_float2(v[0], v[1]);
  } else if constexpr (C == 4) {
    if (live) reinterpret_cast<float4 *>(out)[s] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __shared__ __align__(16) float stage[THREADS / 32][32 * C];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long first = s - lane;  // the warp's first slot
    // a whole warp of live slots whose 32 * 12 bytes start 16-byte aligned
    if (__all_sync(FULL, live) && first % 4 == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) stage[w][C * lane + c] = v[c];
      __syncwarp();
      if (lane < 32 * C / 4)  // 24 float4s = 96 floats
        reinterpret_cast<float4 *>(out + first * C)[lane] =
            reinterpret_cast<const float4 *>(stage[w])[lane];
    } else if (live) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[s * C + c] = v[c];
    }
  }
}

template <int C>
cudaError_t launch(const float *values, int m, const int *idx, int r, int k, const int *starts,
                   int window, int tile_rows, float *out, cudaStream_t stream) {
  const long long tile_slots = (long long)tile_rows * k;
  if (tile_slots > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_tiles = (r + tile_rows - 1) / tile_rows;
  const dim3 grid((unsigned)((tile_slots + THREADS - 1) / THREADS), (unsigned)n_tiles);
  windowed_take_kernel<C><<<grid, THREADS, 0, stream>>>(values, m, idx, (long long)r * k, starts,
                                                       window, (int)tile_slots, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// values [m, c] f32, idx [r, k] i32, starts [ceil(r / tile_rows)] i32 (all on
// the device, contiguous; values aligned to 4 c bytes for c = 2, 4), out
// [r, k, c] f32, 16-byte aligned.  c in {2, 3, 4}.  Launches one thread per
// slot on `stream`; returns the launch's cudaError_t, 0 if it was accepted,
// and cudaErrorInvalidValue for a c it does not take.
int boslam_windowed_take(const float *values, int m, int c, const int *idx, int r, int k,
                         const int *starts, int window, int tile_rows, float *out,
                         void *stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if ((long long)r * k == 0) return 0;
  if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 2:
      return (int)launch<2>(values, m, idx, r, k, starts, window, tile_rows, out, stream);
    case 3:
      return (int)launch<3>(values, m, idx, r, k, starts, window, tile_rows, out, stream);
    case 4:
      return (int)launch<4>(values, m, idx, r, k, starts, window, tile_rows, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// gathers by one-hot MXU matmuls into a [R, K, 128] output.  Here one block
// takes one tile: it stages the window's window*C floats (at most
// 1024 * 4 * 4 = 16 KB) in shared memory with coalesced loads, then its
// threads write the tile's rows*K*C outputs, neighbouring threads on
// neighbouring addresses, each reading its slot's index (L1-cached, C
// threads share it) and one shared-memory value.  The ragged last tile is
// masked here, not padded.
//
// What bounds it on the H100: bytes.  Per call it reads idx (4 R K bytes)
// and each tile's window (4 window C, the values once when windows do not
// overlap) and writes the output (4 R K C); there is no arithmetic to speak
// of.  The design reads and writes each byte once, so it sits on the
// memory bound when enough tiles are in flight: ~150-400 blocks at the
// corridor graphs' shapes, one or three per SM.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int C>
__global__ void __launch_bounds__(THREADS)
    windowed_take_kernel(const float *__restrict__ values, int m,
                         const int *__restrict__ idx, int r, int k,
                         const int *__restrict__ starts, int window, int tile_rows,
                         float *__restrict__ out) {
  extern __shared__ float win[];  // [window, C]
  const int t = blockIdx.x;
  const int start = starts[t];
  const int n_win = window * C;
  const long long base = (long long)start * C;
  const long long limit = (long long)m * C;
  for (int i = threadIdx.x; i < n_win; i += THREADS) {
    const long long g = base + i;
    win[i] = (g >= 0 && g < limit) ? values[g] : 0.0f;
  }
  __syncthreads();
  const long long r0 = (long long)t * tile_rows;
  const int rows = (int)min((long long)tile_rows, (long long)r - r0);
  const int n_out = rows * k * C;
  const int *idx_t = idx + r0 * k;
  float *out_t = out + r0 * k * C;
  for (int o = threadIdx.x; o < n_out; o += THREADS) {
    const int slot = o / C;
    const int c = o - slot * C;
    const int j = idx_t[slot] - start;
    out_t[o] = (j >= 0 && j < window) ? win[j * C + c] : 0.0f;
  }
}

}  // namespace

extern "C" {

// values [m, c] f32, idx [r, k] i32, starts [ceil(r / tile_rows)] i32 (all on
// the device, contiguous), out [r, k, c] f32.  c in {2, 3, 4}.  Launches one
// block per row tile on `stream`; returns the launch's cudaError_t, 0 if it
// was accepted, and cudaErrorInvalidValue for a c it does not take.
int boslam_windowed_take(const float *values, int m, int c, const int *idx, int r, int k,
                         const int *starts, int window, int tile_rows, float *out,
                         void *stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_tiles = (r + tile_rows - 1) / tile_rows;
  if (n_tiles == 0) return 0;
  const size_t smem = (size_t)window * c * sizeof(float);
  switch (c) {
    case 2:
      windowed_take_kernel<2><<<n_tiles, THREADS, smem, stream>>>(values, m, idx, r, k, starts,
                                                                 window, tile_rows, out);
      break;
    case 3:
      windowed_take_kernel<3><<<n_tiles, THREADS, smem, stream>>>(values, m, idx, r, k, starts,
                                                                 window, tile_rows, out);
      break;
    case 4:
      windowed_take_kernel<4><<<n_tiles, THREADS, smem, stream>>>(values, m, idx, r, k, starts,
                                                                 window, tile_rows, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char *boslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

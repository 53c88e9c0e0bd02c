// One-sided row puts of the remote cold tier's row fetch, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel onesided_fetch_rows (body
// _fetch_rows_kernel) in src/repro/kernels/onesided_a2a.py.  There, rank r
// issues one remote DMA per embedding row: for i in 0..H-1, with the
// rotated destination dst = (r + i + 1) % H, and for each of the M
// requested rows, it copies contrib_r[dst, m] (one D-row) into
// out_dst[r, m], all puts started before any wait.  Here one launch is one
// rank's puts:
//
//     out_ptrs[dst][(my_id * M + m) * D + d] = src[(dst * M + m) * D + d]
//
// for every dst and m, where src is rank my_id's (H, M, D) contribution and
// out_ptrs is a device-side table of the H ranks' (H, M, D) exchange
// buffers.  The pointer table is what a kernel is handed across cards by
// symmetric memory (torch.distributed._symmetric_memory); on one card it
// holds H local buffers, so the same kernel serves both.
//
// Completion: the wrapper enqueues the H ranks' launches on one stream and
// then the sum over owners.  Stream order plays the role of the TPU
// kernel's semaphore waits: the sum starts after every put has landed.
//
// What bounds it: device-memory bytes.  A put reads one row and writes it
// once, with no arithmetic, so a launch moves 2 * H * M * D * itemsize
// bytes and the bound is that over the HBM rate.  The design keeps every
// access wide and coalesced:
//
//   * one warp per (i, m) put, eight puts per block, i the slower index,
//     so that the warps of a block follow the rotated schedule;
//   * the lanes cover the row with 16-byte vectors when the row's bytes are
//     a multiple of 16 and every pointer is 16-byte aligned (the wrapper
//     checks), one element per lane otherwise (D = 10);
//   * a put copies bits, so it is exact for every dtype; the dtype code
//     only sets the element size of the scalar path;
//   * addresses are formed in 64 bits throughout.
//
// It is the simple version: no TMA bulk copies, no batching of rows per
// warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// V is the unit a lane copies: uint4 (16 bytes) on the vector path, the
// element type's bits (uint32_t for f32, uint16_t for bf16) otherwise.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
put_rows_kernel(const V* __restrict__ src,
                const long long* __restrict__ out_ptrs,
                int my_id, int num_ranks, long long num_rows,
                long long row_units) {
  const int lane = threadIdx.x & 31;
  const long long put =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (put >= (long long)num_ranks * num_rows) return;
  const int i = (int)(put / num_rows);
  const long long m = put - (long long)i * num_rows;
  const int dst = (my_id + i + 1) % num_ranks;            // rotated schedule
  const V* row = src + ((long long)dst * num_rows + m) * row_units;
  V* out = reinterpret_cast<V*>(__ldg(out_ptrs + dst)) +
           ((long long)my_id * num_rows + m) * row_units;
  for (long long k = lane; k < row_units; k += 32) out[k] = row[k];
}

template <typename V>
int launch(const void* src, const long long* out_ptrs, int my_id,
           int num_ranks, long long num_rows, long long row_units,
           cudaStream_t stream) {
  const long long puts = (long long)num_ranks * num_rows;
  const long long blocks = (puts + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  put_rows_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const V*>(src), out_ptrs, my_id, num_ranks, num_rows,
      row_units);
  return (int)cudaGetLastError();
}

}  // namespace

// src: rank my_id's (H, M, D) contribution.  out_ptrs: (H,) int64 device
// table of the H exchange buffers, each (H, M, D) of the same dtype.
// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when D * itemsize is a multiple
// of 16 and src and every buffer are 16-byte aligned (the caller checks).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int onesided_put_rows(const void* src, const long long* out_ptrs,
                                 int my_id, int num_ranks, long long num_rows,
                                 long long dim, int dtype, int vec,
                                 void* stream) {
  if (num_ranks <= 0 || my_id < 0 || my_id >= num_ranks) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_rows == 0 || dim == 0) return 0;
  long long itemsize;
  switch (dtype) {
    case 0: itemsize = 4; break;
    case 1: itemsize = 2; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch<uint4>(src, out_ptrs, my_id, num_ranks, num_rows,
                         dim * itemsize / 16, s);
  }
  if (itemsize == 4) {
    return launch<uint32_t>(src, out_ptrs, my_id, num_ranks, num_rows, dim,
                            s);
  }
  return launch<uint16_t>(src, out_ptrs, my_id, num_ranks, num_rows, dim, s);
}

extern "C" const char* put_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

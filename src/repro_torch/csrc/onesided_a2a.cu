// One-sided chunk puts of the distributed embedding bag's all-to-all,
// reduce-scatter and ring permute, and of the remote cold tier's row fetch,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels onesided_all_to_all (body _a2a_kernel),
// onesided_ring_permute and onesided_fetch_rows (body _fetch_rows_kernel)
// in src/repro/kernels/onesided_a2a.py, and through the first also
// onesided_reduce_scatter (the all-to-all, then a local sum over sources
// outside the kernel).  There, rank r issues one remote DMA per
// destination: for i in 0..E-1, with the rotated destination
// d = (r + i + 1) % E, it copies its whole chunk x[d] into out_d[r], all
// puts started before any wait; the ring permute is one DMA of the whole
// block to rank (r + shift) % n.  The row fetch issues one DMA per row in
// the same rotated order, but rank r's M rows for requester d are
// contiguous in its contribution and in d's buffer, so here they are one
// chunk of M * D elements.  Here one launch is one rank's puts:
//
//     a2a:   out_ptrs[d][r * C + u] = src[d * C + u]
//     ring:  out_ptrs[(r + shift) % n][u] = src[u]
//
// for every destination d and unit u of a chunk of C units, where src is
// rank r's send buffer and out_ptrs a device-side table of the ranks'
// receive buffers.  The pointer table is what a kernel is handed across
// cards by symmetric memory (torch.distributed._symmetric_memory); on one
// card it holds E local buffers, so the same kernel serves both.
//
// Completion: the wrapper enqueues the E ranks' launches on one stream, and
// then whatever reads the receive buffers (the reduce-scatter's sum).
// Stream order plays the role of the TPU kernel's semaphore waits.
//
// What bounds it: device-memory bytes.  A put reads each byte of the chunk
// once and writes it once, with no arithmetic, so a launch moves
// 2 * E * C * unit bytes and the bound is that over the HBM rate.  The TPU
// kernel puts whole chunks, not rows, so the design is a chunk copy:
//
//   * the grid is (tiles of the chunk) x (destinations), blockIdx.y the
//     put i in the rotated schedule, so the blocks of one launch cover
//     every destination at once;
//   * each thread moves kUnroll units of its tile, neighbouring threads on
//     neighbouring units, all loads issued before the stores so that
//     kUnroll loads are in flight per thread;
//   * the unit is 16 bytes (uint4) when the chunk's bytes and every pointer
//     are 16-byte aligned (the wrapper checks), the element's width
//     otherwise: 4 bytes for int32 and f32, 2 for bf16;
//   * a put copies bits, so it is exact for every dtype; the dtype code
//     only sets the element width of the scalar path;
//   * addresses are formed in 64 bits throughout.
//
// It is the simple version: no TMA bulk copies, no persistent blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kTile = (long long)kThreads * kUnroll;

// V is the unit a thread copies.  Put i of this launch goes to rank
// (my_id + first + i) % num_ranks; its source is src + dst * src_step and
// its target out_ptrs[dst] + dst_offset, both in units.
template <typename V>
__global__ void __launch_bounds__(kThreads)
put_chunks_kernel(const V* __restrict__ src,
                  const long long* __restrict__ out_ptrs, int my_id,
                  int num_ranks, int first, long long chunk_units,
                  long long src_step, long long dst_offset) {
  const int dst = (my_id + first + (int)blockIdx.y) % num_ranks;
  const V* from = src + (long long)dst * src_step;
  V* to = reinterpret_cast<V*>(__ldg(out_ptrs + dst)) + dst_offset;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long u = base + (long long)k * kThreads;
    if (u < chunk_units) v[k] = from[u];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long u = base + (long long)k * kThreads;
    if (u < chunk_units) to[u] = v[k];
  }
}

template <typename V>
int launch(const void* src, const long long* out_ptrs, int my_id,
           int num_ranks, int first, int num_puts, long long chunk_units,
           long long src_step, long long dst_offset, cudaStream_t stream) {
  const long long tiles = (chunk_units + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)num_puts);
  put_chunks_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), out_ptrs, my_id, num_ranks, first,
      chunk_units, src_step, dst_offset);
  return (int)cudaGetLastError();
}

// Chooses the unit: 16 bytes when vec, else the element width of dtype
// (0 = int32, 1 = float32, 2 = bfloat16).  Counts are in elements.
int dispatch(const void* src, const long long* out_ptrs, int my_id,
             int num_ranks, int first, int num_puts, long long chunk,
             long long src_step, long long dst_offset, int dtype, int vec,
             void* stream) {
  if (num_ranks <= 0 || my_id < 0 || my_id >= num_ranks || first < 0 ||
      num_puts <= 0 || num_puts > num_ranks || num_puts > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  long long itemsize;
  switch (dtype) {
    case 0:
    case 1: itemsize = 4; break;
    case 2: itemsize = 2; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (chunk == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const long long per = 16 / itemsize;   // elements per 16-byte unit
    return launch<uint4>(src, out_ptrs, my_id, num_ranks, first, num_puts,
                         chunk / per, src_step / per, dst_offset / per, s);
  }
  if (itemsize == 4) {
    return launch<uint32_t>(src, out_ptrs, my_id, num_ranks, first,
                            num_puts, chunk, src_step, dst_offset, s);
  }
  return launch<uint16_t>(src, out_ptrs, my_id, num_ranks, first, num_puts,
                          chunk, src_step, dst_offset, s);
}

}  // namespace

// The all-to-all puts of rank my_id.  src: its (E, C) send buffer, chunk d
// for rank d.  out_ptrs: (E,) int64 device table of the E receive buffers,
// each (E, C) of the same dtype; chunk d lands in buffer d at row my_id.
// chunk: C in elements.  vec: 1 when C * itemsize is a multiple of 16 and
// src and every buffer are 16-byte aligned (the caller checks).  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int onesided_a2a_put(const void* src, const long long* out_ptrs,
                                int my_id, int num_ranks, long long chunk,
                                int dtype, int vec, void* stream) {
  if (my_id < 0 || my_id >= num_ranks) return (int)cudaErrorInvalidValue;
  return dispatch(src, out_ptrs, my_id, num_ranks, 1, num_ranks, chunk,
                  chunk, (long long)my_id * chunk, dtype, vec, stream);
}

// The ring put of rank my_id: its whole block of C elements lands in the
// receive buffer of rank (my_id + shift) % num_ranks; 0 <= shift.
extern "C" int onesided_ring_put(const void* src, const long long* out_ptrs,
                                 int my_id, int num_ranks, int shift,
                                 long long chunk, int dtype, int vec,
                                 void* stream) {
  if (num_ranks <= 0 || shift < 0) return (int)cudaErrorInvalidValue;
  return dispatch(src, out_ptrs, my_id, num_ranks, shift % num_ranks, 1,
                  chunk, 0, 0, dtype, vec, stream);
}

extern "C" const char* a2a_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

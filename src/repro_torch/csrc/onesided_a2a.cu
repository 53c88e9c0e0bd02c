// One-sided chunk exchanges of the distributed embedding bag's all-to-all,
// reduce-scatter and ring permute, and of the remote cold tier's row fetch,
// written for Hopper (sm_90a).  Two kernels:
//
//   * put_chunks_kernel replaces the Pallas TPU kernels onesided_all_to_all
//     (body _a2a_kernel), onesided_ring_permute and onesided_fetch_rows
//     (body _fetch_rows_kernel) in src/repro/kernels/onesided_a2a.py;
//   * sum_chunks_kernel replaces onesided_reduce_scatter there, the paper's
//     reduce-scatter workaround (NVSHMEM 2.9 had none, §4.4): the one-sided
//     all-to-all, then a local sum over sources.  Here the two steps are one
//     pass: each destination GETS its chunk from every source's send buffer
//     and sums it in registers, so the exchange buffer never exists.
//
// There, rank r issues one remote DMA per destination: for i in 0..E-1,
// with the rotated destination d = (r + i + 1) % E, it copies its whole
// chunk x[d] into out_d[r], all puts started before any wait; the ring
// permute is one DMA of the whole block to rank (r + shift) % n.  The row
// fetch issues one DMA per row in the same rotated order, but rank r's M
// rows for requester d are contiguous in its contribution and in d's
// buffer, so here they are one chunk of M * D elements.  Here:
//
//     puts:  out_ptrs[d][r * C + u] = src_r[d * C + u]
//     ring:  out_ptrs[(r + shift) % n][u] = src_r[u]
//     sum:   out[d][u] = sum over s of src_ptrs[s][d * C + u]
//
// for every source r, destination d and unit u of a chunk of C units.
// out_ptrs is a table of the ranks' receive buffers and src_ptrs one of
// their send buffers: what symmetric memory (torch.distributed.
// _symmetric_memory) hands a program across cards.  On one card the tables
// hold E local buffers, so the same kernels serve both.  A table goes to
// the kernel by value, among its parameters, up to kMaxRanks ranks: a
// table copied to the card on every call would sit on the stream before
// each launch, a sizeable part of a launch that moves tens of megabytes.
// One launch covers a range of ranks: sources first_src .. first_src +
// num_src - 1 for the puts, destinations first_dst .. first_dst + num_dst
// - 1 for the sum.  The stacked ranks of one card are the whole range
// (0, E); one rank per card would pass (r, 1).
//
// Completion: the wrapper enqueues the launch on one stream, and then
// whatever reads its output.  Stream order plays the role of the TPU
// kernel's semaphore waits.
//
// What bounds both: device-memory bytes, with no arithmetic worth the name.
//
//   * Puts read each byte of a chunk once and write it once: 2 * E * E * C
//     unit bytes for an all-to-all.  The grid is (tiles of a chunk) x (put
//     i in the rotated schedule) x (source rank), so ONE launch covers every
//     source's every put: at phase 1's int32 shape (4, 4, 212,992) that is
//     832 blocks of 256 threads, one wave, where one launch per source
//     would be four serial waves of 208 blocks.  The ring is the same grid
//     with one put per source: at (4, 13,312, 128) f32, 4 x 416 blocks in
//     one launch instead of four launches of 416.  Each thread moves
//     kUnroll units of its tile, neighbouring threads on neighbouring
//     units, all loads before the stores.
//   * The sum reads E * E * C units and writes E * C: at phase 3's f32
//     shape 136 MB, 1.33x the bytes of the all-to-all alone, where an
//     all-to-all and then a sum move 3.3x.  The grid is (tiles of a chunk)
//     x (destination); each thread issues the loads of four sources for
//     its one unit before the first add.  On the card that beat two units
//     a thread (more registers, fewer blocks in flight) and a grid-striding
//     wave of the blocks that fit, whose blocks finish unevenly.
//
// Both use 16-byte units (uint4) when the chunk's bytes and every pointer
// are 16-byte aligned (the wrapper checks), the element's width otherwise:
// 4 bytes for int32 and f32, 2 for bf16.  Addresses are formed in 64 bits.
//
// The sum's arithmetic is that of PyTorch's CUDA sum over an outer
// dimension (thread_reduce_impl in ATen/native/cuda/Reduce.cuh): four
// partial sums acc[s % 4] from +0.0, source s added in rank order, then
// ((acc0 + acc1) + acc2) + acc3.  So the reduce-scatter is bitwise-equal
// to x.sum(0), and to its plain version wherever that too sums over an
// outer dimension (a chunk of one element makes the sources contiguous
// there, and PyTorch then takes another order).  For E <= 4 it is the
// rank order from +0.0 (a -0.0 source adds nothing: no partial is ever
// -0.0).  f32
// and bf16 accumulate in f32, rounded once to the output type (bf16 by
// __float2bfloat16_rn); int32 in a 32-bit unsigned sum that wraps, the
// bits of any order's int32 sum.  No atomics: the result is the same in
// every run.
//
// It is the simple version: no TMA bulk copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kTile = (long long)kThreads * kUnroll;
constexpr int kParts = 4;       // the partial sums of PyTorch's reduction
// 4 KB of kernel parameters, which every CUDA version takes, hold this many
// addresses beside the other arguments
constexpr int kMaxRanks = 480;

struct RankPtrs {
  long long p[kMaxRanks];
};

// A host table of n addresses, by value.
RankPtrs rank_ptrs(const long long* table, int n) {
  RankPtrs t{};
  for (int i = 0; i < n; ++i) t.p[i] = table[i];
  return t;
}

// ---------------------------------------------------------------------------
// Puts
// ---------------------------------------------------------------------------

// V is the unit a thread copies.  Block (x, y, z) is source rank r =
// first_src + z, put y of its rotated schedule: destination (r + first_put
// + y) % num_ranks.  Its source is src + z * src_rank_step + dst *
// src_step, its target out_ptrs.p[dst] + r * dst_step, all in units.
template <typename V>
__global__ void __launch_bounds__(kThreads)
put_chunks_kernel(const V* __restrict__ src, const RankPtrs out_ptrs,
                  int num_ranks, int first_src, int first_put,
                  long long chunk_units, long long src_rank_step,
                  long long src_step, long long dst_step) {
  const int r = first_src + (int)blockIdx.z;
  const int dst = (r + first_put + (int)blockIdx.y) % num_ranks;
  const V* from = src + (long long)blockIdx.z * src_rank_step
      + (long long)dst * src_step;
  V* to = reinterpret_cast<V*>(out_ptrs.p[dst]) + (long long)r * dst_step;
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
int launch_puts(const void* src, const RankPtrs& out_ptrs, int num_ranks,
                int first_src, int num_src, int first_put, int num_puts,
                long long chunk_units, long long src_rank_step,
                long long src_step, long long dst_step,
                cudaStream_t stream) {
  const long long tiles = (chunk_units + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)num_puts, (unsigned)num_src);
  put_chunks_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), out_ptrs, num_ranks, first_src, first_put,
      chunk_units, src_rank_step, src_step, dst_step);
  return (int)cudaGetLastError();
}

// The element width of dtype (0 = int32, 1 = float32, 2 = bfloat16), or 0
// for an unknown code.
int itemsize_of(int dtype) {
  switch (dtype) {
    case 0:
    case 1: return 4;
    case 2: return 2;
    default: return 0;
  }
}

// Chooses the unit: 16 bytes when vec, else the element width of dtype.
// Counts and steps are in elements.
int dispatch_puts(const void* src, const long long* table, int num_ranks,
                  int first_src, int num_src, int first_put, int num_puts,
                  long long chunk, long long src_rank_step,
                  long long src_step, long long dst_step, int dtype, int vec,
                  void* stream) {
  if (num_ranks <= 0 || num_ranks > kMaxRanks || first_src < 0 ||
      first_src >= num_ranks || num_src <= 0 ||
      num_src > num_ranks - first_src || first_put < 0 ||
      first_put >= num_ranks || num_puts <= 0 || num_puts > num_ranks) {
    return (int)cudaErrorInvalidValue;
  }
  const long long itemsize = itemsize_of(dtype);
  if (itemsize == 0) return (int)cudaErrorInvalidValue;
  if (chunk == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RankPtrs out_ptrs = rank_ptrs(table, num_ranks);
  if (vec) {
    const long long per = 16 / itemsize;   // elements per 16-byte unit
    return launch_puts<uint4>(src, out_ptrs, num_ranks, first_src, num_src,
                              first_put, num_puts, chunk / per,
                              src_rank_step / per, src_step / per,
                              dst_step / per, s);
  }
  if (itemsize == 4) {
    return launch_puts<uint32_t>(src, out_ptrs, num_ranks, first_src,
                                 num_src, first_put, num_puts, chunk,
                                 src_rank_step, src_step, dst_step, s);
  }
  return launch_puts<uint16_t>(src, out_ptrs, num_ranks, first_src, num_src,
                               first_put, num_puts, chunk, src_rank_step,
                               src_step, dst_step, s);
}

// ---------------------------------------------------------------------------
// Pull-sum
// ---------------------------------------------------------------------------

// The accumulator of each dtype code, and the conversions of one element's
// bits to it and back.
template <int kDtype> struct Elem;
template <> struct Elem<0> {                 // int32: wraps modulo 2**32
  using Acc = uint32_t;
  static constexpr int kBytes = 4;
  static __device__ __forceinline__ Acc zero() { return 0u; }
  static __device__ __forceinline__ Acc load(uint32_t b) { return b; }
  static __device__ __forceinline__ uint32_t store(Acc a) { return a; }
};
template <> struct Elem<1> {                 // float32
  using Acc = float;
  static constexpr int kBytes = 4;
  static __device__ __forceinline__ Acc zero() { return 0.0f; }
  static __device__ __forceinline__ Acc load(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ uint32_t store(Acc a) {
    return __float_as_uint(a);
  }
};
template <> struct Elem<2> {                 // bfloat16, summed in f32
  using Acc = float;
  static constexpr int kBytes = 2;
  static __device__ __forceinline__ Acc zero() { return 0.0f; }
  static __device__ __forceinline__ Acc load(uint32_t b) {
    return __uint_as_float(b << 16);         // exact
  }
  static __device__ __forceinline__ uint32_t store(Acc a) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(a));
  }
};

// The 32-bit words of a unit (a 2-byte unit is one word's low half), and a
// unit packed back from its words.
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t word(uint16_t v, int) { return v; }
template <typename V> __device__ __forceinline__ V pack(const uint32_t* w);
template <> __device__ __forceinline__ uint4 pack<uint4>(const uint32_t* w) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <> __device__ __forceinline__ uint32_t pack<uint32_t>(
    const uint32_t* w) {
  return w[0];
}
template <> __device__ __forceinline__ uint16_t pack<uint16_t>(
    const uint32_t* w) {
  return (uint16_t)w[0];
}

// Element i of a unit, as bits.
template <int kBytes, typename V>
__device__ __forceinline__ uint32_t element(const V& v, int i) {
  if constexpr (kBytes == 4) {
    return word(v, i);
  } else {
    return (word(v, i >> 1) >> ((i & 1) * 16)) & 0xffffu;
  }
}

// Unit u of the sources s0 .. s0 + kParts - 1 that exist, at offset off of
// each send buffer; the others read as zero bits.
template <typename V>
__device__ __forceinline__ void load_group(V (&v)[kParts],
                                           const RankPtrs& src_ptrs, int s0,
                                           int num_src, long long off) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    v[p] = s0 + p < num_src
        ? reinterpret_cast<const V*>(src_ptrs.p[s0 + p])[off]
        : V{};
  }
}

// Block (x, y) sums tile x of destination first_dst + y: out[y][u] = sum
// over s of src_ptrs.p[s][(first_dst + y) * C + u], one unit a thread.
template <typename V, int kDtype>
__global__ void __launch_bounds__(kThreads)
sum_chunks_kernel(const RankPtrs src_ptrs, V* __restrict__ out,
                  int num_src, int first_dst, long long chunk_units) {
  using El = Elem<kDtype>;
  using Acc = typename El::Acc;
  constexpr int N = (int)sizeof(V) / El::kBytes;   // elements per unit
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= chunk_units) return;
  const long long off = (long long)(first_dst + (int)blockIdx.y)
      * chunk_units + u;
  V v[kParts];
  Acc acc[kParts][N];
  load_group(v, src_ptrs, 0, num_src, off);
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[p][i] = El::zero() + El::load(element<El::kBytes>(v[p], i));
  for (int s0 = kParts; s0 < num_src; s0 += kParts) {
    load_group(v, src_ptrs, s0, num_src, off);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      if (s0 + p < num_src) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          acc[p][i] += El::load(element<El::kBytes>(v[p], i));
      }
    }
  }
  uint32_t w[(sizeof(V) + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    Acc r = acc[0][i];
#pragma unroll
    for (int p = 1; p < kParts; ++p) r = r + acc[p][i];
    const uint32_t bits = El::store(r);
    if constexpr (El::kBytes == 4) {
      w[i] = bits;
    } else {
      w[i >> 1] |= bits << ((i & 1) * 16);
    }
  }
  out[(long long)blockIdx.y * chunk_units + u] = pack<V>(w);
}

template <typename V, int kDtype>
int launch_sum(const RankPtrs& src_ptrs, void* out, int num_src,
               int first_dst, int num_dst, long long chunk_units,
               cudaStream_t stream) {
  const long long tiles = (chunk_units + kThreads - 1) / kThreads;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)num_dst);
  sum_chunks_kernel<V, kDtype><<<grid, kThreads, 0, stream>>>(
      src_ptrs, static_cast<V*>(out), num_src, first_dst, chunk_units);
  return (int)cudaGetLastError();
}

template <int kDtype>
int dispatch_sum(const RankPtrs& src_ptrs, void* out, int num_src,
                 int first_dst, int num_dst, long long chunk, int vec,
                 cudaStream_t s) {
  if (vec) {
    const long long per = 16 / Elem<kDtype>::kBytes;
    return launch_sum<uint4, kDtype>(src_ptrs, out, num_src, first_dst,
                                     num_dst, chunk / per, s);
  }
  using Scalar = typename std::conditional<Elem<kDtype>::kBytes == 4,
                                           uint32_t, uint16_t>::type;
  return launch_sum<Scalar, kDtype>(src_ptrs, out, num_src, first_dst,
                                    num_dst, chunk, s);
}

}  // namespace

// The all-to-all puts of ranks first_src .. first_src + num_src - 1, one
// launch.  src: rank first_src's (E, C) send buffer, chunk d for rank d;
// rank first_src + j's lies j * E * C elements further (the stacked ranks
// of one card).  out_ptrs: the host table of the E <= kMaxRanks receive
// buffers' addresses, each buffer (E, C) of the same dtype; chunk d of
// rank r lands in buffer d at row r.  chunk: C in elements.  vec: 1 when
// C * itemsize is a multiple of 16 and src and every buffer are 16-byte
// aligned (the caller checks).  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int onesided_a2a_put(const void* src, const long long* out_ptrs,
                                int first_src, int num_src, int num_ranks,
                                long long chunk, int dtype, int vec,
                                void* stream) {
  if (num_ranks <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_puts(src, out_ptrs, num_ranks, first_src, num_src,
                       1 % num_ranks, num_ranks, chunk,
                       (long long)num_ranks * chunk, chunk, chunk, dtype,
                       vec, stream);
}

// The ring puts of ranks first_src .. first_src + num_src - 1, one launch:
// rank r's whole block of C elements lands in the receive buffer of rank
// (r + shift) % num_ranks; 0 <= shift.  src: rank first_src's block; rank
// first_src + j's lies j * C elements further (the stacked ranks of one
// card).  out_ptrs: the host table of the receive buffers' addresses.
extern "C" int onesided_ring_put(const void* src, const long long* out_ptrs,
                                 int first_src, int num_src, int num_ranks,
                                 int shift, long long chunk, int dtype,
                                 int vec, void* stream) {
  if (num_ranks <= 0 || shift < 0) return (int)cudaErrorInvalidValue;
  return dispatch_puts(src, out_ptrs, num_ranks, first_src, num_src,
                       shift % num_ranks, 1, chunk, chunk, 0, 0, dtype, vec,
                       stream);
}

// The reduce-scatter of destinations first_dst .. first_dst + num_dst - 1,
// one launch: out[j][u] = sum over s < num_src of src_ptrs[s][(first_dst +
// j) * C + u].  src_ptrs: the host table of the E <= kMaxRanks send
// buffers' addresses, each buffer (E, C).  out: (num_dst, C) of the same
// dtype.  vec as for the puts, for the send buffers and out.  Returns the
// cudaError_t of the launch.
extern "C" int onesided_rs_pull(const long long* src_ptrs, void* out,
                                int num_ranks, int first_dst, int num_dst,
                                long long chunk, int dtype, int vec,
                                void* stream) {
  if (num_ranks <= 0 || num_ranks > kMaxRanks || first_dst < 0 ||
      first_dst >= num_ranks || num_dst <= 0 ||
      num_dst > num_ranks - first_dst) {
    return (int)cudaErrorInvalidValue;
  }
  if (itemsize_of(dtype) == 0) return (int)cudaErrorInvalidValue;
  if (chunk == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RankPtrs ptrs = rank_ptrs(src_ptrs, num_ranks);
  switch (dtype) {
    case 0: return dispatch_sum<0>(ptrs, out, num_ranks, first_dst, num_dst,
                                   chunk, vec, s);
    case 1: return dispatch_sum<1>(ptrs, out, num_ranks, first_dst, num_dst,
                                   chunk, vec, s);
    default: return dispatch_sum<2>(ptrs, out, num_ranks, first_dst,
                                    num_dst, chunk, vec, s);
  }
}

extern "C" const char* a2a_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

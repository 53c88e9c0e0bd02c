// One-sided chunk exchanges of the distributed embedding bag's all-to-all,
// reduce-scatter and ring permute, and of the remote cold tier's row fetch,
// written for Hopper (sm_90a).  Three kernels:
//
//   * put_chunks_kernel replaces the Pallas TPU kernels onesided_all_to_all
//     (body _a2a_kernel), onesided_ring_permute and onesided_fetch_rows
//     (body _fetch_rows_kernel) in src/repro/kernels/onesided_a2a.py;
//   * sum_chunks_kernel replaces onesided_reduce_scatter there, the paper's
//     reduce-scatter workaround (NVSHMEM 2.9 had none, §4.4): the one-sided
//     all-to-all, then a local sum over sources.  Here the two steps are one
//     pass: each destination GETS its chunk from every source's send buffer
//     and sums it in registers, so the exchange buffer never exists;
//   * signal_copy_kernel replaces the DMA semaphores' waits of those TPU
//     kernels (send_sem/recv_sem, c.wait() at :53, :112, :158) when each
//     rank is a process: a wait on signals, a copy, and signals to peers.
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
// Completion, two ways:
//
//   * the stacked ranks of one card (one process): the wrapper enqueues
//     the launch on one stream, and then whatever reads its output.
//     Stream order plays the role of the TPU kernel's semaphore waits; the
//     launches pass no signals (epoch 0) and none of the code below runs;
//   * one rank per process: an exchange finishes on the device, through
//     signals the ranks store into each other's symmetric memory, as
//     NVSHMEM's put-with-signal and signal-wait do, or the full/empty
//     barriers of a TMA ring stretched across ranks.  Every buffer has a
//     pad of uint64 words after its bytes: SIGNAL[s] ("full": source s's
//     put landed here, or s's send buffer holds the epoch), ACK[d]
//     ("empty": rank d finished reading what the last exchange left for it)
//     and COUNT (this rank's block counters).  Each exchange of a buffer
//     carries an epoch e, 1, 2, ... kept in lockstep by every rank's host.
//     A put into rank d first waits until ACK[d] of its own pad reaches
//     e - 1, then stores; every block fences its stores at system scope
//     and counts itself on COUNT[d], and the block that completes d's
//     chunk stores e with release semantics into SIGNAL[r] of d's pad.
//     The receiver's signal_copy_kernel waits (acquire) until the sources'
//     SIGNAL reach e, copies its buffer into a fresh output and stores e
//     into ACK[r] of every rank's pad.  The pull-sum's staging
//     (signal_copy_kernel: wait for every ACK >= e - 1, copy x in,
//     SIGNAL[r] = e everywhere) and the pull (wait for every SIGNAL >= e,
//     sum, ACK[r] = e everywhere) are the same pattern.  The counters only rise; the host passes the count each
//     launch ends at.  One thread of a block spins, with __nanosleep
//     backoff, while the others wait at the block's barrier; every spin is
//     bounded by %globaltimer, and a spin that runs out writes the rank,
//     the slot and the epoch into a host-mapped record and traps, so a
//     lost signal fails the run instead of hanging it.
//
// What bounds both: device-memory bytes, with no arithmetic worth the name.
// (signal_copy_kernel too: its copy moves a buffer's bytes once each way,
// and a wait or a signal alone is a handful of words.)
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
// bits of any order's int32 sum.  No atomics in the sum (one rank per
// process counts blocks with one): the result is the same in every run.
//
// It is the simple version: no TMA bulk copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kTile = (long long)kThreads * kUnroll;
constexpr int kParts = 4;       // the partial sums of PyTorch's reduction
// The ranks a launch takes.  4 KB of kernel parameters, which every CUDA
// version takes, would hold 480 addresses beside the other arguments; the
// pull-sum's order is x.sum(0)'s only up to 63 ranks: from 64 sources
// PyTorch's sum over an outer dimension of rows it reads 4 elements at a
// time splits the sources across 4 threads of a block (setReduceConfig in
// ATen/native/cuda/Reduce.cuh), another order than the four partials here
// (on an H100, f32, rows of 4-element multiples: equal up to 63, not from
// 64; chip_smoke.py phase 7 and tests/test_torch_chunks_card.py hold 63)
constexpr int kMaxRanks = 63;

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
// Signals (one rank per process)
// ---------------------------------------------------------------------------

// A pad's regions, in uint64 words from its start, for a world of E ranks:
// SIGNAL [0, E), ACK [E, 2E), COUNT [2E, 3E + 1) (COUNT[d] counts this
// rank's put blocks into rank d, COUNT[E] its own copies and pulls).
constexpr int kSignalRegion = 0;
constexpr int kAckRegion = 1;               // times E
constexpr int kCountRegion = 2;             // times E
// the timeout record, in the host-mapped words: [0] kTimedOut once written,
// then rank, region, slot, epoch waited for, epoch seen, bound (ns), world
constexpr unsigned long long kTimedOut = 0x5349474e414c54ULL;   // "SIGNALT"
constexpr int kRecordWords = 8;
constexpr unsigned kMaxBackoffNs = 1024;
constexpr int kMaxDevices = 64;

// What a launch of one rank per process needs to wait and to signal;
// epoch 0 (the stacked ranks of one card) turns both off.  target[i] is
// COUNT[i] once this launch's blocks have all counted themselves.
struct Sync {
  unsigned long long target[kMaxRanks + 1];
  unsigned long long epoch;
  unsigned long long* record;   // the process's host-mapped timeout record
  unsigned long long* claim;    // its device word: the first timeout writes
  long long pad_off;            // bytes from a buffer's base to its pad
  long long timeout_ns;
  int rank;
  int world;
};

unsigned long long* g_record_host = nullptr;
unsigned long long* g_record_dev = nullptr;
unsigned long long* g_claim[kMaxDevices] = {};

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long* pad_of(long long base,
                                                      long long pad_off) {
  return reinterpret_cast<unsigned long long*>(base + pad_off);
}

// A spin ran out: the first such thread of the process writes the record
// and traps (which ends every kernel of the context); any other waits for
// that trap.  Scalars, not the Sync: a reference to the kernel's Sync
// would copy it to every thread's stack.
__device__ __noinline__ void timed_out(unsigned long long* record,
                                       unsigned long long* claim, int rank,
                                       int world, long long timeout_ns,
                                       int region, int slot,
                                       unsigned long long want,
                                       unsigned long long seen) {
  if (claim == nullptr || atomicCAS(claim, 0ULL, 1ULL) == 0ULL) {
    if (record != nullptr) {
      volatile unsigned long long* rec = record;
      rec[1] = (unsigned long long)rank;
      rec[2] = (unsigned long long)region;
      rec[3] = (unsigned long long)slot;
      rec[4] = want;
      rec[5] = seen;
      rec[6] = (unsigned long long)timeout_ns;
      rec[7] = (unsigned long long)world;
      __threadfence_system();
      rec[0] = kTimedOut;
      __threadfence_system();
    }
    __trap();
  }
  for (;;) __nanosleep(1u << 20);
}

// One thread: until each slot i in mask of region (kSignalRegion or
// kAckRegion) of pad reads at least want, acquire loads at system scope
// with __nanosleep backoff, each slot's spin bounded by s.timeout_ns.
__device__ __forceinline__ void wait_slots(const Sync& s,
                                           const unsigned long long* pad,
                           int region, unsigned long long mask,
                           unsigned long long want) {
  const unsigned long long* words = pad + region * s.world;
  while (mask) {
    const int i = __ffsll((long long)mask) - 1;
    mask &= mask - 1;
    unsigned long long seen = ld_acquire_sys(words + i);
    if (seen >= want) continue;
    const unsigned long long t0 = global_timer();
    unsigned ns = 32;
    for (;;) {
      __nanosleep(ns);
      if (ns < kMaxBackoffNs) ns <<= 1;
      seen = ld_acquire_sys(words + i);
      if (seen >= want) break;
      if ((long long)(global_timer() - t0) > s.timeout_ns) {
        timed_out(s.record, s.claim, s.rank, s.world, s.timeout_ns, region,
                  i, want, seen);
      }
    }
  }
}

// The whole block waits while its thread 0 spins (wait_slots).  Call with
// a condition uniform over the block.
__device__ __forceinline__ void block_wait(const Sync& s,
                                           const unsigned long long* pad,
                                           int region,
                                           unsigned long long mask,
                                           unsigned long long want) {
  if (threadIdx.x == 0) wait_slots(s, pad, region, mask, want);
  __syncthreads();
}

// After this block's stores: the block's barrier, then its thread 0
// fences them at system scope (cumulative over the stores the barrier
// ordered before it, as cooperative groups' grid sync relies on: one
// fence a block, not one a thread) and counts the block on COUNT[slot] of
// own; the block that brings it to s.target[slot] stores s.epoch with
// release semantics into word `word` of the pad of every buffer
// bufs.p[i], i in mask.  Call with a condition uniform over the block.
__device__ __forceinline__ void block_signal(const Sync& s,
                                             unsigned long long* own,
                                             int slot, const RankPtrs& bufs,
                                             unsigned long long mask,
                                             int word) {
  __syncthreads();
  if (threadIdx.x != 0) return;
  __threadfence_system();
  unsigned long long* count = own + kCountRegion * s.world + slot;
  if (atomicAdd_system(count, 1ULL) + 1ULL != s.target[slot]) return;
  __threadfence_system();
  while (mask) {
    const int i = __ffsll((long long)mask) - 1;
    mask &= mask - 1;
    st_release_sys(pad_of(bufs.p[i], s.pad_off) + word, s.epoch);
  }
}

// A launch's signals as the host hands them over: null counts (the
// stacked ranks of one card) for none; else the rank, the buffer's COUNT
// words as the host keeps them (updated here), this exchange's epoch, the
// pad's offset and the spins' bound.
struct Signals {
  unsigned long long* counts;
  unsigned long long epoch;
  long long pad_off;
  long long timeout_ns;
  int rank;
};

// The Sync of a launch over a world of ranks: epoch 0 and nothing else
// without counts (the stacked ranks of one card); else the current
// device's timeout record and claim word, and target[i] = counts[i] +
// tiles for each COUNT slot i in slots, counts updated to match.
Sync make_sync(const Signals& sig, int world, unsigned long long slots,
               long long tiles) {
  Sync s{};
  unsigned long long* counts = sig.counts;
  if (counts == nullptr || sig.epoch == 0) return s;
  s.epoch = sig.epoch;
  s.pad_off = sig.pad_off;
  s.timeout_ns = sig.timeout_ns;
  s.rank = sig.rank;
  s.world = world;
  s.record = g_record_dev;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices) {
    s.claim = g_claim[dev];
  }
  for (int i = 0; i <= world; ++i) {
    if ((slots >> i) & 1ULL) counts[i] += (unsigned long long)tiles;
    s.target[i] = counts[i];
  }
  return s;
}

// The set of ranks 0 .. n - 1, bit i rank i.
__host__ __device__ __forceinline__ unsigned long long all_ranks(int n) {
  return n >= 64 ? ~0ULL : (1ULL << n) - 1ULL;
}

// ---------------------------------------------------------------------------
// Puts
// ---------------------------------------------------------------------------

// V is the unit a thread copies.  Block (x, y, z) is source rank r =
// first_src + z, put y of its rotated schedule: destination (r + first_put
// + y) % num_ranks.  Its source is src + z * src_rank_step + dst *
// src_step, its target out_ptrs.p[dst] + r * dst_step, all in units.
// With sync.epoch e (one rank per process: r = sync.rank, one source):
// first wait until ACK[dst] of r's pad reaches e - 1 (dst has read the
// last exchange's), and after the stores signal e into SIGNAL[r] of dst's
// pad.
template <typename V>
__global__ void __launch_bounds__(kThreads)
put_chunks_kernel(const V* __restrict__ src, const RankPtrs out_ptrs,
                  int num_ranks, int first_src, int first_put,
                  long long chunk_units, long long src_rank_step,
                  long long src_step, long long dst_step, const Sync sync) {
  const int r = first_src + (int)blockIdx.z;
  const int dst = (r + first_put + (int)blockIdx.y) % num_ranks;
  unsigned long long* own = sync.epoch
      ? pad_of(out_ptrs.p[sync.rank], sync.pad_off) : nullptr;
  if (sync.epoch > 1) {
    block_wait(sync, own, kAckRegion, 1ULL << dst, sync.epoch - 1);
  }
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
  if (sync.epoch) {
    block_signal(sync, own, dst, out_ptrs, 1ULL << dst, kSignalRegion + r);
  }
}


template <typename V>
int launch_puts(const void* src, const RankPtrs& out_ptrs, int num_ranks,
                int first_src, int num_src, int first_put, int num_puts,
                long long chunk_units, long long src_rank_step,
                long long src_step, long long dst_step,
                const Signals& sig, cudaStream_t stream) {
  const long long tiles = (chunk_units + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  unsigned long long dsts = 0;
  for (int y = 0; y < num_puts; ++y) {
    dsts |= 1ULL << ((first_src + first_put + y) % num_ranks);
  }
  const Sync sync = make_sync(sig, num_ranks, dsts, tiles);
  const dim3 grid((unsigned)tiles, (unsigned)num_puts, (unsigned)num_src);
  put_chunks_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), out_ptrs, num_ranks, first_src, first_put,
      chunk_units, src_rank_step, src_step, dst_step, sync);
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
                  const Signals& sig, void* stream) {
  if (num_ranks <= 0 || num_ranks > kMaxRanks || first_src < 0 ||
      first_src >= num_ranks || num_src <= 0 ||
      num_src > num_ranks - first_src || first_put < 0 ||
      first_put >= num_ranks || num_puts <= 0 || num_puts > num_ranks ||
      (sig.counts != nullptr && num_src != 1)) {
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
                              dst_step / per, sig, s);
  }
  if (itemsize == 4) {
    return launch_puts<uint32_t>(src, out_ptrs, num_ranks, first_src,
                                 num_src, first_put, num_puts, chunk,
                                 src_rank_step, src_step, dst_step, sig,
                                 s);
  }
  return launch_puts<uint16_t>(src, out_ptrs, num_ranks, first_src, num_src,
                               first_put, num_puts, chunk, src_rank_step,
                               src_step, dst_step, sig, s);
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

// Unit u of destination first_dst + blockIdx.y, summed over the sources.
template <typename V, int kDtype>
__device__ __forceinline__ void sum_unit(const RankPtrs& src_ptrs, V* out,
                                         int num_src, int first_dst,
                                         long long chunk_units, long long u) {
  using El = Elem<kDtype>;
  using Acc = typename El::Acc;
  constexpr int N = (int)sizeof(V) / El::kBytes;   // elements per unit
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

// Block (x, y) sums tile x of destination first_dst + y: out[y][u] = sum
// over s of src_ptrs.p[s][(first_dst + y) * C + u], one unit a thread.
// With sync.epoch e (one rank per process, sync.rank the rank; one
// destination, the rank's chunk or the whole buffer): first wait until
// every source's SIGNAL in the rank's pad reaches e (its send buffer holds
// e's data), and after the sum store e into ACK[rank] of every source's
// pad (the rank has pulled e).
template <typename V, int kDtype>
__global__ void __launch_bounds__(kThreads)
sum_chunks_kernel(const RankPtrs src_ptrs, V* __restrict__ out,
                  int num_src, int first_dst, long long chunk_units,
                  const Sync sync) {
  unsigned long long* own = sync.epoch
      ? pad_of(src_ptrs.p[sync.rank], sync.pad_off) : nullptr;
  if (sync.epoch) {
    block_wait(sync, own, kSignalRegion, all_ranks(num_src), sync.epoch);
  }
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u < chunk_units) sum_unit<V, kDtype>(src_ptrs, out, num_src,
                                           first_dst, chunk_units, u);
  if (sync.epoch) {
    block_signal(sync, own, num_src, src_ptrs, all_ranks(num_src),
                 kAckRegion * num_src + sync.rank);
  }
}

template <typename V, int kDtype>
int launch_sum(const RankPtrs& src_ptrs, void* out, int num_src,
               int first_dst, int num_dst, long long chunk_units,
               const Signals& sig, cudaStream_t stream) {
  const long long tiles = (chunk_units + kThreads - 1) / kThreads;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Sync sync = make_sync(sig, num_src, 1ULL << num_src, tiles);
  const dim3 grid((unsigned)tiles, (unsigned)num_dst);
  sum_chunks_kernel<V, kDtype><<<grid, kThreads, 0, stream>>>(
      src_ptrs, static_cast<V*>(out), num_src, first_dst, chunk_units,
      sync);
  return (int)cudaGetLastError();
}

template <int kDtype>
int dispatch_sum(const RankPtrs& src_ptrs, void* out, int num_src,
                 int first_dst, int num_dst, long long chunk, int vec,
                 const Signals& sig, cudaStream_t s) {
  if (vec) {
    const long long per = 16 / Elem<kDtype>::kBytes;
    return launch_sum<uint4, kDtype>(src_ptrs, out, num_src, first_dst,
                                     num_dst, chunk / per, sig, s);
  }
  using Scalar = typename std::conditional<Elem<kDtype>::kBytes == 4,
                                           uint32_t, uint16_t>::type;
  return launch_sum<Scalar, kDtype>(src_ptrs, out, num_src, first_dst,
                                    num_dst, chunk, sig, s);
}


// ---------------------------------------------------------------------------
// Waits, copies and signals (one rank per process)
// ---------------------------------------------------------------------------

// Rank sync.rank of sync.world; bufs the table of the buffers whose pads
// hold the signals (the rank's own at [sync.rank]).  Every block first
// waits until slot i of wait_region (kSignalRegion or kAckRegion) of the
// rank's pad reaches wait_epoch, for each i in wait_mask; then copies its
// tile of the units units of src into dst; then counts itself on
// COUNT[world], and the last block stores sync.epoch into slot sync.rank
// of sig_region of the pad of every buffer i in sig_mask.  src may be the
// rank's receive buffer, written by the peers: plain loads, after the
// acquire.  A launch of no units is one block: a wait, a signal, or both.
template <typename V>
__global__ void __launch_bounds__(kThreads)
signal_copy_kernel(const V* src, V* dst, long long units, const RankPtrs bufs,
                   const Sync sync, unsigned long long wait_mask,
                   int wait_region, unsigned long long wait_epoch,
                   unsigned long long sig_mask, int sig_region) {
  unsigned long long* own = pad_of(bufs.p[sync.rank], sync.pad_off);
  if (wait_mask != 0 && wait_epoch != 0) {
    block_wait(sync, own, wait_region, wait_mask, wait_epoch);
  }
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long u = base + (long long)k * kThreads;
    if (u < units) v[k] = src[u];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long u = base + (long long)k * kThreads;
    if (u < units) dst[u] = v[k];
  }
  if (sig_mask != 0) {
    block_signal(sync, own, sync.world, bufs, sig_mask,
                 sig_region * sync.world + sync.rank);
  }
}

template <typename V>
int launch_signal_copy(const void* src, void* dst, long long units,
                       const RankPtrs& bufs, const Signals& sig, int world,
                       unsigned long long wait_mask, int wait_region,
                       unsigned long long wait_epoch,
                       unsigned long long sig_mask, int sig_region,
                       cudaStream_t stream) {
  long long tiles = (units + kTile - 1) / kTile;
  if (tiles < 1) tiles = 1;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Sync sync = make_sync(sig, world, sig_mask ? 1ULL << world : 0ULL,
                              tiles);
  signal_copy_kernel<V><<<(unsigned)tiles, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), units, bufs, sync,
      wait_mask, wait_region, wait_epoch, sig_mask, sig_region);
  return (int)cudaGetLastError();
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
//
// One rank per process (num_src 1, first_src the rank): counts, the
// buffer's COUNT words as the host keeps them (null for the stacked ranks
// of one card: no signals), epoch the exchange's, pad_off the bytes from
// each buffer's base to its pad, timeout_ns the bound of each spin.  The
// same for the ring and the pull-sum below.
extern "C" int onesided_a2a_put(const void* src, const long long* out_ptrs,
                                int first_src, int num_src, int num_ranks,
                                long long chunk, int dtype, int vec,
                                unsigned long long* counts,
                                unsigned long long epoch, long long pad_off,
                                long long timeout_ns, void* stream) {
  if (num_ranks <= 0) return (int)cudaErrorInvalidValue;
  const Signals sig{counts, epoch, pad_off, timeout_ns, first_src};
  return dispatch_puts(src, out_ptrs, num_ranks, first_src, num_src,
                       1 % num_ranks, num_ranks, chunk,
                       (long long)num_ranks * chunk, chunk, chunk, dtype,
                       vec, sig, stream);
}

// The ring puts of ranks first_src .. first_src + num_src - 1, one launch:
// rank r's whole block of C elements lands in the receive buffer of rank
// (r + shift) % num_ranks; 0 <= shift.  src: rank first_src's block; rank
// first_src + j's lies j * C elements further (the stacked ranks of one
// card).  out_ptrs: the host table of the receive buffers' addresses.
extern "C" int onesided_ring_put(const void* src, const long long* out_ptrs,
                                 int first_src, int num_src, int num_ranks,
                                 int shift, long long chunk, int dtype,
                                 int vec, unsigned long long* counts,
                                 unsigned long long epoch, long long pad_off,
                                 long long timeout_ns, void* stream) {
  if (num_ranks <= 0 || shift < 0) return (int)cudaErrorInvalidValue;
  const Signals sig{counts, epoch, pad_off, timeout_ns, first_src};
  return dispatch_puts(src, out_ptrs, num_ranks, first_src, num_src,
                       shift % num_ranks, 1, chunk, chunk, 0, 0, dtype, vec,
                       sig, stream);
}

// The reduce-scatter of destinations first_dst .. first_dst + num_dst - 1,
// one launch: out[j][u] = sum over s < num_src of src_ptrs[s][(first_dst +
// j) * C + u].  src_ptrs: the host table of the E <= kMaxRanks send
// buffers' addresses, each buffer (E, C).  out: (num_dst, C) of the same
// dtype.  vec as for the puts, for the send buffers and out.  Returns the
// cudaError_t of the launch.  One rank per process: rank, and the signals
// as for the puts (num_dst 1).
extern "C" int onesided_rs_pull(const long long* src_ptrs, void* out,
                                int num_ranks, int first_dst, int num_dst,
                                long long chunk, int dtype, int vec,
                                int rank, unsigned long long* counts,
                                unsigned long long epoch, long long pad_off,
                                long long timeout_ns, void* stream) {
  if (num_ranks <= 0 || num_ranks > kMaxRanks || first_dst < 0 ||
      first_dst >= num_ranks || num_dst <= 0 ||
      num_dst > num_ranks - first_dst ||
      (counts != nullptr && (num_dst != 1 || rank < 0 ||
                             rank >= num_ranks))) {
    return (int)cudaErrorInvalidValue;
  }
  if (itemsize_of(dtype) == 0) return (int)cudaErrorInvalidValue;
  if (chunk == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RankPtrs ptrs = rank_ptrs(src_ptrs, num_ranks);
  const Signals sig{counts, epoch, pad_off, timeout_ns, rank};
  switch (dtype) {
    case 0: return dispatch_sum<0>(ptrs, out, num_ranks, first_dst, num_dst,
                                   chunk, vec, sig, s);
    case 1: return dispatch_sum<1>(ptrs, out, num_ranks, first_dst, num_dst,
                                   chunk, vec, sig, s);
    default: return dispatch_sum<2>(ptrs, out, num_ranks, first_dst,
                                    num_dst, chunk, vec, sig, s);
  }
}

// One launch of signal_copy_kernel for rank `rank` of `world` ranks:
// bufs the host table of the world's buffers of one set of symmetric
// buffers (the rank's own at [rank]); nbytes of src copied to dst in units
// of `unit` bytes (16, 4 or 2; the caller checks the alignment), or none
// (one block); wait_region and sig_region 0 (SIGNAL) or 1 (ACK); wait_mask
// and sig_mask sets of ranks, bit i rank i; epoch the exchange's (the one
// signalled), wait_epoch the one waited for; counts, pad_off and
// timeout_ns as for the puts.  Returns the cudaError_t of the launch.
extern "C" int onesided_signal_copy(
    const void* src, void* dst, long long nbytes, int unit,
    const long long* bufs, int rank, int world, unsigned long long wait_mask,
    int wait_region, unsigned long long wait_epoch,
    unsigned long long sig_mask, int sig_region, unsigned long long epoch,
    unsigned long long* counts, long long pad_off, long long timeout_ns,
    void* stream) {
  if (world <= 0 || world > kMaxRanks || rank < 0 || rank >= world ||
      counts == nullptr || epoch == 0 || nbytes < 0 ||
      (unit != 16 && unit != 4 && unit != 2) || nbytes % unit != 0 ||
      (wait_region != kSignalRegion && wait_region != kAckRegion) ||
      (sig_region != kSignalRegion && sig_region != kAckRegion) ||
      (wait_mask & ~all_ranks(world)) != 0 ||
      (sig_mask & ~all_ranks(world)) != 0 || timeout_ns <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RankPtrs table = rank_ptrs(bufs, world);
  const Signals sig{counts, epoch, pad_off, timeout_ns, rank};
  const long long units = nbytes / unit;
  switch (unit) {
    case 16: return launch_signal_copy<uint4>(
        src, dst, units, table, sig, world, wait_mask, wait_region,
        wait_epoch, sig_mask, sig_region, s);
    case 4: return launch_signal_copy<uint32_t>(
        src, dst, units, table, sig, world, wait_mask, wait_region,
        wait_epoch, sig_mask, sig_region, s);
    default: return launch_signal_copy<uint16_t>(
        src, dst, units, table, sig, world, wait_mask, wait_region,
        wait_epoch, sig_mask, sig_region, s);
  }
}

// The process's timeout record: kRecordWords uint64 words of host memory
// mapped for the kernels (made zeroed at the first call, the same after),
// and a zeroed claim word on `device`.  *host receives the record.
extern "C" int signal_record(int device, void** host) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (g_record_host == nullptr) {
    void* h = nullptr;
    e = cudaHostAlloc(&h, kRecordWords * sizeof(unsigned long long),
                      cudaHostAllocMapped | cudaHostAllocPortable);
    if (e != cudaSuccess) return (int)e;
    memset(h, 0, kRecordWords * sizeof(unsigned long long));
    void* d = nullptr;
    e = cudaHostGetDevicePointer(&d, h, 0);
    if (e != cudaSuccess) {
      cudaFreeHost(h);
      return (int)e;
    }
    g_record_host = static_cast<unsigned long long*>(h);
    g_record_dev = static_cast<unsigned long long*>(d);
  }
  if (g_claim[device] == nullptr) {
    void* c = nullptr;
    e = cudaMalloc(&c, sizeof(unsigned long long));
    if (e == cudaSuccess) e = cudaMemset(c, 0, sizeof(unsigned long long));
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e != cudaSuccess) return (int)e;
    g_claim[device] = static_cast<unsigned long long*>(c);
  }
  *host = g_record_host;
  return 0;
}

extern "C" int signal_record_words() { return kRecordWords; }

extern "C" const char* a2a_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ---------------------------------------------------------------------------
// Symmetric buffers across processes
// ---------------------------------------------------------------------------
//
// One rank per process: each rank allocates its buffer with cudaMalloc (a
// buffer of its own, so its IPC handle names it from its first byte),
// exports the buffer's cudaIpcMemHandle_t, and opens every peer's handle
// into its own address space.  The opened addresses fill the tables that
// the put and pull-sum launchers above take, with first = rank and count =
// 1: the same kernels then write into and read from other processes'
// buffers.  On one card the peers' buffers lie in the same device memory;
// across cards cudaIpcMemLazyEnablePeerAccess maps them over NVLink.
// Every buffer carries its signal pad after its bytes (the Completion
// paragraph at the top).  Every function selects `device` first and
// returns the cudaError_t (0 = success).

extern "C" int symm_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// nbytes for the buffer and pad_bytes after them for its signal pad,
// zeroed, in one allocation (one IPC handle names both); the memset is
// done when this returns.
extern "C" int symm_alloc(int device, long long nbytes, long long pad_bytes,
                          void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (nbytes <= 0 || pad_bytes <= 0) return (int)cudaErrorInvalidValue;
  e = cudaMalloc(ptr, (size_t)(nbytes + pad_bytes));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(static_cast<char*>(*ptr) + nbytes, 0, (size_t)pad_bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)e;
}

// handle: sizeof(cudaIpcMemHandle_t) bytes of the caller's.
extern "C" int symm_export(int device, void* ptr, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)e;
}

extern "C" int symm_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int symm_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int symm_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFree(ptr);
}

// Table-batched (TBE) embedding gather + weighted pool, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel gather_pool_tbe_flat_pallas in
// src/repro/kernels/embedding_gather.py, and through its two wrappers also
// gather_pool_tbe_pallas (stacked (T, R, D) tables, off[t] = t * R) and
// gather_pool_pallas (one table, T = 1):
//
//     out[t, b, :] = sum_l w[t, b, l] * flat[off[t] + idx[t, b, l], :]
//
// with f32 accumulation, returning (T, B, D) f32.  Callers cast and apply
// the mean combiner.  The offsets come either as a (T,) device array (the
// ragged slot pool) or as a stride, off[t] = t * stride (stacked tables;
// stride 0 for one table), so the stacked and single-table entries put no
// device work beside the kernel.
//
// What bounds it depends on the number of bags.
//
//   * Many bags (T = 26, B = 2048: 53,248): device-memory bytes.  Each live
//     lookup reads one D-wide row at a random address of a table far larger
//     than L2 and does 2 * D flops on it, about half a flop per byte against
//     the H100's ~20 flops per byte of fp32 balance.  The card needs a few
//     megabytes in flight to reach its memory rate.
//   * Few bags (T = 1, B = 2048): latency.  2048 bags are about 16 warps on
//     each of 132 SMs, far too few to hide a load each, so the launch takes
//     as long as its slowest bag's chain of dependent loads.  A warp that
//     loads a slot's weight, tests it, loads the id and then the row, one
//     slot after another, waits about L times for device memory: ~28 us
//     at L = 32, where the bytes alone take ~5 us.
//
// The design keeps many rows of a bag in flight and the chain short:
//
//   * one warp per fused bag tb = t * B + b;
//   * the bag's ids and weights are staged once per window of 32 slots, one
//     slot per lane, as coalesced 128-byte loads.  __ballot_sync of w != 0
//     gives the window's live slots; __shfl_sync hands each live slot's id
//     and weight to every lane.  A zero-weight slot (padding beyond
//     lengths, an out-of-shard id) costs no load and no branch of its own,
//     and its id, -1 for padding, never becomes an address;
//   * the live slots are taken a group at a time (kGroup = 8, or 4 below):
//     each lane issues a group's independent row loads, and the loads of
//     the group kStages - 1 ahead are issued before the FMAs of this one,
//     so up to kStages groups of a bag are in flight.  A bag of up to 16
//     live slots then costs one latency for its ids and one for its rows;
//   * the lanes cover D: four consecutive elements per lane, 16 bytes of
//     f32 or 8 of bf16, when D % 4 == 0 and the table is aligned, one
//     element per lane otherwise; the schedule repeats for each D chunk
//     when D exceeds 128 (vector) or 32 (scalar) elements;
//   * small grids are spread: the launcher takes the largest block of up to
//     kMaxWarpsPerBlock warps that still gives every SM kSpreadBlocksPerSm
//     blocks, so at T = 1 the 2048 bags go out as 1024 blocks of two warps
//     rather than 256 of eight on 132 SMs;
//   * the group follows the grid: kGroup rows on a grid that the SMs hold
//     at once (at most kDeepWarpsPerSm bags an SM), where each bag's chain
//     is the cost; on a larger grid the ring is cut to kWideRingBytes a
//     warp (4 rows a group for f32, still 8 for bf16), where other warps
//     hide the latency and the SM's L1 and warp slots count for more.
//
// Where the rows in flight wait: on the vector path (every call of the main
// path) in a ring of kStages x kGroup slots a lane in shared memory, filled
// by cp.async.ca (16 bytes a lane for f32, 8 for bf16) and read back by
// the lane that filled it, after cp.async.wait_group.  Timed against the
// same schedule into registers on the H100, the ring was as fast for f32
// at T = 1, faster at T = 26, and far faster for bf16: in registers a
// unit's conversion, or a group's worth of live registers, held back the
// next group's loads.  The .ca form allocates the rows in L1: the flush's
// Zipf ids reread hot rows, which L1 then serves, and the L2-only .cg form
// took markedly longer on them.  Deeper rings (3 x 8, 4 x 4 and 4 x 8
// slots) were no faster at T = 1, and 4 x 8 was slower at T = 26, where
// its 16 KB a warp cut the warps an SM holds.  kStages = 2 and kGroup = 8
// make 8 KB a warp (4 KB for bf16), at most 32 KB a block of
// kMaxWarpsPerBlock = 4 warps, under the 48 KB a launch may take without
// raising the kernel's limit.  On the flush's Zipf ids at T = 26 that f32
// ring was no faster than one row in flight a warp: its shared memory took
// the SM's L1 (7 blocks of 32 KB fill most of the 256 KB that L1 and
// shared memory split), where the hot rows would hit.  A ring of 2 x 4 f32
// rows (4 KB a warp) beat both there, on Zipf and on uniform ids, and lost
// to 2 x 8 only at T = 1, where every bag's chain counts: hence the group
// that follows the grid.  The scalar path (2-byte bf16 units, which
// cp.async cannot copy) keeps the schedule in registers, as raw bits
// turned into f32 only when they are accumulated.
//
// Every output element is acc = fma(w_l, row_l[d], acc) from +0.0 over the
// live slots in ascending l, without atomics: the same arithmetic in every
// launch shape, so the stacked tables, a slot pool holding the same rows
// and T single-table launches pool to bitwise-equal outputs, and a
// zero-weight slot is bitwise-neutral for finite tables.  The row address
// off[t] + id is formed in 64 bits: a (26 * 10^6, 128) flat table has more
// than 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWarpsPerBlock = 4;
constexpr int kMinBlocksPerSm = 8;     // at most 64 registers a thread
constexpr int kGroup = 8;              // rows a lane issues together
constexpr int kStages = 2;             // groups in flight
constexpr int kSpreadBlocksPerSm = 4;  // blocks an SM should get, at least
constexpr int kDeepWarpsPerSm = 28;    // bags an SM holds at once, 8 KB each
constexpr int kWideRingBytes = 4096;   // a warp's ring on larger grids
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// Rows in flight
// ---------------------------------------------------------------------------

// The vector path: a lane's unit is four elements, 16 bytes of f32 or 8 of
// bf16, copied by cp.async into this lane's slot of a ring of kStages x
// G slots in shared memory.  Each lane reads back only the slots it
// filled, after waiting on its own groups, so no barrier is needed.
template <typename T, int G>
struct SmemRing {
  using Raw = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;
  using V = float4;
  static constexpr int kRows = G;
  static constexpr int kWarpBytes = sizeof(Raw) * kStages * G * 32;
  Raw* slots;       // this lane's slot of stage 0, group slot 0

  __device__ __forceinline__ Raw* slot(int stage, int k) const {
    return slots + (stage * G + k) * 32;
  }
  __device__ __forceinline__ void issue(int stage, int k, const T* p) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(slot(stage, k));
    if constexpr (sizeof(Raw) == 16) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst), "l"(p) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :: "r"(dst), "l"(p) : "memory");
    }
  }
  __device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // Waits until at most kStages - 1 of this lane's groups are pending.
  __device__ __forceinline__ void wait_oldest() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
  }
  __device__ __forceinline__ float4 get(int stage, int k) const {
    const Raw u = *slot(stage, k);
    if constexpr (sizeof(Raw) == 16) {
      return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                         __uint_as_float(u.z), __uint_as_float(u.w));
    } else {
      // bf16 to f32 is exact: the 16 bits become the high half; little
      // endian, element 0 is the low half of u.x
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    }
  }
};

// The scalar path (D % 4 != 0, or a table not aligned to four elements): a
// lane's unit is one element, loaded into registers as raw bits and turned
// into f32 only when it is accumulated, so that no conversion waits on a
// load before the next group's loads are issued.
template <typename T>
struct RegRing {
  using Raw = typename std::conditional<sizeof(T) == 4, float,
                                        unsigned short>::type;
  using V = float;
  static constexpr int kRows = kGroup;
  Raw r[kStages][kGroup];

  __device__ __forceinline__ void issue(int stage, int k, const T* p) {
    r[stage][k] = __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ __forceinline__ void commit() {}
  __device__ __forceinline__ void wait_oldest() {}
  __device__ __forceinline__ float get(int stage, int k) const {
    if constexpr (sizeof(T) == 4) {
      return r[stage][k];
    } else {
      return __uint_as_float((unsigned)r[stage][k] << 16);
    }
  }
};

// ---------------------------------------------------------------------------
// One bag's slots
// ---------------------------------------------------------------------------

// A warp's walk over one bag's slots: the staged window (this lane's slot's
// id and weight) and its live slots not yet taken.  Every field but id and
// wt is the same in all lanes.
struct Slots {
  const int* idx;
  const float* w;
  int pooling;
  int l0;            // first slot of the next window
  int id;            // this lane's slot of the current window
  float wt;
  unsigned live;     // live slots of the current window not yet taken
};

// Takes the next (up to) Ring::kRows live slots in ascending order, issues
// their row loads into ring stage ``stage`` (this lane's unit of row id is
// at rows + id * dim) and commits them as one group.  Returns how many
// slots it took, the same in all lanes: 0 once the bag is done, and from
// then on.
template <typename T, typename Ring>
__device__ __forceinline__ int fetch(Slots& s, const T* rows, long long dim,
                                     bool active, Ring& ring, int stage,
                                     float (&wk)[Ring::kRows]) {
  const int lane = threadIdx.x & 31;
  while (s.live == 0 && s.l0 < s.pooling) {
    const int l = s.l0 + lane;
    s.wt = l < s.pooling ? __ldg(s.w + l) : 0.0f;
    s.id = l < s.pooling ? __ldg(s.idx + l) : 0;
    s.live = __ballot_sync(kFull, s.wt != 0.0f);
    s.l0 += 32;
  }
  int n = 0;
#pragma unroll
  for (int k = 0; k < Ring::kRows; ++k) {
    if (s.live != 0) {
      const int src = __ffs(s.live) - 1;
      s.live &= s.live - 1;
      const long long id = __shfl_sync(kFull, s.id, src);
      wk[k] = __shfl_sync(kFull, s.wt, src);
      if (active) ring.issue(stage, k, rows + id * dim);
      n = k + 1;
    }
  }
  ring.commit();
  return n;
}

__device__ __forceinline__ void fma_unit(float4& acc, float w,
                                         const float4& r) {
  acc.x = __fmaf_rn(w, r.x, acc.x);
  acc.y = __fmaf_rn(w, r.y, acc.y);
  acc.z = __fmaf_rn(w, r.z, acc.z);
  acc.w = __fmaf_rn(w, r.w, acc.w);
}
__device__ __forceinline__ void fma_unit(float& acc, float w, float r) {
  acc = __fmaf_rn(w, r, acc);
}

// acc over one bag's live slots in ascending l, kStages groups in flight:
// the loads of the group kStages - 1 ahead are issued before this group's
// FMAs.
template <typename T, typename Ring>
__device__ __forceinline__ void pool_bag(Slots& s, const T* rows,
                                         long long dim, bool active,
                                         Ring& ring,
                                         typename Ring::V& acc) {
  float wk[kStages][Ring::kRows];
  int n[kStages];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    n[st] = fetch(s, rows, dim, active, ring, st, wk[st]);
  }
  for (;;) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (n[st] == 0) return;
      constexpr int kAhead = kStages - 1;
      const int ahead = (st + kAhead) % kStages;
      n[ahead] = fetch(s, rows, dim, active, ring, ahead, wk[ahead]);
      ring.wait_oldest();
      if (active) {
#pragma unroll
        for (int k = 0; k < Ring::kRows; ++k) {
          if (k < n[st]) fma_unit(acc, wk[st][k], ring.get(st, k));
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& a) { a = 0.f; }

__device__ __forceinline__ void store_unit(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_unit(float* p, float v) { *p = v; }

// kVec: four elements a lane through the shared-memory ring of G rows a
// group; else one element a lane through registers, kGroup rows a group.
template <typename T, bool kVec, int G>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, kMinBlocksPerSm)
tbe_gather_pool_kernel(const T* __restrict__ flat,
                       const int* __restrict__ off, long long off_stride,
                       const int* __restrict__ idx,
                       const float* __restrict__ w,
                       float* __restrict__ out,
                       int num_tables, int batch, int pooling, int dim) {
  using Ring = typename std::conditional<kVec, SmemRing<T, G>,
                                         RegRing<T>>::type;
  constexpr int kPer = kVec ? 4 : 1;          // elements per lane unit
  constexpr int kChunk = 32 * kPer;           // elements per warp pass
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bag = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (bag >= (long long)num_tables * batch) return;   // the whole warp
  const long long t = bag / batch;
  const long long base = off != nullptr ? (long long)__ldg(off + t)
                                        : t * off_stride;
  float* bag_out = out + bag * dim;
  Ring ring;
  if constexpr (kVec) {
    using Raw = typename Ring::Raw;
    ring.slots = reinterpret_cast<Raw*>(smem)
        + warp * (kStages * G * 32) + lane;
  }

  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    const int d = c0 + lane * kPer;
    const bool active = d < dim;
    Slots s{idx + bag * pooling, w + bag * pooling, pooling, 0, 0, 0.0f, 0u};
    typename Ring::V acc;
    zero(acc);
    pool_bag(s, flat + base * (long long)dim + d, (long long)dim, active,
             ring, acc);
    if (active) store_unit(bag_out + d, acc);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && n > 0) {
      count = n;
    } else {
      count = 1;
    }
  }
  return count;
}

// The largest block, up to kMaxWarpsPerBlock warps, that gives every SM at
// least kSpreadBlocksPerSm blocks; one warp a block below that.
int warps_per_block(long long bags) {
  const long long want = (long long)sm_count() * kSpreadBlocksPerSm;
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && (bags + warps - 1) / warps < want) warps >>= 1;
  return warps;
}

// The vector path with a ring of G rows a group: kStages x G units a lane,
// at most 32 KB a block, under the 48 KB a launch may ask for without
// raising the kernel's limit.
template <typename T, int G>
void launch_vec(dim3 grid, dim3 block, int warps, const T* table,
                const int* off, long long off_stride, const int* idx,
                const float* w, float* out, int num_tables, int batch,
                int pooling, int dim, cudaStream_t stream) {
  constexpr size_t kWarpBytes = SmemRing<T, G>::kWarpBytes;
  static_assert(kWarpBytes * kMaxWarpsPerBlock <= 48 * 1024,
                "the ring outgrows the default shared-memory limit");
  tbe_gather_pool_kernel<T, true, G><<<grid, block, kWarpBytes * warps,
                                       stream>>>(
      table, off, off_stride, idx, w, out, num_tables, batch, pooling, dim);
}

template <typename T>
int launch(const void* flat, const int* off, long long off_stride,
           const int* idx, const float* w, float* out, int num_tables,
           int batch, int pooling, int dim, int vec, cudaStream_t stream) {
  const long long bags = (long long)num_tables * batch;
  const int warps = warps_per_block(bags);
  const dim3 block(warps * 32);
  const dim3 grid((unsigned)((bags + warps - 1) / warps));
  const T* table = static_cast<const T*>(flat);
  if (vec) {
    // a grid larger than the SMs hold at once takes the ring of
    // kWideRingBytes a warp: half the group where kGroup rows are more
    bool deep = true;
    if constexpr (SmemRing<T, kGroup>::kWarpBytes > kWideRingBytes) {
      static_assert(SmemRing<T, kGroup / 2>::kWarpBytes <= kWideRingBytes,
                    "half a group fits the ring of larger grids");
      deep = bags <= (long long)sm_count() * kDeepWarpsPerSm;
      if (!deep) {
        launch_vec<T, kGroup / 2>(grid, block, warps, table, off, off_stride,
                                  idx, w, out, num_tables, batch, pooling,
                                  dim, stream);
      }
    }
    if (deep) {
      launch_vec<T, kGroup>(grid, block, warps, table, off, off_stride, idx,
                            w, out, num_tables, batch, pooling, dim, stream);
    }
  } else {
    tbe_gather_pool_kernel<T, false, kGroup><<<grid, block, 0, stream>>>(
        table, off, off_stride, idx, w, out, num_tables, batch, pooling, dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 table, 1 = bfloat16 table.  off: the (T,) int32 first
// row of each table, or null for off[t] = t * off_stride.  vec: 1 when
// dim % 4 == 0 and the table's base address is aligned to four elements
// (the caller checks).  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int tbe_gather_pool(const void* flat, int dtype, const int* off,
                               long long off_stride, const int* idx,
                               const float* w, float* out, int num_tables,
                               int batch, int pooling, int dim, int vec,
                               void* stream) {
  if ((long long)num_tables * batch == 0 || dim == 0) return 0;
  if (off == nullptr && off_stride < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(flat, off, off_stride, idx, w, out, num_tables,
                           batch, pooling, dim, vec, s);
    case 1:
      return launch<__nv_bfloat16>(flat, off, off_stride, idx, w, out,
                                   num_tables, batch, pooling, dim, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tbe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 q, k, v
// at head_dim 64 or 128.
//
// Replaces the Pallas TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py (body _flash_kernel, pallas_call at
// :130) for those inputs:
//
//     o[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h] . k[b, t, kh]) v[b, t, kh]
//
// over the keys t that the masks leave: t < S (padded keys), t <= s when
// causal, t > s - window with a sliding window; kh = h / (H / KH) (GQA).
// Masked scores are -1e30, as in the reference (not -inf): a row that is
// wholly masked in one tile takes weight 1 there, and the next live tile's
// correction exp(-1e30 - m) zeroes it.  The running max m, the running sum
// l and the accumulator are f32; the output is acc / max(l, 1e-30) in bf16.
// The probabilities are rounded to bf16 for P.V, as SDPA's flash backend
// does; l sums them in f32 before the rounding.  f32 inputs and head_dim 16
// or 32 stay on the SIMT kernel of flash_attention.cu.
//
// What bounds it on this card: operations.  A causal granite-8b layer at
// S = 16,384 is 2.2 TFLOP of products against 0.34 GB of q/k/v/o, some
// 6,500 flops per byte, far above the H100's ~295 (bf16) balance, so the
// design is about keeping the tensor cores fed:
//
//   * both products run on wgmma, bf16 in and f32 accumulated.  S = Q.K^T
//     takes Q and K from shared memory, both K-major (head_dim contiguous).
//     O += P.V takes P from registers: the f32 fragment of S, converted
//     pairwise to bf16x2, is already wgmma's A-fragment layout, so P never
//     touches shared memory; V is read MN-major (head_dim contiguous over
//     the key rows) through the transpose bit for B;
//   * TMA moves every tile.  One 4-D tensor map each for q, k and v,
//     (head_dim, heads, S, B) with the caller's byte strides, so strided
//     views are read without a copy, and rows past S arrive as zeros.  The
//     128-byte swizzle takes boxes of 64 bf16 columns, so a tile of 128
//     rows at head_dim 128 is two boxes.  Q is loaded once per CTA; K and
//     V stream through a ring of two stages, each with a "K full", a "V
//     full" and a "stage free" mbarrier, so the copy of tile k+1 overlaps
//     the products of tile k;
//   * the CTA is warp-specialised: 384 threads, warpgroup 0 the producer
//     (one thread starts the TMA loads and waits on "stage free"; setmaxnreg
//     gives its registers away, down to 24) and warpgroups 1 and 2 the
//     consumers, 64 query rows each, so a CTA covers 128 query rows
//     (setmaxnreg up to 240: 64 S floats, 64 O floats and 32 P registers
//     a thread at head_dim 128).  Two consumers on one SM overlap one's
//     softmax with the other's products;
//   * the four lanes of a quad hold the same two rows of the accumulator,
//     so each row's max and sum are two shuffles;
//   * key tiles wholly above the diagonal or wholly left of the window are
//     never loaded (the reference's `live` test); the masks are applied per
//     element only in tiles that straddle a boundary; q-tiles run heaviest
//     first (the tile index is reversed and heads vary fastest), so the
//     causal tail does not idle the card.
//
// Shared memory at head_dim 128: Q 32 KB, two K and two V stages 128 KB,
// the barriers and 1 KB of slack to align the tiles to 1,024 bytes (the
// swizzle's period): 164 KB, one CTA per SM.  The launcher raises the
// dynamic limit and returns its error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBlockQ = 128;      // query rows per CTA, 64 per consumer
constexpr int kBlockK = 128;      // key rows per stage
constexpr int kStages = 2;
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kConsumerThreads = 256;
constexpr int kBoxCols = 64;      // bf16 columns of one 128-byte box
constexpr int kBoxBytes = 128 * 128;  // one box of 128 rows x 128 bytes
constexpr float kNegInf = -1e30f; // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// codes returned beside cudaError_t values
constexpr int kErrEncodeBase = 10000;   // + the CUresult of a failed encode
constexpr int kErrNoEntryPoint = 20000; // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrLayout = 20001;       // shape outside the kernel's limits

template <int HD>
struct Layout {
  static constexpr int kTile = (HD / kBoxCols) * kBoxBytes;  // 128 x HD
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed.  A wait that outlasts
// 2**26 polls (seconds; a tile takes microseconds) traps, so a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// --- TMA -------------------------------------------------------------------

// one box of `map` at coordinates (c0 innermost .. c3) into shared memory
// at `dst`; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define FA_F4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define FA_F16(c, i) \
  FA_F4(c, i), FA_F4(c, i + 4), FA_F4(c, i + 8), FA_F4(c, i + 12)
#define FA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = (kAccumulate ? d : 0) + A (64 x 16) . B (128 x 16)^T,
// A and B bf16 in shared memory, both K-major.  The first step writes d
// without reading it, so S is not kept alive from one key tile to the next.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  if constexpr (kAccumulate)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
        ", %64, %65, 1, 1, 1, 0, 0;"
        : FA_F16("+f", 0), FA_F16("+f", 16), FA_F16("+f", 32),
          FA_F16("+f", 48)
        : "l"(da), "l"(db));
  else
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
        ", %64, %65, 0, 1, 1, 0, 0;"
        : FA_F16("=f", 0), FA_F16("=f", 16), FA_F16("=f", 32),
          FA_F16("=f", 48)
        : "l"(da), "l"(db));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128), B in
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;"
      : FA_F16("+f", 0), FA_F16("+f", 16), FA_F16("+f", 32), FA_F16("+f", 48)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// the same at N = 64 (head_dim 64)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;"
      : FA_F16("+f", 0), FA_F16("+f", 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

#undef FA_D64
#undef FA_F16
#undef FA_F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the kernel --------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int seq_len, int heads,
                   int group, int causal, int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int kBoxes = HD / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;                  // K full, per stage
  const uint32_t bar_v = bar_k + 8 * kStages;        // V full, per stage
  const uint32_t bar_free = bar_v + 8 * kStages;     // stage free

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;         // heaviest tiles first
  const int b = blockIdx.z;
  const int kh = h / group;
  const int q0 = qt * kBlockQ;

  // live key tiles: not above the diagonal, not wholly left of the window
  // (for any of the CTA's rows)
  const int n_k = (seq_len + kBlockK - 1) / kBlockK;
  const int kt_hi = causal ? min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1) : n_k;
  int kt_lo = 0;
  if (window > 0) {
    const int x = q0 - window - (kBlockK - 1);
    if (x >= 0) kt_lo = x / kBlockK + 1;
  }
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(sq + c * kBoxBytes, &tm_q, bar_q, c * kBoxCols, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t use = it / kStages;
        mbar_wait(bar_free + 8 * s, (use & 1) ^ 1);   // first use: free
        const int k0 = (kt_lo + it) * kBlockK;
        mbar_expect_tx(bar_k + 8 * s, L::kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(sk + s * L::kTile + c * kBoxBytes, &tm_k, bar_k + 8 * s,
                   c * kBoxCols, kh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(sv + s * L::kTile + c * kBoxBytes, &tm_v, bar_v + 8 * s,
                   c * kBoxCols, kh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int qa = q0 + 64 * cw;                   // this warpgroup's first row
    const int r0 = qa + 16 * (t / 32) + lane / 4;  // this thread's rows r0, r0 + 8
    const int cq = 2 * (lane % 4);                 // its first column of a pair
    // this warpgroup's 64 rows inside each Q box
    const uint32_t q_rows = sq + 64 * cw * 128;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this thread's part of each row's sum

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int k0 = (kt_lo + it) * kBlockK;
      const uint32_t k_tile = sk + s * L::kTile;
      const uint32_t v_tile = sv + s * L::kTile;

      // S = Q . K^T: k16 steps advance 32 bytes inside a swizzled row and
      // move to the next box after four
      float sc[64];   // S, then P, for 128 keys: rows r0 (i % 4 < 2), r0 + 8
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
      wgmma_ss_n128<false>(sc, smem_desc(q_rows, 16, 1024),
                           smem_desc(k_tile, 16, 1024));
#pragma unroll
      for (int ks = 1; ks < HD / 16; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss_n128<true>(sc, smem_desc(q_rows + off, 16, 1024),
                            smem_desc(k_tile + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // scale (in log2 units), mask where the tile straddles a boundary
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      const bool edge = k0 + kBlockK > seq_len ||
                        (causal && k0 + kBlockK - 1 > qa) ||
                        (window > 0 && k0 <= qa + 63 - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i / 4) + cq + (i % 2);
          const int row = r0 + 8 * ((i / 2) % 2);
          bool ok = key < seq_len;
          if (causal) ok = ok && key <= row;
          if (window > 0) ok = ok && key > row - window;
          if (!ok) sc[i] = kNegInf;
        }
      }

      // online softmax; a quad's four lanes hold the same two rows
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = exp2f(sc[i] - mx[(i / 2) % 2]);
        ls[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      uint32_t pa[32];  // P in bf16 pairs: the A fragments of 8 k16 steps
#pragma unroll
      for (int j = 0; j < 32; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

      // O += P . V: each k16 step is 16 key rows of 128 bytes a box; the
      // second box of head_dim lies one box (LBO) further on
      mbar_wait(bar_v + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint64_t dv = smem_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024);
        if constexpr (HD == 128)
          wgmma_rs_n128(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                        pa[4 * kk + 3], dv);
        else
          wgmma_rs_n64(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(pa);
      mbar_arrive(bar_free + 8 * s);
    }

    // acc / max(l, 1e-30), rows < S only
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < seq_len) {
        __nv_bfloat16* orow =
            o + ((static_cast<long long>(b) * seq_len + row) * heads + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              acc[4 * j + 2 * r] / den[r], acc[4 * j + 2 * r + 1] / den[r]);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = pair;
        }
      }
    }
  }
}

// --- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up by name in the libcuda that the CUDA
// runtime has already loaded, so that this library links no libcuda
int encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return kErrNoEntryPoint;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return 0;
}

// (head_dim, heads, S, B) over a (B, S, heads, head_dim) bf16 tensor with
// element strides st = (batch, seq, head); boxes of 64 columns x 128 rows
int encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch,
           int seq_len, int nh, int hd, const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(nh),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBlockK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(r);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_len, int heads, int kv_heads, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  EncodeTiled enc;
  int rc = encoder(&enc);
  if (rc != 0) return rc;
  CUtensorMap mq, mk, mv;
  if ((rc = encode(enc, &mq, q, batch, seq_len, heads, HD, st)) != 0 ||
      (rc = encode(enc, &mk, k, batch, seq_len, kv_heads, HD, st + 3)) != 0 ||
      (rc = encode(enc, &mv, v, batch, seq_len, kv_heads, HD, st + 6)) != 0)
    return rc;
  auto kernel = flash_wgmma_kernel<HD>;
  const int smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, (seq_len + kBlockQ - 1) / kBlockQ, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), seq_len, heads,
      heads / kv_heads, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and o bf16.  strides: nine element strides, (batch, seq, head) of
// q, then of k, then of v; the head dimension is contiguous, and the
// caller has checked TMA's rules (16-byte aligned bases, byte strides
// multiples of 16).  o is a contiguous (B, S, H, hd) tensor.  hd is 64 or
// 128.  window <= 0: no sliding window.  Returns 0, a cudaError_t, or one
// of this file's codes (flash_wgmma_error_string names them).
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int batch,
                                         int seq_len, int heads, int kv_heads,
                                         int hd, int causal, int window,
                                         float scale, const long long* strides,
                                         void* stream) {
  if (batch == 0 || seq_len == 0 || heads == 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch > 65535 ||
      (seq_len + kBlockQ - 1) / kBlockQ > 65535)
    return kErrLayout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, batch, seq_len, heads, kv_heads, causal,
                        window, scale, strides, s);
    case 128:
      return launch<128>(q, k, v, o, batch, seq_len, heads, kv_heads, causal,
                         window, scale, strides, s);
    default:
      return kErrLayout;
  }
}

extern "C" const char* flash_wgmma_error_string(int code) {
  static thread_local char buf[96];
  if (code == kErrNoEntryPoint)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (code == kErrLayout)
    return "shape outside the kernel's limits (hd 64/128, KH | H, "
           "B and S / 128 <= 65535)";
  if (code >= kErrEncodeBase && code < kErrNoEntryPoint) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kErrEncodeBase);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

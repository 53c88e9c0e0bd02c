// Flash attention forward (online softmax), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py (body _flash_kernel):
//
//     o[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h] . k[b, t, kh]) v[b, t, kh]
//
// over the keys t that the masks leave: t < S (padded keys), t <= s when
// causal, t > s - window with a sliding window; kh = h / (H / KH) (GQA).
// Masked scores are -1e30, as in the reference (not -inf); the running
// max m, the running sum l and the accumulator are f32; the output is
// acc / max(l, 1e-30) cast to q's dtype.  q, k, v are f32 or bf16, all
// three of one type, read in their (B, S, H|KH, hd) layout through the
// strides the caller gives (the last dimension contiguous), with 64-bit
// element offsets.  hd is 16, 32, 64 or 128.
//
// What bounds it on this card: operations.  A causal granite-8b layer at
// S = 16,384 is 2.2 TFLOP of products against 0.34 GB of q/k/v/o, some
// 6,500 flops per byte, far above the H100's ~295 (bf16) balance.  This is
// the simple version: scores and P.V are f32 FMAs on the CUDA cores (no
// tensor cores), so it is expected at a few percent of the bf16
// tensor-core bound.  Its design:
//
//   * one CTA of 256 threads per (tile of 64 query rows, head, batch); a
//     loop over key/value tiles of 64 rows carries (m, l, acc);
//   * four threads (a quad, inside one warp) own one query row: each
//     scores 16 of the tile's 64 keys and keeps a quarter of the row's
//     accumulator (hd / 4 floats) in registers; the row's max and sum go
//     through two shuffles inside the quad;
//   * the Q tile (loaded once) and each K/V tile are staged in shared
//     memory as f32, rows padded by 4 floats so that 16-byte reads of
//     eight rows hit distinct banks; the probabilities pass through a
//     (64, 65) shared tile from the quad that computed them to the quad's
//     P.V loop.  At hd = 128 that is 118,016 bytes of dynamic shared
//     memory, over the 48 KB default, so the launcher raises the limit;
//   * tiles are skipped wholesale when they lie above the diagonal
//     (causal) or wholly left of the window, the reference's `live` test;
//     inside a tile every mask is applied per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;      // 4 threads per query row
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 4; }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBlockQ + 2 * kBlockK) * ld<HD>() +
          (size_t)kBlockQ * (kBlockK + 1));
}

// rows [row0, row0 + 64) of one head into a (64, ld) f32 tile; rows at or
// past S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int row0,
                                          int seq_len) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < seq_len) {
      const T* p = base + (long long)(row0 + row) * row_stride + c;
      val = make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                        to_f32(p[3]));
    }
    *reinterpret_cast<float4*>(tile + row * ld<HD>() + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq_len,
                 int heads, int kv_heads, int causal, int window, float scale,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh) {
  constexpr int LD = ld<HD>();
  constexpr int kAcc = HD / 16;        // float4 accumulators per thread
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);
  float* const Ks = Qs + kBlockQ * LD;
  float* const Vs = Ks + kBlockK * LD;
  float* const Ps = Vs + kBlockK * LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int r = threadIdx.x >> 2;      // this quad's query row in the tile
  const int sub = threadIdx.x & 3;     // this thread's place in the quad
  const int qpos = q0 + r;

  load_tile<T, HD>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, seq_len);
  const T* const kbase = k + b * k_sb + kh * k_sh;
  const T* const vbase = v + b * v_sb + kh * v_sh;

  // live key tiles: not above the diagonal, not wholly left of the window
  int k_hi = seq_len;
  if (causal) k_hi = min(seq_len, q0 + kBlockQ);
  int k_lo = 0;
  if (window > 0) {
    // first tile start k0 (a multiple of 64) with k0 + 63 > q0 - window
    const int first = q0 - window - kBlockK + 2;
    if (first > 0) k_lo = (first + kBlockK - 1) / kBlockK * kBlockK;
  }

  float m = kNegInf, l = 0.f;
  float4 acc[kAcc];
#pragma unroll
  for (int u = 0; u < kAcc; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = k_lo; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(Ks, kbase, k_ss, k0, seq_len);
    load_tile<T, HD>(Vs, vbase, v_ss, k0, seq_len);
    __syncthreads();

    // scores of keys sub, sub + 4, ..., sub + 60 against this row
    float s[kBlockK / 4];
#pragma unroll
    for (int t = 0; t < kBlockK / 4; ++t) s[t] = 0.f;
    const float* qrow = Qs + r * LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int t = 0; t < kBlockK / 4; ++t) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (sub + 4 * t) * LD + d);
        s[t] = fmaf(qv.x, kv.x, s[t]);
        s[t] = fmaf(qv.y, kv.y, s[t]);
        s[t] = fmaf(qv.z, kv.z, s[t]);
        s[t] = fmaf(qv.w, kv.w, s[t]);
      }
    }
    float mloc = kNegInf;
#pragma unroll
    for (int t = 0; t < kBlockK / 4; ++t) {
      const int kpos = k0 + sub + 4 * t;
      bool ok = kpos < seq_len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[t] = ok ? s[t] * scale : kNegInf;
      mloc = fmaxf(mloc, s[t]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
    float* prow = Ps + r * (kBlockK + 1);
#pragma unroll
    for (int t = 0; t < kBlockK / 4; ++t) {
      const float p = expf(s[t] - m_new);
      lsum += p;
      prow[sub + 4 * t] = p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = l * corr + lsum;
    m = m_new;
    __syncwarp();      // the quad's row of P is written (one warp)

    // acc = acc * corr + P . V on this thread's columns 4 * (sub + 4u) + 0..3
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      acc[u].x *= corr;
      acc[u].y *= corr;
      acc[u].z *= corr;
      acc[u].w *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * LD;
#pragma unroll
      for (int u = 0; u < kAcc; ++u) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vrow + 4 * (sub + 4 * u));
        acc[u].x = fmaf(p, vv.x, acc[u].x);
        acc[u].y = fmaf(p, vv.y, acc[u].y);
        acc[u].z = fmaf(p, vv.z, acc[u].z);
        acc[u].w = fmaf(p, vv.w, acc[u].w);
      }
    }
  }

  if (qpos < seq_len) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * seq_len + qpos) * heads + h) * HD;
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      T* p = orow + 4 * (sub + 4 * u);
      store(p + 0, acc[u].x / den);
      store(p + 1, acc[u].y / den);
      store(p + 2, acc[u].z / den);
      store(p + 3, acc[u].w / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_len, int heads, int kv_heads, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_len, heads,
      kv_heads, causal, window, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int batch, int seq_len, int heads, int kv_heads, int causal,
              int window, float scale, const long long* st,
              cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, seq_len, heads, kv_heads,
                           causal, window, scale, st, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, seq_len, heads, kv_heads,
                           causal, window, scale, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, seq_len, heads, kv_heads,
                           causal, window, scale, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, seq_len, heads, kv_heads,
                            causal, window, scale, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  strides: nine
// element strides, (batch, seq, head) of q, then of k, then of v; the
// head dimension is contiguous.  o is a contiguous (B, S, H, hd) tensor.
// window <= 0: no sliding window.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   int batch, int seq_len, int heads,
                                   int kv_heads, int hd, int causal,
                                   int window, float scale,
                                   const long long* strides, void* stream) {
  if (batch == 0 || seq_len == 0 || heads == 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(hd, q, k, v, o, batch, seq_len, heads,
                              kv_heads, causal, window, scale, strides, s);
    case 1:
      return launch_hd<__nv_bfloat16>(hd, q, k, v, o, batch, seq_len, heads,
                                      kv_heads, causal, window, scale,
                                      strides, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

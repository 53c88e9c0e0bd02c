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
// the mean combiner.
//
// What bounds it: device-memory bytes.  Each valid lookup reads one D-wide
// row from a table far larger than L2 at a random address and does 2 * D
// flops on it, about half a flop per byte, against the H100's ~20 flops per
// byte of fp32 balance.  So the design only has to keep the row reads wide
// and coalesced and read nothing it does not need:
//
//   * one warp per fused bag tb = t * B + b, eight bags per block;
//   * the lanes cover D: four consecutive elements per lane with one 16-byte
//     (f32) or 8-byte (bf16) load when D % 4 == 0 and the table is aligned,
//     one element per lane otherwise; a loop over D chunks when D exceeds
//     128 (vector) or 32 (scalar) elements;
//   * a sequential loop over l that adds w * row in f32, in a fixed order and
//     without atomics.  The order makes the kernel deterministic, so the
//     stacked tables and a slot pool holding the same rows pool to
//     bitwise-equal outputs;
//   * a slot whose weight is exactly 0 (padding beyond lengths, or an
//     out-of-shard id) is skipped: its row is never read.  For finite tables
//     that is bitwise-neutral;
//   * the row address off[t] + id is formed in 64 bits: a (26 * 10^6, 128)
//     flat table has more than 2^31 elements.
//
// It is the simple version: no shared-memory staging, no prefetch of the
// next rows' ids, one row in flight per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive row elements as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  // little endian: element 0 is the low half of raw.x
  return make_float4(
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.x & 0xffffu))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.x >> 16))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.y & 0xffffu))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(raw.y >> 16))));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tbe_gather_pool_kernel(const T* __restrict__ flat,
                       const int* __restrict__ off,
                       const int* __restrict__ idx,
                       const float* __restrict__ w,
                       float* __restrict__ out,
                       int num_tables, int batch, int pooling, int dim) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= (long long)num_tables * batch) return;
  const long long base = __ldg(off + bag / batch);
  const int* bag_idx = idx + bag * pooling;
  const float* bag_w = w + bag * pooling;
  float* bag_out = out + bag * dim;

  if (kVec) {
    for (int d0 = lane * 4; d0 < dim; d0 += 128) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int l = 0; l < pooling; ++l) {
        const float wl = __ldg(bag_w + l);
        if (wl == 0.0f) continue;
        const T* row = flat + (base + __ldg(bag_idx + l)) * (long long)dim;
        const float4 r = load4(row + d0);
        acc.x += wl * r.x;
        acc.y += wl * r.y;
        acc.z += wl * r.z;
        acc.w += wl * r.w;
      }
      *reinterpret_cast<float4*>(bag_out + d0) = acc;
    }
  } else {
    for (int d = lane; d < dim; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < pooling; ++l) {
        const float wl = __ldg(bag_w + l);
        if (wl == 0.0f) continue;
        const T* row = flat + (base + __ldg(bag_idx + l)) * (long long)dim;
        acc += wl * to_f32(row[d]);
      }
      bag_out[d] = acc;
    }
  }
}

template <typename T>
void launch(const void* flat, const int* off, const int* idx, const float* w,
            float* out, int num_tables, int batch, int pooling, int dim,
            int vec, cudaStream_t stream) {
  const long long bags = (long long)num_tables * batch;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((bags + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const T* table = static_cast<const T*>(flat);
  if (vec) {
    tbe_gather_pool_kernel<T, true><<<grid, block, 0, stream>>>(
        table, off, idx, w, out, num_tables, batch, pooling, dim);
  } else {
    tbe_gather_pool_kernel<T, false><<<grid, block, 0, stream>>>(
        table, off, idx, w, out, num_tables, batch, pooling, dim);
  }
}

}  // namespace

// dtype: 0 = float32 table, 1 = bfloat16 table.  vec: 1 when dim % 4 == 0
// and the table's base address is aligned to four elements (the caller
// checks).  Returns the cudaError_t of the launch (0 = success).
extern "C" int tbe_gather_pool(const void* flat, int dtype, const int* off,
                               const int* idx, const float* w, float* out,
                               int num_tables, int batch, int pooling, int dim,
                               int vec, void* stream) {
  if ((long long)num_tables * batch == 0 || dim == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(flat, off, idx, w, out, num_tables, batch, pooling, dim,
                    vec, s);
      break;
    case 1:
      launch<__nv_bfloat16>(flat, off, idx, w, out, num_tables, batch,
                            pooling, dim, vec, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tbe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

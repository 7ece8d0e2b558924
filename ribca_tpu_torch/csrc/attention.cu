// Short-sequence multi-head attention for the ViT blocks, one thread block
// per (cell, head).
//
// Replaces the Pallas TPU kernel ribca_tpu/ops/attention.py::fused_attention
// (_attn_kernel). It computes the same function: S = (q * scale) K^T with
// f32 accumulation, keys >= L excluded, an f32 softmax over the keys, P
// rounded to the input type, then O = P V, written in the input type. The
// whole sequence (L <= 128) fits one block, so there is no online softmax.
// Where the ViT's plain composition (models/vit.py, reference_attention)
// rounds to the input type, so does the kernel: q * scale and S before the
// softmax. In bf16 that keeps the kernel within one rounding of the plain
// version; in f32 the roundings are no-ops.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16): the main
// path calls it with B = 8192 cells, H = 12, L = 101, hd = 24. It must read
// q, k, v and write o once: 4 * 101 * 24 * 2 B * 98,304 (cell, head) pairs
// = 1.91 GB in bf16, 0.57 ms at the memory rate (3.81 GB, 1.14 ms in f32).
// It does 4 * L^2 * hd = 0.98 MFLOP per pair, 96 GFLOP in all, 0.10 ms at
// the bf16 tensor-core rate. So it is memory-bound in bf16. In f32 the
// same work on the CUDA cores (67 TFLOP/s) takes at least 1.44 ms, which
// makes f32 bound by operations.
//
// Design (simple first): K and V of one (cell, head) pair are staged in
// shared memory as f32, K with an odd row stride so that lanes reading
// different keys hit different banks. Each of the four warps takes query
// rows in turn. Lane j scores keys j, j+32, j+64, j+96; the row max and
// sum come from warp shuffles; P goes through a per-warp shared buffer to
// the P V product, where lane d owns output dims d and d+32. The products
// run on the CUDA cores, not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLen = 128;
constexpr int kMaxHeadDim = 64;
constexpr int kKeysPerLane = kMaxLen / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T and back, as the plain version's casts do.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__host__ __device__ inline int key_stride(int hd) { return hd | 1; }

__host__ __device__ inline size_t smem_floats(int len, int hd) {
  return (size_t)len * key_stride(hd) + (size_t)len * hd +
         (size_t)kWarps * hd + (size_t)kWarps * kMaxLen;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int len,
                     int hd, float scale) {
  extern __shared__ float smem[];
  const int ks = key_stride(hd);
  float* k_s = smem;                  // len x ks
  float* v_s = k_s + len * ks;        // len x hd
  float* q_s = v_s + len * hd;        // kWarps x hd
  float* p_s = q_s + kWarps * hd;     // kWarps x kMaxLen

  const size_t base = (size_t)blockIdx.x * len * hd;
  const int n = len * hd;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / hd;
    k_s[r * ks + (i - r * hd)] = to_f32(k[base + i]);
    v_s[i] = to_f32(v[base + i]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = q_s + warp * hd;
  float* pw = p_s + warp * kMaxLen;

  for (int row = warp; row < len; row += kWarps) {
    const T* qrow = q + base + (size_t)row * hd;
    for (int d = lane; d < hd; d += 32) {
      qw[d] = round_to<T>(to_f32(qrow[d]) * scale);
    }
    __syncwarp();

    float s[kKeysPerLane];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -CUDART_INF_F;
      if (j < len) {
        const float* kr = k_s + j * ks;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qw[d], kr[d], acc);
        s[t] = round_to<T>(acc);
        m = fmaxf(m, s[t]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < len ? expf(s[t] - m) : 0.f;
      sum += s[t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < len) pw[j] = round_to<T>(s[t] / sum);
    }
    __syncwarp();

    T* orow = o + base + (size_t)row * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < len; ++j) acc = fmaf(pw[j], v_s[j * hd + d], acc);
      orow[d] = from_f32<T>(acc);
    }
    // qw and pw are rewritten for the next row
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int pairs, int len, int hd, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(len, hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  attention_kernel<T><<<pairs, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), len, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (pairs, len, hd) device arrays of one type;
// dtype 0 = float32, 1 = bfloat16. Launches on `stream` and returns the
// launch's error code without synchronising.
cudaError_t ribca_attention(const void* q, const void* k, const void* v,
                            void* o, int pairs, int len, int hd, float scale,
                            int dtype, void* stream) {
  if (pairs < 1 || len < 1 || len > kMaxLen || hd < 1 || hd > kMaxHeadDim) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, pairs, len, hd, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, pairs, len, hd, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ribca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// RMSNorm over the last axis: x (N, D) -> x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_kernel, and is
// also the model's norm (repro/models/layers.py:rmsnorm), which rounds in
// another place; `order` chooses:
//   0 "kernel": y = x * r * w in float32, one cast to x's dtype at the end
//               (the TPU kernel's contract);
//   1 "model":  n = (x * r) cast to x's dtype, then n * (w cast to x's
//               dtype), rounded to x's dtype (layers.rmsnorm).
// Statistics are float32 either way; r = 1 / sqrt(sum(x^2) / D + eps) with
// IEEE sqrt and divide.
//
// Bound on an H100: bytes. A row is read and written once (the second pass
// re-reads it from L1/L2, not device memory); at the decode step's shape,
// (64, 576) bf16, that is ~0.15 MB, far below one launch's latency, so the
// design is one launch and nothing else: one warp per row, lanes striding
// over D with coalesced loads, a shuffle reduction of the sum of squares.
// N, D and eps are run-time arguments; x and the output share a dtype
// (float32 or bfloat16), w has its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename TW>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const TW* __restrict__ w, T* __restrict__ out,
                               int N, int D, float eps, int model_order) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * D;
  T* orow = out + static_cast<size_t>(row) * D;

  float ss = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float xv = to_f(xr[c]);
    ss = fmaf(xv, xv, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);

  for (int c = lane; c < D; c += 32) {
    const float xv = to_f(xr[c]);
    float y;
    if (model_order) {
      const float n = to_f(from_f<T>(xv * r));
      const float wt = to_f(from_f<T>(to_f(w[c])));
      y = n * wt;  // exact in float32 for bf16 operands: one rounding below
    } else {
      y = xv * r * to_f(w[c]);
    }
    orow[c] = from_f<T>(y);
  }
}

template <typename T, typename TW>
int launch(const void* x, const void* w, void* out, int N, int D, float eps,
           int order, cudaStream_t stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T, TW><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w),
      static_cast<T*>(out), N, D, eps, order);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; order: 0 kernel, 1 model.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int N,
                             int D, float eps, int x_dtype, int w_dtype,
                             int order, void* stream) {
  if (N <= 0 || D <= 0 || (order != 0 && order != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, out, N, D, eps, order, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, out, N, D, eps, order, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, N, D, eps, order, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, N, D, eps, order,
                                                st);
  return static_cast<int>(cudaErrorInvalidValue);
}

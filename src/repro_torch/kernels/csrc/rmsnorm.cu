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
// Bound on an H100: bytes (each row read once and written once). At the
// decode step's shape, (64, 576) bf16, that is ~0.15 MB, far below one
// launch's latency; at the prefill's, (8192, 576), ~19 MB (~5.6 us). The
// design reads each row ONCE: one warp per row, the row held in
// registers as 16-byte vectors (8 bf16 or 4 float32 a lane per load; a row
// of D = 576 bf16 is 72 of them), the sum of squares reduced by shuffles,
// then normalised from the registers and stored as 16-byte vectors. w is
// read once per CTA into shared memory as float32, already in the form the
// order multiplies by, while the CTA's first rows are in flight. The
// launcher chooses the loads: vectors when x and the output are 16-byte
// aligned and D is a whole number of vectors, else one element a lane per
// load (D = 577, an offset view), through the same kernel. Rows too long
// for the registers (D above 4096 bf16 / 2048 float32 with vectors, 1024
// without) take a two-pass body that reads x twice (the second time from
// L1/L2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarps = 8;          // rows in flight per CTA
constexpr int kMaxBlocks = 1024;   // more rows: each warp strides over them
// loads a lane holds in registers: 16 vectors (64 registers of bf16 or
// float32) or 32 elements; more would spill
template <int kVec>
constexpr int max_iters() {
  return kVec == 1 ? 32 : 16;
}

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

// kVec elements loaded or stored at once (16 bytes when kVec > 1)
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

// Row r of x into a lane's registers: load i of lane l holds columns
// (i * 32 + l) * kVec ... + kVec - 1, the loads past D are skipped.
template <typename T, int kVec, int kIters>
__device__ __forceinline__ void load_row(Vec<T, kVec> (&buf)[kIters],
                                         const T* __restrict__ x, int r,
                                         int D, int lane) {
  const auto* xr =
      reinterpret_cast<const Vec<T, kVec>*>(x + static_cast<size_t>(r) * D);
#pragma unroll
  for (int i = 0; i < kIters; ++i)
    if ((i * 32 + lane) * kVec < D) buf[i] = xr[i * 32 + lane];
}

// One warp per row, the row in registers (load_row).
template <typename T, int kVec, int kIters>
__global__ void __launch_bounds__(kWarps * 32) rmsnorm_kernel(
    const T* __restrict__ x, const void* __restrict__ w, int w_bf16,
    T* __restrict__ out, int N, int D, float eps, int model_order) {
  extern __shared__ float ws[];  // D multipliers: w in the order's form
  using V = Vec<T, kVec>;
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);

  V buf[kIters];
  if (row < N) load_row(buf, x, row, D, lane);  // in flight while w is staged

  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float wf =
        w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c])
               : static_cast<const float*>(w)[c];
    ws[c] = model_order ? to_f(from_f<T>(wf)) : wf;
  }
  __syncthreads();  // no thread leaves before this: every warp stages w

  for (; row < N; row += step) {
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      if ((i * 32 + lane) * kVec < D) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xv = to_f(buf[i].v[e]);
          ss = fmaf(xv, xv, ss);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);

    V* orow = reinterpret_cast<V*>(out + static_cast<size_t>(row) * D);
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c0 = (i * 32 + lane) * kVec;
      if (c0 < D) {
        V o;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xv = to_f(buf[i].v[e]);
          // "model": exact in float32 for bf16 operands, one rounding below
          const float y = model_order ? to_f(from_f<T>(xv * r)) * ws[c0 + e]
                                      : xv * r * ws[c0 + e];
          o.v[e] = from_f<T>(y);
        }
        orow[i * 32 + lane] = o;
      }
    }
    if (row + step < N) load_row(buf, x, row + step, D, lane);
  }
}

// Rows longer than the registers hold: read x twice, w from device memory.
template <typename T, typename TW>
__global__ void __launch_bounds__(kWarps * 32) rmsnorm_two_pass_kernel(
    const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ out,
    int N, int D, float eps, int model_order) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
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
      y = n * wt;
    } else {
      y = xv * r * to_f(w[c]);
    }
    orow[c] = from_f<T>(y);
  }
}

// the argument struct: kernels/_build.py ARGS["repro_rmsnorm"]
struct RmsnormArgs {
  const void* x;
  const void* w;
  void* out;
  int N, D;
  float eps;
  int x_dtype, w_dtype, order;  // dtypes: 0 float32, 1 bfloat16
  void* stream;
};

// cudaLaunchKernel, whose return is the launch's error: the decode step
// makes 61 of these launches, and the <<<>>> form with cudaGetLastError
// costs the host more
template <typename T, int kVec, int kIters>
int launch_registers(const RmsnormArgs& a, cudaStream_t stream) {
  const int blocks = a.N / kWarps < kMaxBlocks
                         ? (a.N + kWarps - 1) / kWarps : kMaxBlocks;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const void* w = a.w;
  int w_bf16 = a.w_dtype, N = a.N, D = a.D, order = a.order;
  float eps = a.eps;
  void* args[] = {&x, &w, &w_bf16, &out, &N, &D, &eps, &order};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(rmsnorm_kernel<T, kVec, kIters>),
      dim3(blocks), dim3(kWarps * 32), args, sizeof(float) * a.D, stream));
}

// kIters: the smallest power of two that covers the row (iters is at most
// max_iters<kVec>())
template <typename T, int kVec>
int launch_vec(const RmsnormArgs& a, int iters, cudaStream_t stream) {
  if (iters <= 1) return launch_registers<T, kVec, 1>(a, stream);
  if (iters <= 2) return launch_registers<T, kVec, 2>(a, stream);
  if (iters <= 4) return launch_registers<T, kVec, 4>(a, stream);
  if (iters <= 8) return launch_registers<T, kVec, 8>(a, stream);
  if (iters <= 16 || kVec > 1) return launch_registers<T, kVec, 16>(a, stream);
  return launch_registers<T, 1, 32>(a, stream);
}

template <typename T, typename TW>
int launch_two_pass(const RmsnormArgs& a, cudaStream_t stream) {
  const int blocks = (a.N + kWarps - 1) / kWarps;
  rmsnorm_two_pass_kernel<T, TW><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const TW*>(a.w),
      static_cast<T*>(a.out), a.N, a.D, a.eps, a.order);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const RmsnormArgs& a) {
  cudaStream_t stream = static_cast<cudaStream_t>(a.stream);
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(a.x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.out) % 16 == 0) &&
                   (a.D % kVec == 0);
  const int per_load = vec ? 32 * kVec : 32;
  const int iters = (a.D + per_load - 1) / per_load;
  if (iters <= (vec ? max_iters<kVec>() : max_iters<1>()))
    return vec ? launch_vec<T, kVec>(a, iters, stream)
               : launch_vec<T, 1>(a, iters, stream);
  return a.w_dtype ? launch_two_pass<T, __nv_bfloat16>(a, stream)
                   : launch_two_pass<T, float>(a, stream);
}

}  // namespace

extern "C" int repro_rmsnorm_args_bytes() {
  return static_cast<int>(sizeof(RmsnormArgs));
}

extern "C" int repro_rmsnorm(const void* packed) {
  RmsnormArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.N <= 0 || a.D <= 0 || (a.order != 0 && a.order != 1) ||
      (a.x_dtype != 0 && a.x_dtype != 1) ||
      (a.w_dtype != 0 && a.w_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return a.x_dtype ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

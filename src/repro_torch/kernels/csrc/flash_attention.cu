// Blockwise (flash) attention: causal or not, GQA, float32 or bfloat16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_flash_kernel.
//
// What it computes: for each query row i of head h, over the keys j of kv
// head h / (H / Hkv) (no K/V replication), o_i = softmax_j(q_i . k_j) v_j,
// with q scaled in float32 before the product, masked scores -1e30, and the
// softmax done online over tiles of keys: running max m, denominator l and
// accumulator acc in float32, each tile rescaling the previous sums by
// exp(m_prev - m_new). The output is written once, in q's dtype. Key tiles
// wholly above the causal diagonal of the CTA's query rows are skipped.
//
// Bound on an H100: at the model's prefill shape (B=64, H=9, S=128, d=64,
// bf16) the inputs and output are ~25 MB against ~1.2 GFLOP of causal work,
// so bytes bound it (~7.5 us at 3.35 TB/s). This first design is the simple
// one: one CTA per (batch*head, 32 query rows), four warps, the Q rows, one
// 64-key K/V tile and the accumulators in shared memory (K rows padded to
// d+1 floats so a warp reading one column of 32 different keys hits 32
// banks), one warp per query row at a time, each lane scoring two keys and
// then owning d/32 output columns. It runs on the CUDA cores (fmaf), not the
// tensor cores; moving the two products to wgmma is later work.
//
// The K/V tile rows past the end of the sequence are zero-filled and their
// scores masked, so any S is taken. Strides (in elements) are arguments,
// so the model's (B, S, H, d) tensors are read in place as (B, H, S, d).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 32;                  // query rows per CTA
constexpr int kBK = 64;                  // keys per K/V tile (2 per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;

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

struct Strides {
  long long b, h, s;  // the last dimension is contiguous
};

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * D     // Q rows
                          + static_cast<size_t>(kBK) * (D + 1)  // K tile
                          + static_cast<size_t>(kBK) * D   // V tile
                          + static_cast<size_t>(kBQ) * D   // accumulators
                          + kWarps * kBK                   // probabilities
                          + 2 * kBQ);                      // m, l
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int S,
    int D, float scale, int causal, Strides qs, Strides ks, Strides vs,
    Strides os) {
  extern __shared__ float smem[];
  const int Dk = D + 1;
  float* Qs = smem;
  float* Ks = Qs + kBQ * D;
  float* Vs = Ks + kBK * Dk;
  float* Acc = Vs + kBK * D;
  float* Ps = Acc + kBQ * D;
  float* Ms = Ps + kWarps * kBK;
  float* Ls = Ms + kBQ;

  const int n_qblocks = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * kBQ;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, i = q0 + r;
    Qs[e] = i < S ? to_f(qp[i * qs.s + c]) * scale : 0.0f;
    Acc[e] = 0.0f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    Ms[r] = kNeg;
    Ls[r] = 0.0f;
  }

  // tiles wholly above the diagonal of this CTA's rows are never read
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      const bool in = kj < S;
      Ks[j * Dk + c] = in ? to_f(kp[kj * ks.s + c]) : 0.0f;
      Vs[e] = in ? to_f(vp[kj * vs.s + c]) : 0.0f;
    }
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;  // interleaved: balances causal work
      const int i = q0 + r;
      if (i >= S) continue;              // uniform across the warp
      const float* qrow = Qs + r * D;
      float s[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t, kj = k0 + j;
        const float* krow = Ks + j * Dk;
        float dot = 0.0f;
        for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], krow[c], dot);
        const bool keep = kj < S && (!causal || kj <= i);
        s[t] = keep ? dot : kNeg;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m_prev - m_new);
      float* pw = Ps + warp * kBK;
      pw[lane] = p0;
      pw[lane + 32] = p1;
      __syncwarp();  // p visible to the warp; every lane has read Ms[r]
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + psum;
      }
      float* arow = Acc + r * D;
      for (int c = lane; c < D; c += 32) {
        float pv = 0.0f;
        for (int j = 0; j < kBK; ++j) pv = fmaf(pw[j], Vs[j * D + c], pv);
        arow[c] = arow[c] * alpha + pv;
      }
      __syncwarp();  // p consumed before the next row overwrites it
    }
  }
  __syncthreads();
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, i = q0 + r;
    if (i < S) op[i * os.s + c] = from_f<T>(Acc[e] / fmaxf(Ls[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, int D, float scale, int causal, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  static bool configured = false;  // opt in to >48 KB of shared memory once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxD)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long blocks =
      static_cast<long long>(B) * H * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem_bytes(D),
                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, D, scale,
      causal, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int S, int D, float scale, int causal, int dtype,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || D <= 0 || D > kMaxD ||
      H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, Hkv, S, D, scale, causal, qs, ks,
                         vs, os, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D, scale, causal,
                                 qs, ks, vs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

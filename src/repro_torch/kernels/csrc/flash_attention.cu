// Blockwise (flash) attention: causal or not, GQA, float32 or bfloat16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_flash_kernel.
//
// What it computes: for each query row i of head h, over the keys j of kv
// head h / (H / Hkv) (no K/V replication), o_i = softmax_j(scale q_i . k_j)
// v_j, masked scores -1e30, and the softmax done online over tiles of keys:
// running max m, denominator l and accumulator acc in float32, each tile
// rescaling the previous sums by exp(m_prev - m_new). The output is written
// once, in q's dtype. Key tiles wholly above the causal diagonal of the
// CTA's query rows are skipped. K/V rows past the end of the sequence are
// zero-filled and their scores masked, so any S is taken. Strides (in
// elements) are arguments, so the model's (B, S, H, d) tensors are read in
// place as (B, H, S, d).
//
// Bound on an H100: at the model's prefill shape (B=64, H=9, S=128, d=64,
// bf16) the inputs and output are ~25 MB against ~1.2 GFLOP of causal work,
// so bytes bound it (~7.5 us at 3.35 TB/s). Two bodies, chosen by the
// wrapper from the dtype and head dim alone (flash_attention.body_for):
//
// * flash_tc_kernel, bf16, d in {32, 64, 80, 96, 112, 128} (one instance each):
//   FlashAttention-2's structure on the tensor cores. One CTA per (batch *
//   head, 64 query rows), the late (causally heavy) query blocks first in
//   the grid; four warps, each owning 16 query rows. cp.async copies 16
//   bytes a thread straight from the strided tensors into bf16 shared
//   memory, rows padded by 16 bytes so every ldmatrix is free of bank
//   conflicts; K/V tiles of 64 keys are double-buffered (tile j+1 loads
//   while tile j is consumed). Both products are mma.sync m16n8k16 bf16
//   with float32 accumulators: S = Q K^T with Q's and K's fragments by
//   ldmatrix; O += P V with P converted in registers from S's float32
//   accumulators to bf16 (the m16n8 C layout is the m16n8k16 A layout, so
//   P never touches shared memory) and V's fragments by ldmatrix.trans.
//   The scale is applied to the float32 scores (times log2 e, for the
//   special-function unit's exp2); the row max and sum stay in registers,
//   reduced over each quad of lanes by shuffles. P in bf16 is the one
//   rounding the TPU kernel does not have (every product there is
//   float32); l sums P before that rounding, as FlashAttention-2 does. The
//   output goes through shared memory and out as 16-byte row chunks. At
//   S = 128 a CTA sees at most two key tiles and its copy-in and store-out
//   weigh as much as its products, so the design keeps those lean (one
//   reciprocal of l a row, whole-row stores); mma.sync and not wgmma/TMA,
//   since the work is bytes-bound, a deeper ring would have nothing to
//   overlap, and ldmatrix/cp.async take the strided inputs without tensor
//   maps.
// * flash_kernel, every other case (float32 at any d <= 256, bf16 at
//   another d): the CUDA cores, exact float32 products (fmaf), q scaled in
//   float32 before the product. One CTA per (batch*head, 32 query rows),
//   four warps, the Q rows, one 64-key K/V tile and the accumulators in
//   shared memory as float32 (K rows padded to d+1 floats so a warp reading
//   one column of 32 different keys hits 32 banks), one warp per query row
//   at a time, each lane scoring two keys and then owning d/32 output
//   columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <cstring>

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

// ---------------------------------------------------- tensor-core body ----
namespace tc {

constexpr int kBQ = 64;        // query rows per CTA: 4 warps x 16
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kPad = 8;        // bf16 of padding per shared row: 16 bytes

template <int D>
constexpr size_t smem_bytes() {  // Q, then two stages of K and of V
  return sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * (D + kPad);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `in` false fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof u);
  return u;
}

// 2^x by the special-function unit (ex2.approx.ftz: ~2 ulp, results below
// 2^-126 flushed to 0); its arguments are <= 0 here, its results weights
// in [0, 1] that are rounded to bf16 next
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows r0 .. r0+63 of a (S, D) matrix with row stride `ld_g` into shared
// memory (row stride D + kPad), one 16-byte cp.async per thread and step;
// rows past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld_g, int r0, int S,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = r0 + r < S;
    cp_async16(smem_addr(dst + r * (D + kPad) + col),
               in ? src + (r0 + r) * ld_g + col : src, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int Hkv, int S, float scale_log2, int causal, Strides qs,
    Strides ks, Strides vs, Strides os) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) uint4 tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* Ks = Qs + kBQ * LD;      // two stages
  __nv_bfloat16* Vs = Ks + 2 * kBK * LD;  // two stages

  // the late query blocks, which see the most keys, come first in the grid
  const int n_qblocks = (S + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_qblocks;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qblocks - 1 - static_cast<int>(blockIdx.x) / BH) * kBQ;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // fragment row, column pair
  const int row0 = q0 + warp * 16 + g;      // this lane's rows: row0, +8

  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* op = o + b * os.b + h * os.h;

  // tiles wholly above the diagonal of this CTA's rows are never read
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  load_tile<D>(Qs, qp, qs.s, q0, S, tid);
  load_tile<D>(Ks, kp, ks.s, 0, S, tid);
  load_tile<D>(Vs, vp, vs.s, 0, S, tid);
  cp_async_commit();

  float acc[D / 8][4] = {};
  // rows row0 and row0 + 8: running max (of scores scaled by log2 e), and
  // this lane's part of the denominator (summed over the quad at the end)
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile loads while this one is used
      load_tile<D>(Ks + (stage ^ 1) * kBK * LD, kp, ks.s, (t + 1) * kBK, S,
                   tid);
      load_tile<D>(Vs + (stage ^ 1) * kBK * LD, vp, vs.s, (t + 1) * kBK, S,
                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and at t = 0, Q) visible to every warp
    const __nv_bfloat16* Kt = Ks + stage * kBK * LD;
    const __nv_bfloat16* Vt = Vs + stage * kBK * LD;

    // S = Q K^T: 16 rows x 64 keys a warp, as 8 m16n8 tiles; Q's
    // fragments by ldmatrix from shared memory each tile (holding them in
    // registers costs more than the four loads)
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];  // b0, b1 of keys np*16 .. +7, then of +8 .. +15
        ldsm_x4(kb, smem_addr(Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       LD +
                              kk * 16 + ((lane >> 3) & 1) * 8));
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax; element e of tile j is row
    // row0 + 8 * (e >> 1), key k0 + 8 j + 2 tig + (e & 1)
    const int k0 = t * kBK;
    const bool masked = k0 + kBK > S ||
                        (causal && k0 + kBK - 1 > q0 + warp * 16);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= S || (causal && key > row)) x = kNeg;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    if (t > 0) {  // at t = 0 the accumulators are still zero
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // O += P V, 16 keys at a time: P's A fragment from S tiles 2kk, 2kk+1,
    // rounded to bf16; the denominator sums P before the rounding
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_approx(s[2 * kk][e] - m[e >> 1]);
        p[4 + e] = exp2_approx(s[2 * kk + 1][e] - m[e >> 1]);
      }
      const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                              pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
      l[0] += (p[0] + p[1]) + (p[4] + p[5]);
      l[1] += (p[2] + p[3]) + (p[6] + p[7]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];  // b0, b1 of dims dp*16 .. +7, then of +8 .. +15
        ldsm_x4_trans(vb, smem_addr(Vt + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) *
                                             LD +
                                    dp * 16 + (lane >> 4) * 8));
        mma(acc[2 * dp], pa, vb[0], vb[1]);
        mma(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage (and Q) is consumed
  }

  // O / l, rounded to bf16, through shared memory (Q's rows: the loop's
  // last barrier has passed), then stored as 16-byte row chunks
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  const int r_s = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(Qs + r_s * LD + col) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Qs + (r_s + 8) * LD + col) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(op + (q0 + r) * os.s + col) =
          *reinterpret_cast<const uint4*>(Qs + r * LD + col);
  }
}

template <int D>
cudaError_t configure() {  // opt in to >48 KB of shared memory once
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>()));
  configured = err == cudaSuccess;
  return err;
}

template <int D>
cudaError_t blocks_per_sm(int* n) {
  cudaError_t err = configure<D>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, flash_tc_kernel<D>, kThreads, smem_bytes<D>());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, float scale, int causal, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * H * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_tc_kernel<D><<<static_cast<unsigned>(blocks), kThreads,
                       smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Hkv, S, scale * 1.4426950408889634f, causal, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// the argument struct: kernels/_build.py ARGS["repro_flash_attention"] and
// ["repro_flash_attention_tc"]
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, S, D;
  float scale;
  int causal;
  int dtype;  // 0 float32, 1 bfloat16 (q, k, v and o share it)
  long long strides[12];  // (batch, head, seq) of q, k, v, o, in elements
  void* stream;
};

bool valid(const FlashArgs& a) {
  return a.B > 0 && a.H > 0 && a.Hkv > 0 && a.S > 0 && a.D > 0 &&
         a.D <= kMaxD && a.H % a.Hkv == 0;
}

}  // namespace

extern "C" int repro_flash_attention_args_bytes() {
  return static_cast<int>(sizeof(FlashArgs));
}
extern "C" int repro_flash_attention_tc_args_bytes() {
  return static_cast<int>(sizeof(FlashArgs));
}

// The CUDA-core body: float32 or bfloat16, any head dim up to kMaxD.
extern "C" int repro_flash_attention(const void* packed) {
  FlashArgs a;
  memcpy(&a, packed, sizeof a);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = a.strides;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t stream = static_cast<cudaStream_t>(a.stream);
  if (a.dtype == 0)
    return launch<float>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S, a.D,
                         a.scale, a.causal, qs, ks, vs, os, stream);
  if (a.dtype == 1)
    return launch<__nv_bfloat16>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S,
                                 a.D, a.scale, a.causal, qs, ks, vs, os,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident CTAs of the tensor-core body per SM at head dim D (its registers
// and dynamic shared memory), or -1 for a D without an instance.
extern "C" int repro_flash_attention_tc_blocks_per_sm(int D) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 32:
      err = tc::blocks_per_sm<32>(&n);
      break;
    case 64:
      err = tc::blocks_per_sm<64>(&n);
      break;
    case 80:
      err = tc::blocks_per_sm<80>(&n);
      break;
    case 96:
      err = tc::blocks_per_sm<96>(&n);
      break;
    case 112:
      err = tc::blocks_per_sm<112>(&n);
      break;
    case 128:
      err = tc::blocks_per_sm<128>(&n);
      break;
  }
  return err == cudaSuccess ? n : -1;
}

// Dynamic shared memory of one CTA of the tensor-core body at head dim D,
// in bytes, or -1 for a D without an instance.
extern "C" int repro_flash_attention_tc_smem_bytes(int D) {
  switch (D) {
    case 32:
      return static_cast<int>(tc::smem_bytes<32>());
    case 64:
      return static_cast<int>(tc::smem_bytes<64>());
    case 80:
      return static_cast<int>(tc::smem_bytes<80>());
    case 96:
      return static_cast<int>(tc::smem_bytes<96>());
    case 112:
      return static_cast<int>(tc::smem_bytes<112>());
    case 128:
      return static_cast<int>(tc::smem_bytes<128>());
  }
  return -1;
}

// The tensor-core body: bfloat16, head dim 32, 64, 80, 96, 112 or 128, every
// row of q, k, v and o starting on 16 bytes.
extern "C" int repro_flash_attention_tc(const void* packed) {
  FlashArgs a;
  memcpy(&a, packed, sizeof a);
  if (!valid(a) || a.dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  uintptr_t align = reinterpret_cast<uintptr_t>(a.q) |
                    reinterpret_cast<uintptr_t>(a.k) |
                    reinterpret_cast<uintptr_t>(a.v) |
                    reinterpret_cast<uintptr_t>(a.o);
  for (long long s : a.strides) align |= static_cast<uintptr_t>(s) * 2;
  if (align % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long* st = a.strides;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t stream = static_cast<cudaStream_t>(a.stream);
  switch (a.D) {
    case 32:
      return tc::launch<32>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S, a.scale,
                            a.causal, qs, ks, vs, os, stream);
    case 64:
      return tc::launch<64>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S, a.scale,
                            a.causal, qs, ks, vs, os, stream);
    case 80:
      return tc::launch<80>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S, a.scale,
                            a.causal, qs, ks, vs, os, stream);
    case 96:
      return tc::launch<96>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S, a.scale,
                            a.causal, qs, ks, vs, os, stream);
    case 112:
      return tc::launch<112>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S,
                             a.scale, a.causal, qs, ks, vs, os, stream);
    case 128:
      return tc::launch<128>(a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S,
                             a.scale, a.causal, qs, ks, vs, os, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

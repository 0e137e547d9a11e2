// Fused UCT score + masked first-index argmax over a (W, C) child tile.
//
// Replaces the TPU kernel repro/kernels/uct_select.py:_uct_kernel.
//
// Bound on an H100: launch latency. At the search's shapes (W = 256 rows,
// C = 121 slots) the tile is ~0.6 MB, which the card's memory moves in a
// fraction of a microsecond, and the arithmetic is a dozen float operations
// per slot; neither approaches the few microseconds a launch costs. The
// design therefore keeps the whole selection in ONE launch with no padding
// and no intermediate in device memory: one warp owns one row, its lanes
// stride over the C slots with coalesced loads, each lane keeps its best
// (score, slot) in registers, and a shuffle reduction picks the row's
// winner with the rule "greater score, else lower slot" so ties go to the
// first maximal index exactly as argmax does. W, C and cp are run-time
// arguments; `valid` and `lane_mask` are read as bytes.
//
// Arithmetic mirrors the plain PyTorch version operation for operation
// (IEEE divide and sqrt, logf, separate multiply and add): build WITHOUT
// --use_fast_math and WITH -fmad=false.

#include <cuda_runtime.h>
#include <cstring>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kBig = 1e30f;

__global__ void uct_select_kernel(
    const float* __restrict__ wins, const float* __restrict__ visits,
    const float* __restrict__ vloss, const float* __restrict__ parent_total,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ noise,              // may be null
    const unsigned char* __restrict__ lane_mask,  // may be null
    float cp, int W, int C, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= W) return;  // whole warp leaves together

  const bool live = lane_mask == nullptr || lane_mask[row] != 0;
  const float log_np = logf(fmaxf(parent_total[row], 1.0f));
  const size_t base = static_cast<size_t>(row) * C;

  float best = -CUDART_INF_F;
  int best_j = INT_MAX;
  for (int j = lane; j < C; j += 32) {
    const float nz = noise != nullptr ? noise[base + j] : 0.0f;
    const float n_j = visits[base + j] + vloss[base + j];
    const float d = fmaxf(n_j, 1.0f);
    const float x_j = wins[base + j] / d;
    const float explore = cp * sqrtf(log_np / d);
    float s = (x_j + explore) + nz;
    if (n_j <= 0.0f) s = kBig + nz;                  // unvisited first
    if (!live || valid[base + j] == 0) s = -kBig;    // masked slots last
    if (s > best) {  // strict: a lane's slots ascend, the first maximum stays
      best = s;
      best_j = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, best, off);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
    if (o > best || (o == best && oj < best_j)) {
      best = o;
      best_j = oj;
    }
  }
  if (lane == 0) out[row] = best_j;
}

}  // namespace

namespace {
// the argument struct: kernels/_build.py ARGS["repro_uct_select"]
struct UctArgs {
  const void* wins;
  const void* visits;
  const void* vloss;
  const void* parent_total;
  const void* valid;
  const void* noise;      // null: none
  const void* lane_mask;  // null: all lanes live
  float cp;
  int W, C;
  void* out;
  void* stream;
};
}  // namespace

extern "C" int repro_uct_select_args_bytes() {
  return static_cast<int>(sizeof(UctArgs));
}

extern "C" int repro_uct_select(const void* packed) {
  UctArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.W <= 0 || a.C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a.W + kWarpsPerBlock - 1) / kWarpsPerBlock;
  uct_select_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float*>(a.wins), static_cast<const float*>(a.visits),
      static_cast<const float*>(a.vloss),
      static_cast<const float*>(a.parent_total),
      static_cast<const unsigned char*>(a.valid),
      static_cast<const float*>(a.noise),
      static_cast<const unsigned char*>(a.lane_mask), a.cp, a.W, a.C,
      static_cast<int*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

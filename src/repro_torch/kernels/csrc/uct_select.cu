// Fused UCT score + masked first-index argmax over a (W, C) child tile, and
// the whole lockstep descent of a selection round in one launch.
//
// Replaces the TPU kernel repro/kernels/uct_select.py:_uct_kernel.
//
// uct_select_kernel (one tile). Bound on an H100: launch latency. At the
// search's shapes (W = 256 rows, C = 121 slots) the tile is ~0.6 MB, which
// the card's memory moves in a fraction of a microsecond, and the
// arithmetic is a dozen float operations per slot; neither approaches the
// few microseconds a launch costs. The design therefore keeps the whole
// selection in ONE launch with no padding and no intermediate in device
// memory: one warp owns one row, its lanes stride over the C slots with
// coalesced loads, each lane keeps its best (score, slot) in registers, and
// a shuffle reduction picks the row's winner with the rule "greater score,
// else lower slot" so ties go to the first maximal index exactly as argmax
// does. W, C and cp are run-time arguments; `valid` and `lane_mask` are
// read as bytes.
//
// select_descent_kernel (a whole selection round: what core/gscpm.py's
// level loop does with one child_stat_tile gather, one threefry noise draw
// and one uct_select launch per level, and one host read to end it). The
// tile kernel's bound is far below a launch, so what the search lost was
// the ~490 eager launches around it per level. Here one warp walks one
// lane from the root to its leaf with the level loop inside the kernel: it
// reads the tree's tensors in place (the tree is read-only during a round:
// virtual loss is added between rounds), draws each slot's tie-break noise
// in registers (threefry.cuh: noise_scale * uniform(fold_in(key, depth),
// j)), scores the children with the same uct_score as the tile kernel, and
// places each picked child's move on the lane's board in shared memory.
// Bound: a chain of dependent gathers (node -> child row -> child stats ->
// pick -> move) per level, a few hundred nanoseconds each; the bytes and
// operations are far below a microsecond. No host read, no lane waits for
// another: each warp stops at its own leaf.
//
// Arithmetic mirrors the plain PyTorch version operation for operation
// (IEEE divide and sqrt, logf, separate multiply and add): build WITHOUT
// --use_fast_math and WITH -fmad=false.

#include <cuda_runtime.h>
#include <cstring>
#include <climits>
#include <math_constants.h>

#include "threefry.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kBig = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// UCT score of one child slot (paper eq. 1, virtual loss in n_j), with its
// tie-break noise: the one spelling both kernels use.
__device__ __forceinline__ float uct_score(float wins, float visits,
                                           float vloss, float log_np,
                                           float cp, float noise) {
  const float n_j = visits + vloss;
  const float d = fmaxf(n_j, 1.0f);
  const float x_j = wins / d;
  const float explore = cp * sqrtf(log_np / d);
  float s = (x_j + explore) + noise;
  if (n_j <= 0.0f) s = kBig + noise;  // unvisited first
  return s;
}

// (best, best_j) of the whole warp in every lane: "greater score, else
// lower slot", a total order, so the butterfly gives all lanes the
// first-index argmax
__device__ __forceinline__ void warp_argmax(float& best, int& best_j) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, best, off);
    const int oj = __shfl_xor_sync(kFullMask, best_j, off);
    if (o > best || (o == best && oj < best_j)) {
      best = o;
      best_j = oj;
    }
  }
}

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
    float s = uct_score(wins[base + j], visits[base + j], vloss[base + j],
                        log_np, cp, nz);
    if (!live || valid[base + j] == 0) s = -kBig;    // masked slots last
    if (s > best) {  // strict: a lane's slots ascend, the first maximum stays
      best = s;
      best_j = j;
    }
  }
  warp_argmax(best, best_j);
  if (lane == 0) out[row] = best_j;
}

constexpr int kMaxCells = 625;   // boards up to 25 x 25

__global__ void select_descent_kernel(
    const int* __restrict__ children, const int* __restrict__ n_children,
    const float* __restrict__ wins, const float* __restrict__ visits,
    const float* __restrict__ vloss, const int* __restrict__ move,
    const int* __restrict__ to_move,
    const signed char* __restrict__ root_board,
    const long long* __restrict__ noise_keys, float cp, float noise_scale,
    int max_depth, int E, int W, int C, int n, int cap,
    int* __restrict__ paths, int* __restrict__ depths,
    int* __restrict__ leaves, int* __restrict__ n_empty,
    signed char* __restrict__ boards) {
  __shared__ signed char board_of[kWarpsPerBlock][kMaxCells];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarpsPerBlock + warp;  // lane of the forest
  if (w >= E * W) return;  // whole warp leaves together
  signed char* board = board_of[warp];

  // lane w belongs to member w / W: every tree read is offset by the
  // member's (cap + 1) rows; node ids stay member-local
  const int e = w / W;
  const size_t rows = static_cast<size_t>(e) * (cap + 1);
  children += rows * C;
  n_children += rows;
  wins += rows;
  visits += rows;
  vloss += rows;
  move += rows;
  to_move += rows;
  root_board += static_cast<size_t>(e) * n;

  int empties = 0;
  for (int i = lane; i < n; i += 32) {
    const signed char c = root_board[i];
    board[i] = c;
    empties += c == 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    empties += __shfl_xor_sync(kFullMask, empties, off);

  const bool noisy = noise_scale > 0.0f;
  const threefry::Key key =
      noisy ? threefry::read_key(noise_keys, w) : threefry::Key{0u, 0u};
  int* path = paths + static_cast<size_t>(w) * max_depth;
  int node = 0, depth = 0;
  for (;;) {
    // the stop rule of the plain level loop: a node is descended through
    // only when its children cover every empty cell (so a terminal node,
    // with no empty cell, stops the lane), and not past the depth cap
    const int n_kids = n_children[node];
    if (!(n_kids == empties && empties != 0 && depth < max_depth - 2)) break;
    const float log_np = logf(fmaxf(visits[node] + vloss[node], 1.0f));
    const int* row = children + static_cast<size_t>(node) * C;
    const threefry::Key level_key =
        noisy ? threefry::fold_in(key, static_cast<uint32_t>(depth)) : key;
    float best = -CUDART_INF_F;
    int best_j = INT_MAX, best_child = cap;
    // the valid slots only: an invalid slot's -1e30 never wins while one
    // valid slot exists, and a fully expanded node has n_kids >= 1
    for (int j = lane; j < min(n_kids, C); j += 32) {
      const int c = row[j];
      const float nz =
          noisy ? noise_scale * threefry::uniform(level_key, j) : 0.0f;
      const float s = uct_score(wins[c], visits[c], vloss[c], log_np, cp, nz);
      if (s > best) {
        best = s;
        best_j = j;
        best_child = c;
      }
    }
    warp_argmax(best, best_j);
    // the winning slot is its owner lane's own best
    const int child = __shfl_sync(kFullMask, best_child, best_j & 31);
    if (lane == 0) {
      const int mv = move[child];
      if (mv >= 0 && mv < n) board[mv] = static_cast<signed char>(to_move[node]);
      path[depth + 1] = child;
    }
    __syncwarp();
    node = child;
    ++depth;
    --empties;
  }

  signed char* out_board = boards + static_cast<size_t>(w) * n;
  for (int i = lane; i < n; i += 32) out_board[i] = board[i];
  for (int d = depth + 1 + lane; d < max_depth; d += 32) path[d] = cap;
  if (lane == 0) {
    path[0] = 0;
    depths[w] = depth;
    leaves[w] = node;
    n_empty[w] = empties;
  }
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

namespace {
// the argument struct: kernels/_build.py ARGS["repro_select_descent"]
struct DescentArgs {
  const void* children;
  const void* n_children;
  const void* wins;
  const void* visits;
  const void* vloss;
  const void* move;
  const void* to_move;
  const void* root_board;
  const void* noise_keys;
  float cp, noise_scale;
  int max_depth, E, W, C, n, cap;
  void* paths;
  void* depths;
  void* leaves;
  void* n_empty;
  void* boards;
  void* stream;
};
}  // namespace

extern "C" int repro_select_descent_args_bytes() {
  return static_cast<int>(sizeof(DescentArgs));
}

extern "C" int repro_select_descent(const void* packed) {
  DescentArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.E <= 0 || a.W <= 0 || a.C <= 0 || a.n <= 0 || a.n > kMaxCells ||
      a.cap <= 0 || a.max_depth <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(a.E) * a.W;
  if (lanes > INT_MAX - kWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks =
      static_cast<int>((lanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  select_descent_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const int*>(a.children),
      static_cast<const int*>(a.n_children),
      static_cast<const float*>(a.wins), static_cast<const float*>(a.visits),
      static_cast<const float*>(a.vloss), static_cast<const int*>(a.move),
      static_cast<const int*>(a.to_move),
      static_cast<const signed char*>(a.root_board),
      static_cast<const long long*>(a.noise_keys), a.cp, a.noise_scale,
      a.max_depth, a.E, a.W, a.C, a.n, a.cap, static_cast<int*>(a.paths),
      static_cast<int*>(a.depths), static_cast<int*>(a.leaves),
      static_cast<int*>(a.n_empty), static_cast<signed char*>(a.boards));
  return static_cast<int>(cudaGetLastError());
}

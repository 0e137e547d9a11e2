// The move proposal of a sync iteration in one launch: per lane, a
// uniformly random legal move that the lane's leaf has no child for yet.
//
// Replaces no TPU kernel. The JAX reference's propose_move
// (repro/core/gscpm.py) is jnp plus jax.random.uniform, which XLA fuses;
// the port's plain version (kernels/ref.py:propose_move) runs it eagerly:
// rng.uniform(key, n) over (N, n) counters is ~175 int64 launches, each
// streaming the whole (N, n) int64 array through device memory, then the
// tried-move gather, a scatter into an (N, n + 1) mask and the argmax. In
// the benchmark's Hex cell (N = 1,024 x 256 lanes, n = 121) that eager draw
// was 78 % of the card's busy time and its int64 temporaries 1.7 GiB of the
// peak.
//
// One warp owns one lane; thread t of the warp owns cells t, t + 32, ...
// (4 a thread on 11x11, 8 on 15x15, 20 on 25x25), so cell c is bit t of
// word c / 32 of a per-warp bitmask in shared memory:
//
//   1. tried moves  the leaf's first n_children[leaf] slots (the `valid`
//                   cut of the plain version), each child's move set in
//                   the bitmask with a shared atomicOr
//   2. the draw     each thread draws threefry::uniform(key, c) for its
//                   untried legal cells only: element c of rng.uniform(key,
//                   n); a masked cell scores -1, as torch.where(untried, u,
//                   -1.0) gives it, and needs no draw
//   3. the argmax   (value, cell) kept in registers, each thread scanning
//                   its cells in ascending order with a strict compare;
//                   then a butterfly over the warp with the rule "greater
//                   value, else lower cell", a total order, so every thread
//                   ends with torch.argmax's first maximal index
//   4. the output   thread 0 writes the cell, or -1 (NO_NODE) when no cell
//                   was both legal and untried (a terminal leaf, whose
//                   legal mask is all false, or a fully expanded one)
//
// The result is bit for bit the plain version's: the same draws, the same
// values, the same tie rule. The game's rules stay out of the kernel: the
// caller passes the game's own (N, n) legal mask (Hex: the empty cells;
// Gomoku: the empty cells, none once a five stands).
//
// Inputs are read in place: the flat E·(cap + 1)-row fields children,
// n_children and move of a tree or forest (lane l belongs to member
// l / (N / E) and its leaf is member-local), the (N,) int32 leaves, the
// (N, n) legal bytes, and the keys through their lane stride (the search's
// move keys are a view of its (…, 3, 2) key split: no copy).
//
// Bound on an H100: operations. ~123 integer operations a uniform
// (threefry's 20 rounds and its key schedule) over at most N·n uniforms:
// 3.9 G operations for the Hex cell, ~0.06 ms at 67 T/s, then launch
// latency. Bytes: the legal mask, the leaves' child rows and moves, the
// keys and the output, ~35 MB there (~0.01 ms at 3.35 TB/s). n is a
// run-time argument (1 <= n <= kMaxCells).

#include <cuda_runtime.h>
#include <climits>
#include <cstring>

#include "threefry.cuh"

namespace {

constexpr int kMaxCells = 625;                   // boards up to 25 x 25
constexpr int kMaxWords = (kMaxCells + 31) / 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNoNode = -1;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) propose_move_kernel(
    const int* __restrict__ children, const int* __restrict__ n_children,
    const int* __restrict__ move, const int* __restrict__ leaves,
    const unsigned char* __restrict__ legal,
    const long long* __restrict__ keys, long long key_stride, int N,
    int members, int rows, int C, int n, int* __restrict__ out) {
  __shared__ unsigned tried_words[kWarpsPerBlock][kMaxWords];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lane =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (lane >= N) return;  // the whole warp leaves together

  unsigned* tried = tried_words[warp];
  const int words = (n + 31) >> 5;
  if (t < words) tried[t] = 0u;
  __syncwarp();

  // 1. the tried moves: children of the leaf's row, read in place
  const long long base =
      static_cast<long long>(lane / (N / members)) * rows;
  const long long row = base + leaves[lane];
  const int kids = min(max(n_children[row], 0), C);
  for (int s = t; s < kids; s += 32) {
    const int m = move[base + children[row * C + s]];
    if (m >= 0 && m < n) atomicOr(&tried[m >> 5], 1u << (m & 31));
  }
  __syncwarp();

  // 2-3. the draw and the thread's first maximum over its cells
  const threefry::Key key{
      static_cast<uint32_t>(keys[lane * key_stride]),
      static_cast<uint32_t>(keys[lane * key_stride + 1])};
  const unsigned char* lg = legal + lane * n;
  float best = -1.0f;
  int best_c = INT_MAX;
  for (int w = 0; w < words; ++w) {
    const int c = (w << 5) + t;
    if (c < n && lg[c] != 0 && ((tried[w] >> t) & 1u) == 0u) {
      const float u = threefry::uniform(key, static_cast<uint32_t>(c));
      if (u > best) {
        best = u;
        best_c = c;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, best, off);
    const int oc = __shfl_xor_sync(kFullMask, best_c, off);
    if (o > best || (o == best && oc < best_c)) {
      best = o;
      best_c = oc;
    }
  }

  // 4. uniforms lie in [0, 1): a value below 0 means no untried legal cell
  if (t == 0) out[lane] = best >= 0.0f ? best_c : kNoNode;
}

// the argument struct: kernels/_build.py ARGS["repro_propose_move"]
struct ProposeMoveArgs {
  const void* children;
  const void* n_children;
  const void* move;
  const void* leaves;
  const void* legal;
  const void* keys;
  long long key_stride;  // elements between two lanes' keys
  int N, E, rows, C, n;
  void* out;
  void* stream;
};

}  // namespace

extern "C" int repro_propose_move_args_bytes() {
  return static_cast<int>(sizeof(ProposeMoveArgs));
}

extern "C" int repro_propose_move(const void* packed) {
  ProposeMoveArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.N <= 0 || a.E <= 0 || a.N % a.E != 0 || a.rows < 2 || a.C < 1 ||
      a.n < 1 || a.n > kMaxCells || a.key_stride < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a.N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  propose_move_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const int*>(a.children),
      static_cast<const int*>(a.n_children), static_cast<const int*>(a.move),
      static_cast<const int*>(a.leaves),
      static_cast<const unsigned char*>(a.legal),
      static_cast<const long long*>(a.keys), a.key_stride, a.N, a.E, a.rows,
      a.C, a.n, static_cast<int*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

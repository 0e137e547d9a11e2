// Batched Hex winner by pointer-doubling connected components, and the
// whole playout (random fill + winner) in one launch.
//
// Replaces the TPU kernel repro/kernels/hex_winner.py:_winner_kernel.
//
// Bound on an H100: launch latency, then operations. A (256, 121) int8
// batch is 31 KB in and 256 bytes out; the work is ~20 integer operations
// per cell per round on shared memory. The TPU kernel had no gather, so it
// spelled the scatter-min and the pointer jump as one-hot (C, C)
// reductions; that is not carried over. Here one CTA owns one board and
// keeps the stone mask and three label arrays in shared memory
// (black_winner, which both kernels call):
//
//   per round (exactly `rounds` of them, no convergence test):
//     1. gather hook   M[i] = min(P[i], P[nbr]) over the six in-bounds
//                      same-colour neighbours, by indexed shared loads
//     2. scatter hook  Q = P; atomicMin(&Q[P[i]], M[i]); atomicMin(&Q[i], M[i])
//                      (roots adopt the best label their subtree saw — the
//                      step that keeps convergence O(log n) on snake and
//                      comb boards; do not drop it)
//     3. jump          P[i] = Q[Q[i]]
//   with a barrier between phases, so every phase reads only what the
//   phase before it finished writing: the labels after each round are
//   exactly those of the plain version, and the fixed round budget that
//   was validated for it holds here.
//
// Then the roots of top-row black cells are marked and the bottom row is
// tested. The result is exact: any correct connectivity gives the same
// bits. `size` is a run-time argument (n = size*size <= kMaxCells).
//
// hex_winner_kernel takes FILLED boards. hex_playout_kernel takes the
// leaf boards of a sync iteration and does the whole playout: what the
// plain path spreads over ~190 eager launches (a threefry draw, the
// (W, n, n) rank compare of core/game.py:empty_fill_ranks, the parity
// colours) before its one connectivity launch. Per CTA: the board's n
// uniforms go to shared memory (threefry.cuh, uniform(key, i) at counter
// (0, i), the stream rng.uniform(key, n) gives); each empty cell counts
// its rank #{empty j : (u_j, j) < (u_i, i)} over shared memory (the same
// index tie-break), takes colour to_move on an even rank and 3 - to_move
// on an odd one; then black_winner. The (W, n, n) compare never reaches
// device memory; the filled board is written out only when asked for.

#include <cuda_runtime.h>
#include <cstring>

#include "threefry.cuh"

namespace {

constexpr int kMaxCells = 625;   // boards up to 25 x 25
constexpr int kThreads = 128;

// The winner of the filled board whose BLACK stones `black` marks (written
// by the caller before the call): 1 if black joins top and bottom, else 2.
// Every thread of the CTA calls it; P, Q, M and *reached are scratch.
__device__ signed char black_winner(const unsigned char* black, int* P,
                                    int* Q, int* M, int* reached, int size,
                                    int rounds) {
  const int n = size * size;
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) P[i] = i;  // non-black: inert loops
  if (tid == 0) *reached = 0;
  __syncthreads();

  const int dr[6] = {-1, -1, 0, 0, 1, 1};
  const int dc[6] = {0, 1, -1, 1, -1, 0};

  for (int round = 0; round < rounds; ++round) {
    for (int i = tid; i < n; i += kThreads) {
      int m = P[i];
      if (black[i]) {
        const int r = i / size, c = i - r * size;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int rr = r + dr[k], cc = c + dc[k];
          if (rr >= 0 && rr < size && cc >= 0 && cc < size) {
            const int j = rr * size + cc;
            if (black[j]) m = min(m, P[j]);
          }
        }
      }
      M[i] = m;
      Q[i] = P[i];
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int m = M[i];
      atomicMin(&Q[P[i]], m);
      atomicMin(&Q[i], m);
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) P[i] = Q[Q[i]];
    __syncthreads();
  }

  // black connects top<->bottom iff a bottom black cell's component root
  // is also some top black cell's root
  for (int i = tid; i < n; i += kThreads) M[i] = 0;
  __syncthreads();
  for (int i = tid; i < size; i += kThreads)
    if (black[i]) M[P[i]] = 1;
  __syncthreads();
  for (int i = n - size + tid; i < n; i += kThreads)
    if (black[i] && M[P[i]]) *reached = 1;
  __syncthreads();
  return *reached ? 1 : 2;
}

__global__ void hex_winner_kernel(const signed char* __restrict__ boards,
                                  int size, int rounds,
                                  signed char* __restrict__ out) {
  __shared__ unsigned char black[kMaxCells];
  __shared__ int P[kMaxCells];
  __shared__ int Q[kMaxCells];
  __shared__ int M[kMaxCells];
  __shared__ int reached;

  const int n = size * size;
  const signed char* board = boards + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) black[i] = board[i] == 1;
  const signed char w = black_winner(black, P, Q, M, &reached, size, rounds);
  if (threadIdx.x == 0) out[blockIdx.x] = w;
}

__global__ void hex_playout_kernel(const signed char* __restrict__ boards,
                                   const int* __restrict__ to_move,
                                   const long long* __restrict__ keys,
                                   int size, int rounds,
                                   signed char* __restrict__ out,
                                   signed char* __restrict__ filled) {
  __shared__ signed char cell[kMaxCells];
  __shared__ float u[kMaxCells];
  __shared__ unsigned char black[kMaxCells];
  __shared__ int P[kMaxCells];
  __shared__ int Q[kMaxCells];
  __shared__ int M[kMaxCells];
  __shared__ int reached;

  const int n = size * size;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const threefry::Key key = threefry::read_key(keys, blockIdx.x);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cell[i] = boards[base + i];
    u[i] = threefry::uniform(key, static_cast<uint32_t>(i));
  }
  __syncthreads();

  const int mover = to_move[blockIdx.x];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int c = cell[i];
    if (c == 0) {
      const float ui = u[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const float uj = u[j];
        rank += cell[j] == 0 && (uj < ui || (uj == ui && j < i));
      }
      c = rank % 2 == 0 ? mover : 3 - mover;
    }
    black[i] = c == 1;
    if (filled != nullptr) filled[base + i] = static_cast<signed char>(c);
  }
  const signed char w = black_winner(black, P, Q, M, &reached, size, rounds);
  if (threadIdx.x == 0) out[blockIdx.x] = w;
}

}  // namespace

namespace {
// the argument struct: kernels/_build.py ARGS["repro_hex_winner"]
struct HexWinnerArgs {
  const void* boards;
  int W, size, rounds;
  void* out;
  void* stream;
};
}  // namespace

extern "C" int repro_hex_winner_args_bytes() {
  return static_cast<int>(sizeof(HexWinnerArgs));
}

extern "C" int repro_hex_winner(const void* packed) {
  HexWinnerArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.W <= 0 || a.size < 1 || a.size * a.size > kMaxCells || a.rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  hex_winner_kernel<<<a.W, kThreads, 0,
                      static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const signed char*>(a.boards), a.size, a.rounds,
      static_cast<signed char*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

namespace {
// the argument struct: kernels/_build.py ARGS["repro_hex_playout"]
struct HexPlayoutArgs {
  const void* boards;
  const void* to_move;
  const void* keys;
  int W, size, rounds;
  void* out;
  void* filled;  // null: the filled boards are not written
  void* stream;
};
}  // namespace

extern "C" int repro_hex_playout_args_bytes() {
  return static_cast<int>(sizeof(HexPlayoutArgs));
}

extern "C" int repro_hex_playout(const void* packed) {
  HexPlayoutArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.W <= 0 || a.size < 1 || a.size * a.size > kMaxCells || a.rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  hex_playout_kernel<<<a.W, kThreads, 0,
                       static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const signed char*>(a.boards),
      static_cast<const int*>(a.to_move),
      static_cast<const long long*>(a.keys), a.size, a.rounds,
      static_cast<signed char*>(a.out), static_cast<signed char*>(a.filled));
  return static_cast<int>(cudaGetLastError());
}

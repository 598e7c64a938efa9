// A shared-memory ring for forward-only serial walks on Hopper (sm_90a),
// used by kernel B7 (csrc/decode_kernels.cu, the exact decode walk) and by
// kernel B9 on rows longer than a parse block (csrc/encode_kernels.cu).
//
// One block walks one row of 32-bit words: a chain cur -> next(cur) >= cur
// that ends at the row's length n.  Each step's address depends on the
// load before it, so a walker that reads device memory waits ~350 cycles
// a step (0.17 us on an H100).  Here the walker (thread 0) reads shared
// memory only: warps 1.. stream the row through two slots of kChunk words
// with cp.async, one chunk ahead of the walker, and run the walk's side
// work (B7 flushes its staged output in 16-byte stores).
//
// The walk goes in rounds ended by one __syncthreads.  In a round the
// walker walks the chunk it stands in, if that chunk has landed, until it
// leaves the chunk, ends, or its own limit stops it (B7's output ring);
// meanwhile the other warps copy the next chunk into the other slot (and
// the walker's chunk too, in a round where it has not landed: the first
// round, or after a step that skipped chunks), wait for their copies and
// turn each word into what the walker needs: both kernels store the next
// position there, and a trap for a step that ends the walk or the chunk
// (the pad word before the chunk, which leads to itself), so the walker
// takes four steps a test, each a shared load and an address (~40 cycles).
// The state the walker hands on lives in two shared copies, one per round
// parity, so no thread reads what the walker is writing.  Every thread
// tracks which chunk each slot holds from that state alone, so all agree
// without another barrier.  The walker never reads past n; the copies
// stop at n too.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring {

constexpr int kChunk = 8192;    // words of the row a slot holds (32 KiB)
constexpr int kPad = 4;         // words before a slot's chunk, the kernel's
constexpr int kSlot = kPad + kChunk;
constexpr int kThreads = 256;   // thread 0 walks; warps 1.. copy and flush

// What the walker hands on to the next round: its position, B7's output
// count k and flushed prefix kf (a multiple of 4), and whether it is done.
struct State {
  int cur;
  int k;
  int kf;
  int done;
};

// Shared memory the ring itself takes: two slots and two states.
constexpr size_t kSharedBytes = 2 * kSlot * sizeof(int) + 2 * sizeof(State);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The words [0, cnt) of a chunk that thread t of nt copies: f(i, w) for
// each run [i, i + w) of w = 4 words (16-byte copies, vec) or w = 1.
template <class F>
__device__ __forceinline__ void own_words(int cnt, bool vec, int t, int nt,
                                          F f) {
  int i = t;
  if (vec) {
    for (; 4 * i + 3 < cnt; i += nt) f(4 * i, 4);
    i = 4 * (cnt >> 2) + t;
  }
  for (; i < cnt; i += nt) f(i, 1);
}

// Start copying words [c*kChunk, min((c+1)*kChunk, n)) of row into slot.
// vec: the row is 16-byte aligned and so is every chunk's start.
__device__ __forceinline__ void load_chunk(int* slot, const int* row, int c,
                                           int n, bool vec, int t, int nt) {
  const int lo = c * kChunk;
  own_words(min(kChunk, n - lo), vec, t, nt, [&](int i, int w) {
    if (w == 4) cp_async16(slot + i, row + lo + i);
    else cp_async4(slot + i, row + lo + i);
  });
}

// Once this thread's copies of chunk c into slot s have landed: prep(s,
// p, i) for each word i of the slot it copied, p = c*kChunk + i its
// position in the row (the copying thread sees its own copies after
// cp.async.wait_all, so no barrier is needed).
template <class Prep>
__device__ __forceinline__ void prep_chunk(int s, int c, int n, bool vec,
                                           int t, int nt, Prep prep) {
  const int lo = c * kChunk;
  own_words(min(kChunk, n - lo), vec, t, nt, [&](int i, int w) {
    for (int j = 0; j < w; ++j) prep(s, lo + i + j, i + j);
  });
}

// The words of slot s: a chunk, after kPad words a kernel may use.
__device__ __forceinline__ int* chunk_of(int* slots, int s) {
  return slots + s * kSlot + kPad;
}

// Walk one row.  st[0] holds the first state and was published by a
// __syncthreads; slots has room for 2 * kSlot words (see chunk_of).
// Warps 1.. copy the chunks, call side(s, t, nt) with the round's state
// while the copies fly, and then prep each word they copied (see
// prep_chunk): a kernel turns a word into what its walker needs, e.g. the
// next position.  In each round the walker calls walk(s, lo, end, t) on
// the chunk it stands in, slot s, row positions [lo, end), end = min(n, lo
// + kChunk): it advances t (cur, k, done) while cur < end.  Returns the
// final state, in every thread.
template <class Prep, class Walk, class Side>
__device__ __forceinline__ State run(const int* __restrict__ row, int n,
                                     bool vec, int* slots, State* st,
                                     Prep prep, Walk walk, Side side) {
  int res0 = -1, res1 = -1;     // the chunk in slot 0 / slot 1
  const int tid = threadIdx.x;
  for (int r = 0;; ++r) {
    const State s = st[r & 1];
    if (s.done) return s;
    const int cw = s.cur / kChunk;
    const int nx = cw + 1;
    const bool ready = ((cw & 1) ? res1 : res0) == cw;
    const bool want_nx = nx * kChunk < n && ((nx & 1) ? res1 : res0) != nx;
    if (tid == 0) {
      State t = s;
      if (ready) walk(cw & 1, cw * kChunk, min(n, nx * kChunk), t);
      t.kf = s.k & ~3;           // what side() flushed in this round
      st[(r + 1) & 1] = t;
    } else if (tid >= 32) {
      const int t = tid - 32, nt = blockDim.x - 32;
      if (!ready) load_chunk(chunk_of(slots, cw & 1), row, cw, n, vec, t, nt);
      if (want_nx) load_chunk(chunk_of(slots, nx & 1), row, nx, n, vec, t, nt);
      side(s, t, nt);
      cp_async_wait_all();
      if (!ready) prep_chunk(cw & 1, cw, n, vec, t, nt, prep);
      if (want_nx) prep_chunk(nx & 1, nx, n, vec, t, nt, prep);
    }
    if (!ready) {
      if (cw & 1) res1 = cw; else res0 = cw;
    }
    if (want_nx) {
      if (nx & 1) res1 = nx; else res0 = nx;
    }
    __syncthreads();
  }
}

}  // namespace ring

// Hand-written Hopper (sm_90a) kernels of the device decode path.
//
// Both walk the chain of symbol starts through the per-bit speculative
// words that device/inflate2.py:_pass1 makes: word[p] holds, for a symbol
// that would start at bit p, adv(6) | kind(2)<<6 | value(8)<<8 |
// (dist-1)(15)<<16, and the true symbols are the orbit of the block's first
// bit under p -> p + adv.  Each step is a load whose address depends on the
// load before it, so both kernels are bound by memory latency, not by
// bytes or arithmetic; what a design can do is run many chains at once
// (B6) or make each load a shared-memory one (B7).
//
// The TPU kernels read word[p] with a masked row-reduce over a whole VMEM
// tile because the TPU has no scalar gather from VMEM; the card has plain
// indexed loads, so each thread here simply follows its chain.
//
// Interface: plain C (ctypes), every entry point launches on the caller's
// stream and returns cudaGetLastError().  Buffers are allocated by the
// Python wrappers (flate_tpu_torch/device/inflate2.py), which check dtype,
// shape, device and contiguity before calling.  The u32 words travel as
// int32 bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_walk.cuh"

namespace {

constexpr int kEob = 2;             // kind field of an end-of-block word
constexpr int kLaneThreads = 32;    // lanes (threads) per block, lane walk

__device__ __forceinline__ int lane_adv(int w) {
  int a = w & 63;
  return a > 0 ? a : 1;
}

// --------------------------------------------------------------------------
// B6 lane walk — replaces flate_tpu/jx/inflate2.py:_lane_walk_kernel (via
// _lane_walk).  A row's N bit positions are cut into NL = N / G lanes of G
// positions.  Output: mask (B, N) u8, 1 on the positions of the true chain
// as far as it is proven, and joined (B, NL), 1 where a lane's part of the
// chain is proven (vacuous lanes count as joined).
//
// Phase 1 (lane_walk_p1): one thread per (row, lane) walks the chain from
// the lane's first position (from the exact start in the start lane) to the
// lane's end, marks what it visits in `mask` and records where it left the
// lane (exit_rel, relative to the lane's base; G for an inactive lane).  A
// lane that starts inside a symbol falls into step with the true chain
// after a few symbols.
//
// Phase 2 (lane_walk_p2): the true chain enters lane l where lane l-1 left
// off.  One thread per lane follows it for at most J steps until it lands
// on a position that phase 1 marked: from there on the lane's own marks are
// the true chain.  The steps before the join are marked too, and the lane's
// speculative marks before the join are cleared by walking them once more
// (all of them when the join fails); the two sets of positions are
// disjoint, since the join happens at the first marked position.
//
// Bound: operations (one dependent load per step, ~N/9 steps a row on text,
// spread over NL threads); the bytes are N words read and N mask bytes
// written.  A thread touches only its own lane of `mask`, so there are no
// atomics.  The visited set lives in the output buffer in device memory; a
// block clears its lanes' part of it with 16-byte stores before it walks.
// --------------------------------------------------------------------------
__global__ void lane_walk_p1(const int* __restrict__ word,
                             const int* __restrict__ start,
                             const int* __restrict__ nbits,
                             uint8_t* __restrict__ mask,
                             int* __restrict__ exit_rel,
                             long long total, int NL, int G) {
  long long first = blockIdx.x * static_cast<long long>(blockDim.x);
  long long here = total - first < blockDim.x ? total - first : blockDim.x;
  uint4* z = reinterpret_cast<uint4*>(mask + first * G);
  long long nvec = here * G / 16;
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  long long gl = first + threadIdx.x;
  if (gl >= total) return;
  int b = static_cast<int>(gl / NL);
  int lane = static_cast<int>(gl - static_cast<long long>(b) * NL);
  int s0 = start[b];
  int n = nbits[b];
  int l0 = s0 / G;
  long long lbase = static_cast<long long>(lane) * G;
  const int* w = word + gl * G;
  uint8_t* m = mask + gl * G;
  int c = lane == l0 ? s0 - static_cast<int>(lbase) : 0;
  if (lane < l0 || lbase >= n) c = G;
  while (c < G) {
    m[c] = 1;
    c += lane_adv(w[c]);
  }
  exit_rel[gl] = c;
}

__global__ void lane_walk_p2(const int* __restrict__ word,
                             const int* __restrict__ start,
                             const int* __restrict__ nbits,
                             uint8_t* __restrict__ mask,
                             const int* __restrict__ exit_rel,
                             int* __restrict__ joined,
                             long long total, int NL, int G, int J) {
  long long gl = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gl >= total) return;
  int b = static_cast<int>(gl / NL);
  int lane = static_cast<int>(gl - static_cast<long long>(b) * NL);
  int s0 = start[b];
  int n = nbits[b];
  int l0 = s0 / G;
  long long lbase = static_cast<long long>(lane) * G;
  if (lane < l0 || lbase >= n) {      // vacuous lane: nothing to prove
    joined[gl] = 1;
    return;
  }
  const int* w = word + gl * G;
  uint8_t* m = mask + gl * G;
  int cur0 = lane == l0 ? s0 - static_cast<int>(lbase) : 0;
  // lane > l0 >= 0 here, so lane - 1 is a lane of the same row
  int c2 = lane == l0 ? cur0 : exit_rel[gl - 1] - G;
  int jn = 0;
  int jpos = G;
  for (int step = 0; step < J && c2 < G; ++step) {
    if (m[c2]) {                      // landed on the lane's own chain
      jpos = c2;
      jn = 1;
      break;
    }
    m[c2] = 1;                        // a true-chain step before the join
    c2 += lane_adv(w[c2]);
  }
  // drop the lane's speculative marks left of the join
  int stop = jn ? jpos : G;
  for (int c = cur0; c < stop; c += lane_adv(w[c])) m[c] = 0;
  joined[gl] = jn;
}

// --------------------------------------------------------------------------
// B7 serial walk — replaces flate_tpu/jx/inflate2.py:_walk_kernel (via
// _walk).  One block per row follows the chain from `start` and writes the
// words it visits, in order, until an end-of-block word, the end of the
// row's bits (min(nbits, N)) or NS words; count is the number written, and
// the output row is zero past it.  No clamp on adv here, as in the TPU
// kernel.
//
// Bound: latency — every step waits for the load before it (~22.7 K steps
// for a 128 KiB text shard, one chain a row), so a row costs its steps
// times one load's latency; the bytes (N words in, NS out) take ~6 us.
// Design: the chain only moves forward, so the row streams through the
// shared-memory ring of ring_walk.cuh one chunk ahead of the walker; as a
// chunk lands, the copying warps store each word's next position p + adv
// beside it, so the walker's chain is a shared load of the next position
// and the next load, and the word itself is a load off the chain.  An
// end-of-block word leads to a trap, the pad word just before the chunk
// (position lo - 1, which no step reaches: adv >= 0), which leads to
// itself: so while the walker is more than 4 * 63 positions before the
// chunk's end it takes four steps a test, and after a trap keeps the
// words through the first end-of-block one.  The walker
// writes its words into a shared ring of kOut words, which warps 1..
// flush to `out` in 16-byte stores one round later.  It stops a round when
// that ring is full (adv 0 repeats a word up to NS times), and the block
// writes the last words and the zero tail once the walk has ended.
// --------------------------------------------------------------------------
constexpr int kOut = 8192;          // staged output words (a power of 2)
constexpr int kMaxAdv = 63;
// the ring, the next positions of its two slots, the staged output
constexpr size_t kWalkShared =
    ring::kSharedBytes + (2 * ring::kSlot + kOut) * sizeof(int);

__device__ __forceinline__ bool is_eob(int v) { return ((v >> 6) & 3) == kEob; }

__global__ void __launch_bounds__(ring::kThreads)
walk_kernel(const int* __restrict__ word, const int* __restrict__ start,
            const int* __restrict__ nbits, int* __restrict__ out,
            int* __restrict__ count, int N, int NS, int vec_in, int vec_out) {
  extern __shared__ __align__(16) int walk_smem[];
  int* slots = walk_smem;                        // 2 x ring::kSlot words
  int* nexts = slots + 2 * ring::kSlot;          // their next positions
  int* ob = nexts + 2 * ring::kSlot;             // kOut staged words
  ring::State* st = reinterpret_cast<ring::State*>(ob + kOut);
  const int b = blockIdx.x;
  const int* w = word + static_cast<long long>(b) * N;
  int* o = out + static_cast<long long>(b) * NS;
  const int n = min(nbits[b], N);
  if (threadIdx.x == 0) {
    const int s0 = start[b];
    st[0] = {s0, 0, 0, s0 < 0 || s0 >= n || NS <= 0 ? 1 : 0};
  }
  __syncthreads();
  const ring::State s = ring::run(
      w, n, vec_in != 0, slots, st,
      [&](int sl, int p, int i) {
        const int trap = p - i - 1;              // the pad word's position
        int* vs = ring::chunk_of(slots, sl);
        int* nx = ring::chunk_of(nexts, sl);
        nx[i] = is_eob(vs[i]) ? trap : p + (vs[i] & kMaxAdv);
        if (i == 0) {
          vs[-1] = 0;
          nx[-1] = trap;
        }
      },
      [&](int sl, int lo, int end, ring::State& t) {
        const int* vs = ring::chunk_of(slots, sl) - lo;   // by position
        const int* nx = ring::chunk_of(nexts, sl) - lo;
        const int trap = lo - 1;
        int cur = t.cur, k = t.k;
        const int klim = min(NS, t.kf + kOut);
        // four steps a test while they cannot leave the chunk but by an
        // end-of-block word, which leads to the trap
        while (cur < end - 4 * kMaxAdv && k + 4 <= klim) {
          const int v0 = vs[cur];
          const int c1 = nx[cur];
          const int v1 = vs[c1];
          const int c2 = nx[c1];
          const int v2 = vs[c2];
          const int c3 = nx[c2];
          const int v3 = vs[c3];
          const int c4 = nx[c3];
          ob[k & (kOut - 1)] = v0;
          ob[(k + 1) & (kOut - 1)] = v1;
          ob[(k + 2) & (kOut - 1)] = v2;
          ob[(k + 3) & (kOut - 1)] = v3;
          if (c4 == trap) {           // keep the words through the EOB
            k += is_eob(v0) ? 1 : is_eob(v1) ? 2 : is_eob(v2) ? 3 : 4;
            cur = trap;
            break;
          }
          k += 4;
          cur = c4;
        }
        while (static_cast<unsigned>(cur - lo) < static_cast<unsigned>(end - lo) &&
               k < klim) {                // not the trap, not past the chunk
          ob[k & (kOut - 1)] = vs[cur];
          ++k;
          cur = nx[cur];
        }
        if (cur == trap) cur = n;     // an end-of-block word ends the walk
        t.cur = cur;
        t.k = k;
        t.done = cur >= n || k >= NS;
      },
      [&](const ring::State& r, int t, int nt) {   // words [kf, k & ~3)
        const int e = r.k & ~3;
        if (vec_out) {
          uint4* o4 = reinterpret_cast<uint4*>(o);
          for (int i = (r.kf >> 2) + t; i < (e >> 2); i += nt)
            o4[i] = *reinterpret_cast<const uint4*>(ob + ((4 * i) & (kOut - 1)));
        } else {
          for (int i = r.kf + t; i < e; i += nt) o[i] = ob[i & (kOut - 1)];
        }
      });
  // the words the rounds left, then zeros to NS
  auto at = [&](int i) -> int { return i < s.k ? ob[i & (kOut - 1)] : 0; };
  if (vec_out) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int i = (s.kf >> 2) + threadIdx.x; i < (NS >> 2); i += blockDim.x) {
      const int j = 4 * i;
      o4[i] = make_uint4(at(j), at(j + 1), at(j + 2), at(j + 3));
    }
  } else {
    for (int i = s.kf + threadIdx.x; i < NS; i += blockDim.x) o[i] = at(i);
  }
  if (threadIdx.x == 0) count[b] = s.k;
}

}  // namespace

extern "C" {

int flate_lane_walk(const void* word, const void* start, const void* nbits,
                    void* mask, void* exit_rel, void* joined, int B, int N,
                    int G, int J, void* stream) {
  int NL = N / G;
  long long total = static_cast<long long>(B) * NL;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned g1 = static_cast<unsigned>((total + kLaneThreads - 1) / kLaneThreads);
  lane_walk_p1<<<g1, kLaneThreads, 0, s>>>(
      static_cast<const int*>(word), static_cast<const int*>(start),
      static_cast<const int*>(nbits), static_cast<uint8_t*>(mask),
      static_cast<int*>(exit_rel), total, NL, G);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  lane_walk_p2<<<g1, kLaneThreads, 0, s>>>(
      static_cast<const int*>(word), static_cast<const int*>(start),
      static_cast<const int*>(nbits), static_cast<uint8_t*>(mask),
      static_cast<const int*>(exit_rel), static_cast<int*>(joined), total,
      NL, G, J);
  return static_cast<int>(cudaGetLastError());
}

int flate_walk(const void* word, const void* start, const void* nbits,
               void* out, void* count, int B, int N, int NS, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  int rc = static_cast<int>(cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWalkShared)));
  if (rc != 0) return rc;
  const int vec_in = N % 4 == 0 && reinterpret_cast<uintptr_t>(word) % 16 == 0;
  const int vec_out = NS % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  walk_kernel<<<static_cast<unsigned>(B), ring::kThreads, kWalkShared,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(word), static_cast<const int*>(start),
      static_cast<const int*>(nbits), static_cast<int*>(out),
      static_cast<int*>(count), N, NS, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

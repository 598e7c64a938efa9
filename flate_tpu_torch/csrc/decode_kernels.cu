// Hand-written Hopper (sm_90a) kernels of the device decode path.
//
// Both walk the chain of symbol starts through the per-bit speculative
// words that device/inflate2.py:_pass1 makes: word[p] holds, for a symbol
// that would start at bit p, adv(6) | kind(2)<<6 | value(8)<<8 |
// (dist-1)(15)<<16, and the true symbols are the orbit of the block's first
// bit under p -> p + adv.  Each step is a load whose address depends on the
// load before it, so both kernels are bound by memory latency, not by
// bytes or arithmetic; what a design can do is run many chains at once.
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

namespace {

constexpr int kEob = 2;             // kind field of an end-of-block word
constexpr int kLaneThreads = 32;    // lanes (threads) per block, lane walk
constexpr int kWalkThreads = 256;   // threads that clear a row, serial walk

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
// _walk).  One block per row: its threads clear the output row, then one
// thread follows the chain from `start` and writes the words it visits, in
// order, until an end-of-block word, the end of the row's bits or NS
// words; count is the number written.  No clamp on adv here, as in the TPU
// kernel.
//
// Bound: operations, and latency at that — every step waits for the load
// before it (30-45 thousand steps for a 128 KiB text shard), and a row is
// one chain, so only B threads of the card work.  It is the exact path
// behind the lane walk (walk="serial", and the retry of a failed join),
// kept simple.
// --------------------------------------------------------------------------
__global__ void walk_kernel(const int* __restrict__ word,
                            const int* __restrict__ start,
                            const int* __restrict__ nbits,
                            int* __restrict__ out, int* __restrict__ count,
                            int N, int NS) {
  int b = blockIdx.x;
  int* o = out + static_cast<long long>(b) * NS;
  for (int i = threadIdx.x; i < NS; i += blockDim.x) o[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int* w = word + static_cast<long long>(b) * N;
  int n = nbits[b] < N ? nbits[b] : N;
  int cur = start[b];
  int k = 0;
  while (cur >= 0 && cur < n && k < NS) {
    int v = w[cur];
    o[k++] = v;
    cur = ((v >> 6) & 3) == kEob ? n : cur + (v & 63);
  }
  count[b] = k;
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
  if (B > 0)
    walk_kernel<<<static_cast<unsigned>(B), kWalkThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(word), static_cast<const int*>(start),
        static_cast<const int*>(nbits), static_cast<int*>(out),
        static_cast<int*>(count), N, NS);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

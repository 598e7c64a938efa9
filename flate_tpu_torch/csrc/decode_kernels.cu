// Hand-written Hopper (sm_90a) kernels of the device decode path.
//
// The walks B6 and B7 follow the chain of symbol starts through the
// per-bit speculative words that device/inflate2.py:_pass1 makes: word[p]
// holds, for a symbol that would start at bit p, adv(6) | kind(2)<<6 |
// value(8)<<8 | (dist-1)(15)<<16, and the true symbols are the orbit of
// the block's first bit under p -> p + adv.  Each step is a load whose address depends on the
// load before it, so both kernels are bound by latency, not by bytes or
// arithmetic: each stages what its walkers read in shared memory, where a
// step costs ~20 ns against ~350 ns from device memory, and B6 runs many
// short chains at once.
//
// The TPU kernels read word[p] with a masked row-reduce over a whole VMEM
// tile because the TPU has no scalar gather from VMEM; the card has plain
// indexed loads, so each walker simply follows its chain.
//
// S1, the chunk-entry scanner, finds where chains may start in a stream
// that carries no index: the first bit offset of each chunk that holds a
// valid dynamic-block header (see its section below).
//
// Interface: plain C (ctypes), every entry point launches on the caller's
// stream and returns cudaGetLastError().  Buffers are allocated by the
// Python wrappers (flate_tpu_torch/device/inflate2.py, device/scan.py),
// which check dtype, shape, device and contiguity before calling.  The u32
// words travel as int32 bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_walk.cuh"

namespace {

constexpr int kEob = 2;             // kind field of an end-of-block word

__device__ __forceinline__ int lane_adv(int w) {
  int a = w & 63;
  return a > 0 ? a : 1;
}

// --------------------------------------------------------------------------
// B6 lane walk — replaces flate_tpu/jx/inflate2.py:_lane_walk_kernel (via
// _lane_walk).  A row's N bit positions are cut into NL = N / G lanes of G
// positions.  Phase 1 walks each lane's speculative chain from the lane's
// first position (from `start` in the start lane l0; lanes before l0 or at
// or past nbits are vacuous) with adv = max(1, w & 63) until it leaves the
// lane.  Phase 2 follows the true chain into lane l from lane l-1's phase-1
// exit for at most J steps, until it lands on a phase-1 mark (the join).
// Output: mask (B, N) u8 = the join walk's marks | the phase-1 marks at or
// after the join of a joined, non-vacuous lane; joined (B, NL) u8, 1 where
// a lane's part of the chain is proven (vacuous lanes count as joined).
// `start` is a bit position of the row (>= 0).
//
// Bound: latency.  The bytes (N words in, N mask bytes out: 0.0063 ms for
// 8 rows of 2^19 bits) and the chains (the longest lane's marks x ~20 ns
// a shared-memory step) are both a few microseconds.  The first port walked
// every chain in device memory (~350 ns a step) in two launches, with a
// zero-fill of the mask and a second walk that cleared the marks left of
// the join: 0.094 ms.  Phase 2 of lane l needs only lane l-1's phase-1 exit,
// so one launch does it all: a block takes L consecutive lanes of one row
// and the lane before them (a halo lane, walked in phase 1 only, for its
// exit), stages their adv bytes (1 byte a position) in shared memory with
// 16-byte loads, and keeps each lane's phase-1 and join marks as two shared
// bitmaps.  Warp 0 walks, one thread a lane (a phase-1 step is a shared
// load and an add, its mark off the chain: ~25 ns measured); a barrier;
// the join; a barrier; then every thread composes the mask 16 positions at
// a time from the two bitmaps, the join position and the flags, and writes
// it once with 16-byte stores (0.015 ms for the 8 x 2^19 batch, replayed
// from a CUDA graph on an H100 at 700 W).
// A G too wide for one lane and its halo to fit in shared memory takes the
// variant kStaged = false: the walkers read the words and keep the bitmaps
// in a device-memory scratch of the block's own.
// `phases` < 3 stops after staging (0), phase 1 (1) or the join (2), for
// tools/torch_kernel_probe.py's split; the wrapper passes 3.
// --------------------------------------------------------------------------
constexpr int kLaneBlockThreads = 256;
constexpr int kMaxLanes = 31;                          // L + 1 walkers fit in warp 0
constexpr int kMaxGridY = 65535;                       // rows past it go to gridDim.z

// Bytes of the per-slot state (phase-1 exit, join position, join flag) at
// the front of shared memory, kept a multiple of 16.
__host__ __device__ constexpr int lane_state_bytes(int L) {
  return (3 * (L + 1) * 4 + 15) / 16 * 16;
}

// Four positions' words -> their four adv bytes in one word.
__device__ __forceinline__ uint32_t adv4(int4 v) {
  return static_cast<uint32_t>(lane_adv(v.x)) |
         static_cast<uint32_t>(lane_adv(v.y)) << 8 |
         static_cast<uint32_t>(lane_adv(v.z)) << 16 |
         static_cast<uint32_t>(lane_adv(v.w)) << 24;
}

// Four mask bits -> four 0/1 bytes.
__device__ __forceinline__ uint32_t bytes4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

template <bool kStaged>
__global__ void __launch_bounds__(kLaneBlockThreads)
lane_walk_kernel(const int* __restrict__ word, const int* __restrict__ start,
                 const int* __restrict__ nbits, uint8_t* __restrict__ mask,
                 uint8_t* __restrict__ joined, uint32_t* __restrict__ scratch,
                 int B, int N, int G, int J, int L, int phases) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.z * kMaxGridY + blockIdx.y;
  if (b >= B) return;
  const int NL = N / G;
  const int GW = G / 32;                       // bitmap words a lane
  const int first = blockIdx.x * L;            // first lane the block writes
  const int nl = min(L, NL - first);           // lanes it writes
  const int s_lo = first > 0 ? 0 : 1;          // slot s holds lane first - 1 + s
  int* exit_at = reinterpret_cast<int*>(smem);
  int* jpos_at = exit_at + (L + 1);
  int* jn_at = jpos_at + (L + 1);              // 0 / 1 joined, 2 vacuous
  uint32_t* vis;
  if (kStaged) {
    vis = reinterpret_cast<uint32_t*>(smem + lane_state_bytes(L));
  } else {
    vis = scratch + (static_cast<long long>(b) * gridDim.x + blockIdx.x) *
                    2 * (L + 1) * GW;
  }
  uint32_t* jm = vis + (L + 1) * GW;
  uint8_t* sadv = reinterpret_cast<uint8_t*>(jm + (L + 1) * GW);
  const int* row = word + static_cast<long long>(b) * N;
  const int* lane0 = row + static_cast<long long>(first - 1) * G;   // slot 0
  auto adv_at = [&](int s, int c) -> int {
    if (kStaged) return sadv[s * G + c];
    return lane_adv(lane0[static_cast<long long>(s) * G + c]);
  };

  for (int i = threadIdx.x; i < 2 * (L + 1) * GW; i += blockDim.x) vis[i] = 0u;
  if (kStaged) {
    const int4* src = reinterpret_cast<const int4*>(lane0 + s_lo * G);
    uint32_t* dst = reinterpret_cast<uint32_t*>(sadv + s_lo * G);
    const int n4 = (nl + 1 - s_lo) * (G / 4);
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = adv4(__ldg(src + i));
  }
  __syncthreads();
  if (phases < 1) return;

  const int s0 = start[b];
  const int n = nbits[b];
  const int l0 = s0 / G;
  const int s = threadIdx.x;                   // the slot a walker takes
  const int l = first - 1 + s;
  const bool walker = s >= s_lo && s <= nl;
  const bool vac = walker && (l < l0 || l * G >= n);   // l * G < N < 2^31

  // ---- phase 1: each lane's speculative chain, marks into vis ----
  // A mark is an atomicOr whose result nobody waits for, off the chain
  // (c -> adv[c] -> c); four steps a test while four steps of at most 63
  // cannot leave the lane, single steps over its last 252 positions.
  if (walker) {
    int c = vac ? G : (l == l0 ? s0 - l * G : 0);
    uint32_t* v = vis + s * GW;
    auto step = [&]() {
      atomicOr(v + (c >> 5), 1u << (c & 31));
      c += adv_at(s, c);
    };
    while (c < G - 4 * 63) {
      step();
      step();
      step();
      step();
    }
    while (c < G) step();
    exit_at[s] = c;
  }
  __syncthreads();
  if (phases < 2) return;

  // ---- phase 2: the true chain from lane l-1's exit, to the join ----
  if (walker && s >= 1) {
    int jn = 2, jpos = G;
    if (!vac) {
      // lane l > l0 >= 0 here, so slot s - 1 holds lane l - 1
      int c2 = l == l0 ? s0 - l * G : exit_at[s - 1] - G;
      const uint32_t* v = vis + s * GW;
      uint32_t* m = jm + s * GW;
      jn = 0;
      for (int step = 0; step < J && c2 < G; ++step) {
        if ((v[c2 >> 5] >> (c2 & 31)) & 1u) {
          jpos = c2;
          jn = 1;
          break;
        }
        m[c2 >> 5] |= 1u << (c2 & 31);
        c2 += adv_at(s, c2);
      }
    }
    jpos_at[s] = jpos;
    jn_at[s] = jn;
    joined[static_cast<long long>(b) * NL + l] = jn != 0;
  }
  __syncthreads();
  if (phases < 3) return;

  // ---- the mask, 16 positions a thread, one 16-byte store ----
  const int per = G / 16;
  uint8_t* out = mask + static_cast<long long>(b) * N +
                 static_cast<long long>(first) * G;
  for (int it = threadIdx.x; it < nl * per; it += blockDim.x) {
    const int ls = it / per;                   // lane first + ls, slot ls + 1
    const int col = 16 * (it - ls * per);
    const int k = (ls + 1) * GW + (col >> 5);
    const int sh = col & 31;
    uint32_t bits = (jm[k] >> sh) & 0xFFFFu;
    if (jn_at[ls + 1] == 1) {
      const int from = jpos_at[ls + 1] - col;
      const uint32_t keep = from <= 0 ? 0xFFFFu : from >= 16 ? 0u : (0xFFFFu << from) & 0xFFFFu;
      bits |= (vis[k] >> sh) & keep;
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(ls) * G + col) =
        make_uint4(bytes4(bits & 15u), bytes4((bits >> 4) & 15u),
                   bytes4((bits >> 8) & 15u), bytes4(bits >> 12));
  }
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


// --------------------------------------------------------------------------
// S1 chunk-entry scanner — the JAX package's counterpart is host C, not a
// TPU kernel: flate_tpu/native/fastinflate.c:1046 scan_headers, with
// validate_dyn_header (:1010), read_code_lens (:344), build_table (:203)
// and check_lens (:175).  An offset p holds a header when the C's parse
// accepts it at p (the offset is the BFINAL bit).  The C's semantics, not
// RFC 1951's: HLIT and HDIST <= 29; the code-length code's Kraft sum over
// its HCLEN fields exactly 128; the literal/length and distance lengths
// read as two separate run-length-coded runs (a repeat-16 at the first
// distance length fails); symbol 256 coded; an incomplete literal/length
// or distance code only as one code of length 1; reads past in_len fail.
// The caller keeps hi <= 8 in_len - 96.
//
// What is computed is a short list, not a map of every offset: the first
// header of each of nseg segments [seg0 + k seg_len, min(seg0 + (k + 1)
// seg_len, hi)) (chunk_entries: one segment a chunk; scan_headers: one
// segment, launched again past each header found).  state, u64,
// zero-filled by the caller: [0] the segments handed out past the first
// gridDim.x, [1] segments with a header, [2] offsets tested, [3] tiles
// tested, [4, 4 + nseg) ~ each segment's first header (0: none), [4 +
// nseg, 4 + 2 nseg) each segment's next tile.
//
// Bound: operations on what the list needs, the offsets up to each chunk's
// first header (2.6 M of the 115 M offsets of phase 13's foreign body).
// A first version tested every offset, one warp on 32 at a time,
// and parsed the few survivors of the Kraft test alone in their warps from
// device memory: 2.01 ms on an H100 80GB HBM3, 82 % of it the Kraft
// sums and parses.  Here:
// - a persistent grid (the SMs x the blocks one holds) takes tiles of
//   2,048 offsets from atomic counters: block b starts on segment b mod
//   nseg and takes that segment's tiles in order from its own counter, so
//   every chunk advances from its start at once with the same number of
//   blocks; a segment keeps its first header by atomicMax of ~offset, and
//   its tiles at or past it are not taken.  A block whose segment has no
//   tile left takes a segment no block has had (only when there are more
//   segments than blocks), else it ends: the tiles tested past a chunk's
//   first header are at most its blocks' tiles in flight when it is found
//   (one tile a block, ~2 M offsets in all).
// - a tile's bytes and a halo that holds a whole header from its last
//   offset are staged in shared memory; the first test (BTYPE, HLIT,
//   HDIST) runs on every offset, uniformly, and its survivors (~22 %) go
//   to a shared queue by ballot; the Kraft sum runs on the dense queue, one
//   survivor a thread, and the few that pass go to a second queue, each
//   parsed from the staged words by a warp.  The lanes build the
//   code-length code's 128-entry table (lane = symbol, canonical codes by
//   ballot), then read the two length runs 32 bits a step: each lane
//   decodes the symbol that would start at its bit, the true ones follow
//   from lane 0 by their advances, and scans and ballots give their
//   positions, the length a repeat copies, the histograms and the C's
//   checks.  A run whose Kraft sum passes 1 stops there (check_lens would
//   refuse it): most parses are of offsets that are no header.  (A
//   parse by one thread, one dependent symbol a step, took most of a
//   tile's time.)
// --------------------------------------------------------------------------
constexpr int kScanThreads = 256;
constexpr int kScanPerThread = 8;
constexpr int kScanTile = kScanThreads * kScanPerThread;   // offsets a tile
// The most bits a parse reads: BFINAL, BTYPE, HLIT, HDIST, HCLEN, 19
// 3-bit code-length lengths, 316 lengths of at most 7 bits each, and a
// repeat (7 + 7 bits) past the end of each of the two runs.
constexpr int kScanMaxHeaderBits = 3 + 14 + 57 + 316 * 7 + 2 * 14;
// staged words: a tile from its 32-bit-aligned base (up to 31 bits in), a
// whole header from its last offset, and the 64-bit reads past it
constexpr int kScanStageWords =
    (32 + kScanTile + kScanMaxHeaderBits + 64 + 31) / 32;
constexpr int kScanCounters = 4;     // state words ahead of the minima

__constant__ uint8_t kCodegenOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                          11, 4, 12, 3, 13, 2, 14, 1, 15};

// The first test at an offset from v, its bits p .. p + 63: BTYPE == 2,
// HLIT <= 29, HDIST <= 29.
__device__ __forceinline__ bool scan_first_test(uint64_t v) {
  return ((v >> 1) & 3) == 2 && ((v >> 3) & 31) <= 29 &&
         ((v >> 8) & 31) <= 29;
}

// Bits rel .. rel + 63 of the staged words, and (in f) bits rel + 17 ..
// rel + 80: the HCLEN code-length lengths.
__device__ __forceinline__ uint64_t scan_window(const uint32_t* stage,
                                                int rel, uint64_t* f) {
  const int wi = rel >> 5, s = rel & 31;
  const uint64_t a = stage[wi] | static_cast<uint64_t>(stage[wi + 1]) << 32;
  const uint64_t b =
      stage[wi + 2] | static_cast<uint64_t>(stage[wi + 3]) << 32;
  const uint64_t v = s ? (a >> s) | (b << (64 - s)) : a;
  if (f) *f = (v >> 17) | ((b >> s) << 47);
  return v;
}

// Bits q .. q + 31 of the data, zero past its end (as the C's peek reads
// them): from the staged words, or from device memory past them (no
// header of at most kScanMaxHeaderBits reaches there).
__device__ __forceinline__ uint32_t scan_bits32(const uint32_t* stage,
                                                long long base,
                                                const uint8_t* in,
                                                long long in_len,
                                                long long q) {
  const long long rel = q - base;
  const long long wi = rel >> 5;
  uint64_t x;
  if (wi + 1 < kScanStageWords) {
    x = stage[wi] | static_cast<uint64_t>(stage[wi + 1]) << 32;
  } else {
    const long long b0 = (base >> 3) + 4 * wi;
    x = 0;
    for (int k = 0; k < 8; ++k)
      if (b0 + k < in_len) x |= static_cast<uint64_t>(in[b0 + k]) << (8 * k);
  }
  return static_cast<uint32_t>(x >> (rel & 31));
}

// check_lens on a length histogram: symbol 256 (litlen only), over- and
// under-subscription with the single length-1 code allowed incomplete.
__device__ bool scan_check_counts(const int* count, bool has256,
                                  bool is_litlen) {
  if (is_litlen && !has256) return false;
  int maxl = 0;
  for (int l = 1; l <= 15; ++l)
    if (count[l]) maxl = l;
  if (maxl == 0) return true;
  int left = 1;
  for (int l = 1; l <= 15; ++l) {
    left <<= 1;
    if (count[l] > left) return false;
    left -= count[l];
  }
  return left == 0 || maxl == count[1];
}

// A warp's scratch for one parse: the code-length code as a table of the
// next 7 bits (LSB first) -> symbol | code length << 5, the code-length
// lengths by symbol, and the histograms of the two length runs.
struct ScanParse {
  uint8_t table[128];
  uint8_t cl[32];
  int count[2][16];
};

// read_code_lens for `hcount` lengths of an arr_len array from bit bp, by
// a warp, 32 bits a step: lane i decodes the code-length symbol that would
// start at bit bp + i (its code from the table, its extra bits), the true
// symbols are those reached from lane 0 by their advances (one shuffle a
// symbol), and their effects combine by scans and ballots: the positions
// before each (the run takes the true symbols that start below hcount),
// the previous length a repeat-16 copies, the histogram of the lengths
// written (count[1..15], shared atomics), whether position 256 got a
// nonzero length, and the C's checks, any of which fails the header.  A
// run whose lengths' Kraft sum passes 1 stops there: its code is
// over-subscribed, which check_lens refuses whatever follows (most offsets
// that reach the parse are not headers, and stop within a few steps).
// bp moves past the run; every lane returns the result.
__device__ bool scan_read_lens(const uint8_t* table, const uint32_t* stage,
                               long long base, const uint8_t* in,
                               long long in_len, long long& bp, int hcount,
                               int arr_len, int* count, bool& has256) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const unsigned below = (1u << lane) - 1;
  int pos = 0, prev = 0, kraft = 0;
  has256 = false;
  __syncwarp();                      // the last parse's atomics are done
  if (lane < 16) count[lane] = 0;
  __syncwarp();
  while (pos < hcount) {
    const long long q = bp + lane;
    const uint32_t bits = scan_bits32(stage, base, in, in_len, q);
    const int e = table[bits & 127];
    const int sym = e & 31, clen = e >> 5;
    const int xb = sym < 16 ? 0 : sym == 16 ? 2 : sym == 17 ? 3 : 7;
    const int xv = static_cast<int>(bits >> clen) & ((1 << xb) - 1);
    const int adv = clen + xb;
    const int inc = sym < 16 ? 1 : xv + (sym == 18 ? 11 : 3);
    unsigned chain = 0;
    for (int cur = 0; cur < 32;) {
      chain |= 1u << cur;
      cur = __shfl_sync(kAll, lane + adv, cur);
    }
    const bool on = (chain >> lane) & 1;
    int x = on ? inc : 0;                       // inclusive scan of inc
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, x, d);
      if (lane >= d) x += y;
    }
    const int before = pos + x - (on ? inc : 0);
    const bool act = on && before < hcount;
    const unsigned actm = __ballot_sync(kAll, act);
    // the previous length: the last symbol before this one that is not a
    // repeat-16 (its length; 0 after a repeat of zeros), or the carry
    const unsigned setters = __ballot_sync(kAll, act && sym != 16);
    const unsigned mine = setters & below;
    const int pv = __shfl_sync(kAll, sym < 16 ? sym : 0,
                               mine ? 31 - __clz(mine) : lane);
    const int prev_i = mine ? pv : prev;
    bool bad = false;
    int k = 0;
    bool covers256 = false;
    int v256 = 0;
    if (act) {
      bad = q + adv > 8 * in_len;                // the code or its extra bits
      if (sym < 16) {
        bad |= before >= arr_len;
        covers256 = before == 256;
        v256 = sym;
        if (sym) {
          atomicAdd(&count[sym], 1);
          k = 1 << (15 - sym);
        }
      } else if (sym == 16) {
        bad |= before == 0 || before + inc > arr_len;
        covers256 = before <= 256 && 256 < before + inc;
        v256 = prev_i;
        if (prev_i) {
          atomicAdd(&count[prev_i], inc);
          k = inc << (15 - prev_i);
        }
      }
    }
    if (__ballot_sync(kAll, bad)) return false;
    const unsigned c256 = __ballot_sync(kAll, covers256);
    if (c256) has256 = __shfl_sync(kAll, v256, __ffs(c256) - 1) != 0;
    kraft += __reduce_add_sync(kAll, k);
    if (kraft > 1 << 15) return false;
    const int last = 31 - __clz(actm);           // lane 0 is always in
    pos = __shfl_sync(kAll, before + (on ? inc : 0), last);
    bp = __shfl_sync(kAll, q + adv, last);
    if (setters) prev = __shfl_sync(kAll, sym < 16 ? sym : 0,
                                    31 - __clz(setters));
  }
  __syncwarp();
  return pos <= hcount;
}

// validate_dyn_header at BFINAL bit p by one warp (the first test and the
// Kraft test passed, so HLIT and HDIST are in range and the code-length
// code is complete; p + 74 < nbits, so the fields before the length runs
// fit): the lanes build the code-length code's table, then read the two
// length runs together.  Every lane returns the result.
__device__ bool scan_validate(ScanParse& sp, const uint32_t* stage,
                              long long base, const uint8_t* in,
                              long long in_len, long long p) {
  const unsigned lane = threadIdx.x & 31;
  uint64_t f;
  const uint64_t v = scan_window(stage, static_cast<int>(p - base), &f);
  const int hlit = static_cast<int>((v >> 3) & 31) + 257;
  const int hdist = static_cast<int>((v >> 8) & 31) + 1;
  const int hclen = static_cast<int>((v >> 13) & 15) + 4;
  if (lane < 19) sp.cl[lane] = 0;
  __syncwarp();
  if (static_cast<int>(lane) < hclen)
    sp.cl[kCodegenOrder[lane]] = static_cast<uint8_t>((f >> (3 * lane)) & 7);
  __syncwarp();
  // canonical codes, lane = symbol: the first code of each length, then
  // the rank among the symbols of the same length
  const int len = lane < 19 ? sp.cl[lane] : 0;
  int code = 0, next = 0, prev_count = 0;
  for (int l = 1; l <= 7; ++l) {
    const unsigned m = __ballot_sync(0xffffffffu, len == l);
    next = (next + prev_count) << 1;
    if (len == l) code = next + __popc(m & ((1u << lane) - 1));
    prev_count = __popc(m);
  }
  if (len) {
    const int rev = static_cast<int>(__brev(static_cast<unsigned>(code)) >>
                                     (32 - len));
    for (int k = 0; k < 1 << (7 - len); ++k)
      sp.table[rev | k << len] = static_cast<uint8_t>(lane | len << 5);
  }
  __syncwarp();
  long long bp = p + 17 + 3 * hclen;
  bool has256, unused;
  return scan_read_lens(sp.table, stage, base, in, in_len, bp, hlit, 286,
                        sp.count[0], has256) &&
         scan_read_lens(sp.table, stage, base, in, in_len, bp, hdist, 30,
                        sp.count[1], unused) &&
         scan_check_counts(sp.count[0], has256, true) &&
         scan_check_counts(sp.count[1], true, false);
}

__global__ void __launch_bounds__(kScanThreads, 6)
scan_kernel(const uint8_t* __restrict__ in, long long in_len, long long seg0,
            long long seg_len, long long hi, int nseg, long long per_seg,
            unsigned long long* __restrict__ state) {
  __shared__ uint32_t stage[kScanStageWords];
  __shared__ uint16_t queue[kScanTile];      // survivors of the first test
  __shared__ uint16_t passed[kScanTile];     // and of the Kraft test
  __shared__ ScanParse parse[kScanThreads / 32];
  __shared__ int n_queue, n_passed, s_seg;
  __shared__ long long s_start, s_end;
  unsigned long long* found = state + 1;
  unsigned long long* firsts = state + kScanCounters;
  unsigned long long* next = firsts + nseg;  // each segment's next tile
  volatile unsigned long long* vfound = found;
  volatile unsigned long long* vfirsts = firsts;
  const unsigned lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool aligned = (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  // the block's segment (thread 0's): the blocks start spread evenly
  int seg = static_cast<int>(blockIdx.x % nseg);
  for (;;) {
    if (threadIdx.x == 0) {
      // the next tile of the block's segment, in order, while the segment
      // has one below its first header found; then a segment no block has
      // had (state[0] hands them out after the first gridDim.x), or none;
      // none once every segment has its header
      long long start = -1, end = -1;
      while (seg >= 0 && *vfound < static_cast<unsigned long long>(nseg)) {
        const long long lo_k = seg0 + seg * seg_len;
        const long long e = min(lo_k + seg_len, hi);
        const long long r =
            static_cast<long long>(atomicAdd(next + seg, 1ULL));
        const long long s = lo_k + r * kScanTile;
        if (r < per_seg && s < e &&
            static_cast<unsigned long long>(s) < ~vfirsts[seg]) {
          start = s;
          end = min(s + kScanTile, e);
          break;
        }
        const unsigned long long c = gridDim.x + atomicAdd(state, 1ULL);
        seg = c < static_cast<unsigned long long>(nseg) ? static_cast<int>(c)
                                                       : -1;
      }
      s_start = start;
      s_end = end;
      s_seg = seg < 0 ? 0 : seg;
      n_queue = 0;
      n_passed = 0;
    }
    __syncthreads();
    const long long start = s_start;
    if (start < 0) return;
    const int n = static_cast<int>(s_end - start);
    const int tseg = s_seg;
    const long long base = start & ~31LL;
    const long long byte0 = base >> 3;
    for (int i = threadIdx.x; i < kScanStageWords; i += kScanThreads) {
      const long long b = byte0 + 4 * i;    // byte0 is a multiple of 4
      uint32_t w = 0;
      if (aligned && b + 4 <= in_len) {
        w = *reinterpret_cast<const uint32_t*>(in + b);
      } else {
        for (int k = 0; k < 4; ++k)
          if (b + k < in_len)
            w |= static_cast<uint32_t>(in[b + k]) << (8 * k);
      }
      stage[i] = w;
    }
    __syncthreads();
    // the first test on every offset; survivors to the queue by ballot
    const int sh = static_cast<int>(start - base);
    for (int j = 0; j < kScanPerThread; ++j) {
      const int i = j * kScanThreads + threadIdx.x;
      const bool ok = i < n && scan_first_test(scan_window(stage, sh + i,
                                                           nullptr));
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&n_queue, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (ok)
        queue[at + __popc(m & ((1u << lane) - 1))] =
            static_cast<uint16_t>(sh + i);
    }
    __syncthreads();
    // the Kraft sum of the code-length code, one survivor a thread
    const int nq = n_queue;
    for (int q = threadIdx.x; q < nq; q += kScanThreads) {
      const int rel = queue[q];
      uint64_t f;
      const uint64_t v = scan_window(stage, rel, &f);
      const int hclen = static_cast<int>((v >> 13) & 15) + 4;
      int kraft = 0;
#pragma unroll
      for (int i = 0; i < 19; ++i) {
        const int len = static_cast<int>((f >> (3 * i)) & 7);
        kraft += i < hclen && len ? 128 >> len : 0;
      }
      if (kraft == 128)
        passed[atomicAdd(&n_passed, 1)] = static_cast<uint16_t>(rel);
    }
    __syncthreads();
    // the full parse, one offset a warp
    const int np = n_passed;
    for (int q = warp; q < np; q += kScanThreads / 32) {
      const long long p = base + passed[q];
      unsigned long long first = 0;
      if (lane == 0) first = ~vfirsts[tseg];
      first = __shfl_sync(0xffffffffu, first, 0);
      if (static_cast<unsigned long long>(p) >= first) continue;
      if (!scan_validate(parse[warp], stage, base, in, in_len, p)) continue;
      if (lane == 0 &&
          atomicMax(firsts + tseg, ~static_cast<unsigned long long>(p)) == 0)
        atomicAdd(found, 1ULL);
    }
    if (threadIdx.x == 0) {
      atomicAdd(state + 2, static_cast<unsigned long long>(n));
      atomicAdd(state + 3, 1ULL);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int flate_lane_walk(const void* word, const void* start, const void* nbits,
                    void* mask, void* joined, void* scratch, int B, int N,
                    int G, int J, int L, int phases, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || G % 128 != 0 || N % G != 0 || L < 1 || L > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NL = N / G;
  const dim3 grid((NL + L - 1) / L, min(B, kMaxGridY),
                  (B + kMaxGridY - 1) / kMaxGridY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel, size_t smem) {
    kernel<<<grid, kLaneBlockThreads, smem, s>>>(
        static_cast<const int*>(word), static_cast<const int*>(start),
        static_cast<const int*>(nbits), static_cast<uint8_t*>(mask),
        static_cast<uint8_t*>(joined), static_cast<uint32_t*>(scratch), B, N, G,
        J, L, phases);
  };
  if (scratch == nullptr) {         // staged: adv bytes and bitmaps in shared memory
    const size_t smem = lane_state_bytes(L) +
                        static_cast<size_t>(L + 1) * G / 4 +     // two bitmaps
                        static_cast<size_t>(L + 1) * G;          // adv bytes
    static size_t allowed = 0;       // the kernel's shared-memory ceiling so far
    if (smem > allowed) {
      const int rc = static_cast<int>(cudaFuncSetAttribute(
          lane_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (rc != 0) return rc;
      allowed = smem;
    }
    args(lane_walk_kernel<true>, smem);
  } else {
    args(lane_walk_kernel<false>, lane_state_bytes(L));
  }
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

int flate_scan_headers(const void* in, void* state, long long in_len,
                       long long seg0, long long seg_len, long long hi,
                       int nseg, void* stream) {
  if (nseg <= 0 || seg_len <= 0 || hi <= seg0)
    return static_cast<int>(cudaGetLastError());
  if (seg0 < 0 || hi > 8 * in_len)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0, per_sm = 0;    // the grid that stays resident
  if (sms == 0) {
    int dev = 0;
    int rc = static_cast<int>(cudaGetDevice(&dev));
    if (rc == 0)
      rc = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc == 0)
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scan_kernel, kScanThreads, 0));
    if (rc != 0 || per_sm <= 0) {
      sms = 0;
      return rc != 0 ? rc : static_cast<int>(cudaErrorInvalidConfiguration);
    }
  }
  const long long per_seg = (seg_len + kScanTile - 1) / kScanTile;
  const long long grid =
      min(per_seg * nseg, static_cast<long long>(sms) * per_sm);
  scan_kernel<<<static_cast<unsigned>(grid), kScanThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), in_len, seg0, seg_len, hi, nseg,
      per_seg, static_cast<unsigned long long*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

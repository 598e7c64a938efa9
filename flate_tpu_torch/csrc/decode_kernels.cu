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
// that carries no index: every bit offset that holds a valid dynamic-block
// header (see its section below).
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
// and check_lens (:175).  Tests every bit offset p in [lo, hi) for a
// validated dynamic-block header (the offset is the BFINAL bit) and writes
// one bit an offset: bit (p - lo0) of bitmap, lo0 = lo & ~31.  The C's
// semantics, not RFC 1951's: HLIT and HDIST <= 29; the code-length code's
// Kraft sum over its HCLEN fields exactly 128; the literal/length and
// distance lengths read as two separate run-length-coded runs (a repeat-16
// at the first distance length fails); symbol 256 coded; an incomplete
// literal/length or distance code only as one code of length 1; reads past
// in_len fail.  The caller keeps hi <= 8 in_len - 96.
//
// Bound: operations.  The bytes are the body read once and the bitmap
// written once (8 MiB body: 2.8 us at 3.35 TB/s); every offset takes a
// few integer tests, a fifth of them the Kraft sum of up to 19 fields, and
// a few in a thousand the header parse.  A block takes 2,048 consecutive
// offsets, stages their 256 bytes and a 16-byte halo in shared memory, and
// a thread tests 8 offsets 256 apart, each from a 128-bit window of four
// staged words, so a warp tests 32 consecutive offsets at a time and
// writes their bitmap word from one __ballot_sync.  The survivors of the
// cheap filter (rare, and divergent within their warp) parse from device
// memory through a bounds-checked bit reader, with the code-length code
// decoded canonically from its counts (no 128-entry table) and the two
// length runs reduced to their counts, the previous length and whether
// symbol 256 got a code: a thread keeps ~60 bytes of state, not the C's
// 600-byte arrays.
// --------------------------------------------------------------------------
constexpr int kScanThreads = 256;
constexpr int kScanPerThread = 8;
constexpr int kScanTile = kScanThreads * kScanPerThread;   // offsets a block
constexpr int kScanWords = kScanTile / 32 + 4;             // staged words, halo included

__constant__ uint8_t kCodegenOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                          11, 4, 12, 3, 13, 2, 14, 1, 15};

// The C's BitReader at a bit position: peek zero-pads past the data,
// consume past it fails.  n <= 9.
struct ScanBits {
  const uint8_t* in;
  long long nbits;
  long long pos;
  __device__ __forceinline__ uint32_t peek(int n) const {
    const long long b = pos >> 3;
    uint32_t v = 0;
    if ((b << 3) < nbits) v = in[b];
    if (((b + 1) << 3) < nbits) v |= static_cast<uint32_t>(in[b + 1]) << 8;
    return (v >> (pos & 7)) & ((1u << n) - 1);
  }
  __device__ __forceinline__ bool consume(int n) {
    if (pos + n > nbits) return false;
    pos += n;
    return true;
  }
  __device__ __forceinline__ bool read(int n, uint32_t& v) {
    v = peek(n);
    return consume(n);
  }
};

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

// read_code_lens for `hcount` lengths of an arr_len array, reduced to the
// histogram of the lengths written (count[1..15]) and, for the
// literal/length run, whether position 256 got a nonzero length.  cnt and
// sorted are the complete code-length code in canonical form.
__device__ bool scan_read_lens(ScanBits& br, const int* cnt,
                               const uint8_t* sorted, int hcount, int arr_len,
                               int* count, bool& has256) {
  int pos = 0, prev = 0;
  has256 = false;
  while (pos < hcount) {
    const uint32_t bits = br.peek(7);
    int code = 0, first = 0, index = 0, sym = -1, len = 0;
    for (int l = 1; l <= 7; ++l) {          // canonical decode, MSB-first
      code |= (bits >> (l - 1)) & 1;
      if (code - first < cnt[l]) {
        sym = sorted[index + code - first];
        len = l;
        break;
      }
      index += cnt[l];
      first = (first + cnt[l]) << 1;
      code <<= 1;
    }
    if (sym < 0 || !br.consume(len)) return false;
    if (sym < 16) {
      if (pos >= arr_len) return false;
      if (pos == 256) has256 = sym != 0;
      count[sym] += sym != 0;
      prev = sym;
      ++pos;
    } else if (sym == 16) {
      uint32_t v;
      if (!br.read(2, v)) return false;
      const int rep = static_cast<int>(v) + 3;
      if (pos == 0 || pos + rep > arr_len) return false;
      if (pos <= 256 && 256 < pos + rep) has256 = prev != 0;
      if (prev) count[prev] += rep;
      pos += rep;
    } else {
      uint32_t v;
      const bool r17 = sym == 17;
      if (!br.read(r17 ? 3 : 7, v)) return false;
      pos += static_cast<int>(v) + (r17 ? 3 : 11);
      prev = 0;
    }
  }
  return pos <= hcount;
}

// validate_dyn_header at BFINAL bit p (the cheap filter already passed, so
// the code-length code is complete).
__device__ bool scan_validate(const uint8_t* in, long long nbits,
                              long long p) {
  ScanBits br{in, nbits, p + 3};
  uint32_t hlit, hdist, hclen;
  if (!br.read(5, hlit) || !br.read(5, hdist) || !br.read(4, hclen))
    return false;
  hlit += 257;
  hdist += 1;
  hclen += 4;
  if (hlit > 286 || hdist > 30) return false;
  uint8_t cl[19] = {0};
  for (uint32_t i = 0; i < hclen; ++i) {
    uint32_t v;
    if (!br.read(3, v)) return false;
    cl[kCodegenOrder[i]] = static_cast<uint8_t>(v);
  }
  int cnt[8] = {0};
  for (int s = 0; s < 19; ++s) cnt[cl[s]] += cl[s] != 0;
  int left = 1;                              // build_table's check_lens
  for (int l = 1; l <= 7; ++l) {
    left <<= 1;
    if (cnt[l] > left) return false;
    left -= cnt[l];
  }
  if (left != 0) return false;               // also the all-zero code
  int offs[8];
  offs[1] = 0;
  for (int l = 1; l < 7; ++l) offs[l + 1] = offs[l] + cnt[l];
  uint8_t sorted[19];
  for (int s = 0; s < 19; ++s)
    if (cl[s]) sorted[offs[cl[s]]++] = static_cast<uint8_t>(s);
  int count[16] = {0};
  bool has256;
  if (!scan_read_lens(br, cnt, sorted, static_cast<int>(hlit), 286, count,
                      has256))
    return false;
  int dcount[16] = {0};
  bool unused;
  if (!scan_read_lens(br, cnt, sorted, static_cast<int>(hdist), 30, dcount,
                      unused))
    return false;
  return scan_check_counts(count, has256, true) &&
         scan_check_counts(dcount, true, false);
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint8_t* __restrict__ in, long long in_len, long long lo,
            long long hi, uint32_t* __restrict__ bitmap, long long nwords) {
  __shared__ uint32_t tile[kScanWords];
  const long long lo0 = lo & ~31LL;
  const long long base = lo0 + static_cast<long long>(blockIdx.x) * kScanTile;
  const long long byte0 = base >> 3;
  for (int i = threadIdx.x; i < kScanWords; i += blockDim.x) {
    const long long b = byte0 + 4 * i;
    uint32_t w = 0;
    for (int k = 0; k < 4; ++k)
      if (b + k < in_len) w |= static_cast<uint32_t>(in[b + k]) << (8 * k);
    tile[i] = w;
  }
  __syncthreads();
  const long long nbits = 8 * in_len;
  for (int j = 0; j < kScanPerThread; ++j) {
    const int rel = j * kScanThreads + threadIdx.x;
    const long long p = base + rel;
    bool ok = false;
    if (p >= lo && p < hi) {
      const int wi = rel >> 5, s = rel & 31;
      const uint64_t a = tile[wi] | static_cast<uint64_t>(tile[wi + 1]) << 32;
      const uint64_t b =
          tile[wi + 2] | static_cast<uint64_t>(tile[wi + 3]) << 32;
      const uint64_t v = s ? (a >> s) | (b << (64 - s)) : a;   // bits p .. p+63
      if (((v >> 1) & 3) == 2 && ((v >> 3) & 31) <= 29 &&
          ((v >> 8) & 31) <= 29) {
        const int hclen = static_cast<int>((v >> 13) & 15) + 4;
        const uint64_t f = (v >> 17) | ((b >> s) << 47);     // 57 bits at p+17
        int kraft = 0;
        for (int i = 0; i < 19; ++i) {
          const int len = static_cast<int>((f >> (3 * i)) & 7);
          kraft += i < hclen && len ? 128 >> len : 0;
        }
        ok = kraft == 128 && scan_validate(in, nbits, p);
      }
    }
    const uint32_t m = __ballot_sync(0xffffffffu, ok);
    const long long word =
        (base + j * kScanThreads + (threadIdx.x & ~31) - lo0) >> 5;
    if ((threadIdx.x & 31) == 0 && word < nwords) bitmap[word] = m;
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

int flate_scan_headers(const void* in, void* bitmap, long long in_len,
                       long long lo, long long hi, void* stream) {
  if (hi <= lo) return static_cast<int>(cudaGetLastError());
  if (lo < 0 || hi > 8 * in_len) return static_cast<int>(cudaErrorInvalidValue);
  const long long lo0 = lo & ~31LL;
  const long long blocks = (hi - lo0 + kScanTile - 1) / kScanTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<static_cast<unsigned>(blocks), kScanThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), in_len, lo, hi,
      static_cast<uint32_t*>(bitmap), (hi - lo0 + 31) / 32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

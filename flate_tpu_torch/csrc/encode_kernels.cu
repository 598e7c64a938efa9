// Hand-written Hopper (sm_90a) kernels of the device gzip encode path.
//
// Seven kernels, each the counterpart of one Pallas kernel of the JAX
// package.  They compute what the TPU kernels compute, not how: the TPU
// versions tile (8, 1024) vregs, halo neighbouring tiles through extra
// BlockSpecs and count runs by saturating doubling because VMEM rounds are
// cheap there.  On the H100 each is one thread per position (or field),
// reading device memory directly; the parse walk (B9) is one chain per row.
// All but B9 are bound by memory traffic (a few bytes moved per position, a
// handful of integer operations); the design keeps each thread's reads
// within a few cache lines of its neighbours' so warps stay coalesced where
// the data allows.
//
// Interface: plain C (ctypes), every entry point launches on the caller's
// stream and returns cudaGetLastError().  Buffers are allocated by the
// Python wrappers (flate_tpu_torch/device/*.py), which check dtype, shape,
// device and contiguity before calling.
//
// u32 quantities travel as int32 bit patterns in 32-bit buffers, sort keys
// as non-negative int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kHashMul = 0x9E3779B1u;   // Fibonacci hashing multiplier
constexpr int kPosBits = 18;                  // window <= 256 KiB positions
constexpr uint32_t kPosMask = (1u << kPosBits) - 1u;
constexpr int kHashBits = 32 - kPosBits;      // 14-bit buckets
constexpr long long kSentinel = 0xFFFFFFFFll;
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kThreads = 256;
constexpr uint32_t kFpMul = 0x01000193u;      // FNV prime: fingerprint polynomial
constexpr int kWalkThreads = 128;             // B9: threads that clear a row
constexpr int kWalkSharedMax = 8192;          // B9: longest row staged in shared memory

inline unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// --------------------------------------------------------------------------
// B1 prep — replaces flate_tpu/jx/match2.py:_prep_kernel (via _prep).
// Per position: ne little-endian carry words of the bytes from pos onward
// (zero past W), then nf fingerprint words — word j mixes the little-endian
// words [ne*2^j, ne*2^(j+1)) as fp = fp * 0x01000193 + word in u32
// wraparound — and the sort key hash<<18 | pos, or 0xFFFFFFFF for pad
// positions pos >= W.  Bound: bytes — W bytes in, 8 + 4*(ne+nf) bytes out
// per position; each thread's 4*ne*2^nf-byte read overlaps its neighbours',
// so the window is served from L1/L2 after the first touch.
// --------------------------------------------------------------------------
__global__ void prep_kernel(const uint8_t* __restrict__ window,
                            long long* __restrict__ key,
                            uint32_t* __restrict__ words,
                            int B, int W, int Wp, int ne, int nf,
                            int hash_bytes) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= static_cast<long long>(B) * Wp) return;
  int b = static_cast<int>(gid / Wp);
  int pos = static_cast<int>(gid - static_cast<long long>(b) * Wp);
  const uint8_t* row = window + static_cast<long long>(b) * W;
  auto at = [&](int i) -> uint32_t { return i < W ? row[i] : 0u; };
  auto le_word = [&](int w) -> uint32_t {
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j) v |= at(pos + 4 * w + j) << (8 * j);
    return v;
  };
  uint32_t* wout = words + static_cast<long long>(b) * (ne + nf) * Wp + pos;
  for (int w = 0; w < ne; ++w) {
    uint32_t v = le_word(w);
    if (w == 0 && hash_bytes < 4) v &= (1u << (8 * hash_bytes)) - 1u;
    wout[static_cast<long long>(w) * Wp] = v;
  }
  for (int j = 0; j < nf; ++j) {
    int lo = ne << j, hi = ne << (j + 1);
    uint32_t fp = le_word(lo);
    for (int w = lo + 1; w < hi; ++w) fp = fp * kFpMul + le_word(w);
    wout[static_cast<long long>(ne + j) * Wp] = fp;
  }
  // big-endian packed prefix for the Fibonacci hash
  uint32_t v = 0;
  for (int j = 0; j < hash_bytes; ++j) v = (v << 8) | at(pos + j);
  uint32_t h = (v * kHashMul) >> (32 - kHashBits);
  key[gid] = pos < W ? static_cast<long long>((h << kPosBits) | static_cast<uint32_t>(pos))
                     : kSentinel;
}

// --------------------------------------------------------------------------
// B2 matcher — replaces flate_tpu/jx/match2.py:_matcher_kernel (via
// _run_matcher).  One thread per sorted row i: scans rows i-1 .. i-K of the
// same batch row (sorted by (hash, pos), so these are the K most recent
// same-bucket predecessors); a candidate is valid with the same bucket,
// 1 <= dist <= max_dist and a source in [min_src, limit).  Length = equal
// leading bytes over the ne exact carry words, capped at min(258,
// limit-pos).  With nf > 0 a candidate that fills the exact cap ranks as
// longer by cap<<j for every leading fingerprint word j that agrees; the
// fingerprints themselves are compared, so a collision ranks as it does in
// the reference, and the length written is always the exact one.  Keeps
// the best (rank<<16)-dist with len >= 3, ties to the first (nearest)
// candidate, and with out2 the runner-up too: a new best demotes the old
// one, otherwise a candidate above the runner-up replaces it, in scan
// order.  Writes len<<16|dist at the row's POSITION: the unsort is the
// inverse-permutation scatter, fused here, for both outputs.
// Bound: bytes — the sorted key row is read once (coalesced), the words are
// gathered by position (random, 4*(ne+nf) bytes per candidate).  Earlier
// rows in sort order hold smaller keys, so the first candidate of another
// bucket ends the scan.
// --------------------------------------------------------------------------
__global__ void matcher_kernel(const long long* __restrict__ skey,
                               const uint32_t* __restrict__ words,
                               const int* __restrict__ min_src,
                               const int* __restrict__ limit,
                               int* __restrict__ out,
                               int* __restrict__ out2,
                               int B, int W, int Wp, int ne, int nf, int K,
                               int max_dist) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= static_cast<long long>(B) * Wp) return;
  long long tk = skey[gid];
  if (tk == kSentinel) return;                 // pad rows sort last
  int b = static_cast<int>(gid / Wp);
  int i = static_cast<int>(gid - static_cast<long long>(b) * Wp);
  uint32_t tkey = static_cast<uint32_t>(tk);
  int tpos = static_cast<int>(tkey & kPosMask);
  uint32_t tbucket = tkey >> kPosBits;
  int ms = min_src[b];
  int lim = limit[b];
  int maxlen = min(kMaxMatch, lim - tpos);
  int cap = 4 * ne;
  const long long* krow = skey + static_cast<long long>(b) * Wp;
  const uint32_t* wrow = words + static_cast<long long>(b) * (ne + nf) * Wp;
  int best_score = -1, best = 0;
  int sec_score = -1, sec = 0;
  for (int k = 1; k <= K && i - k >= 0; ++k) {
    uint32_t ck = static_cast<uint32_t>(krow[i - k]);
    if ((ck >> kPosBits) != tbucket) break;
    int cpos = static_cast<int>(ck & kPosMask);
    int dist = tpos - cpos;
    if (dist < 1 || dist > max_dist || cpos < ms || cpos >= lim) continue;
    int ml = 0;
    for (int t = 0; t < ne; ++t) {
      uint32_t x = wrow[static_cast<long long>(t) * Wp + tpos] ^
                   wrow[static_cast<long long>(t) * Wp + cpos];
      if (x == 0) { ml += 4; continue; }
      ml += (__ffs(x) - 1) >> 3;               // equal low-order bytes
      break;
    }
    ml = min(ml, maxlen);
    if (ml < kMinMatch) continue;
    int est = ml;
    if (ml == cap) {
      for (int j = 0; j < nf; ++j) {
        if (wrow[static_cast<long long>(ne + j) * Wp + tpos] !=
            wrow[static_cast<long long>(ne + j) * Wp + cpos]) break;
        est += cap << j;
      }
    }
    int score = (est << 16) - dist;
    int ld = (ml << 16) | dist;
    if (score > best_score) {
      sec_score = best_score;
      sec = best;
      best_score = score;
      best = ld;
    } else if (score > sec_score) {
      sec_score = score;
      sec = ld;
    }
  }
  out[static_cast<long long>(b) * W + tpos] = best;
  if (out2 != nullptr) out2[static_cast<long long>(b) * W + tpos] = sec;
}

// --------------------------------------------------------------------------
// B3 small-distance runs — replaces flate_tpu/jx/runs.py:_small_runs_kernel
// (via small_dist_runs).  For d in {1,2,3,4,8}: the forward run of
// w[x] == w[x-d] with x >= min_src + d, clamped to min(258, limit-pos);
// the best (len, d) by (len<<16)-d, first d on ties.  The TPU counts runs
// by saturating doubling; a direct count up to the clamp gives the same
// value.  Bound: bytes — W bytes in, 8 bytes out per position; the up to
// 258 compares per d hit L1 (neighbouring threads read the same bytes).
// --------------------------------------------------------------------------
__global__ void small_runs_kernel(const uint8_t* __restrict__ window,
                                  const int* __restrict__ limit,
                                  const int* __restrict__ min_src,
                                  int* __restrict__ out_len,
                                  int* __restrict__ out_dist,
                                  int B, int W) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= static_cast<long long>(B) * W) return;
  int b = static_cast<int>(gid / W);
  int x = static_cast<int>(gid - static_cast<long long>(b) * W);
  const uint8_t* row = window + static_cast<long long>(b) * W;
  int maxlen = max(0, min(limit[b] - x, kMaxMatch));
  int ms = min_src[b];
  const int dists[5] = {1, 2, 3, 4, 8};
  int best_len = 0, best_dist = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    int d = dists[j];
    int ln = 0;
    if (x >= ms + d) {
      while (ln < maxlen && row[x + ln] == row[x + ln - d]) ++ln;
    }
    if (ln >= kMinMatch &&
        (best_len == 0 || ((ln << 16) - d) > ((best_len << 16) - best_dist))) {
      best_len = ln;
      best_dist = d;
    }
  }
  out_len[gid] = best_len;
  out_dist[gid] = best_dist;
}

// --------------------------------------------------------------------------
// B4 chain extension — replaces flate_tpu/jx/runs.py:_extend_kernel (via
// extend_chains).  A match saturated at the carry cap continues through
// same-distance matches at p+cap, p+2cap, ... for at most ceil(258/cap)+1
// hops; the result is clamped to min(258, limit-pos).  Arrays read as 0 past
// W, as the TPU's zero tile does.  Bound: bytes — 8 bytes in, 4 out per
// position; the hops re-read neighbours' entries from cache.
// --------------------------------------------------------------------------
__global__ void extend_kernel(const int* __restrict__ mlen,
                              const int* __restrict__ mdist,
                              const int* __restrict__ limit,
                              int* __restrict__ out,
                              int B, int W, int cap) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= static_cast<long long>(B) * W) return;
  int b = static_cast<int>(gid / W);
  int p = static_cast<int>(gid - static_cast<long long>(b) * W);
  const int* l = mlen + static_cast<long long>(b) * W;
  const int* d = mdist + static_cast<long long>(b) * W;
  auto L = [&](int q) { return q < W ? l[q] : 0; };
  auto D = [&](int q) { return q < W ? d[q] : 0; };
  int rounds = (kMaxMatch + cap - 1) / cap + 1;
  int total = 0;
  int q = p;
  for (int r = 0; r < rounds; ++r) {
    int dq = D(q);
    if (!(L(q) == cap && dq > 0 && D(q + cap) == dq)) break;
    total += cap;
    q += cap;
  }
  total += L(q);
  int maxlen = max(0, min(limit[b] - p, kMaxMatch));
  out[gid] = min(min(total, kMaxMatch), maxlen);
}

// --------------------------------------------------------------------------
// B8 top-2 chain extension — replaces flate_tpu/jx/runs.py:_extend2_kernel
// (via extend_chains2).  Each position holds two candidates (len, dist).  A
// candidate saturated at the carry cap with distance d continues through
// p+cap when either of p+cap's candidates has distance d (the first one
// preferred), and so on for at most ceil(258/cap)+1 hops; the lengths of
// the hops add up.  Both candidates are extended, clamped to min(258,
// limit-pos), and the better (len<<16)-dist is kept; below 3 it is dropped.
// Arrays read as 0 past W, as the TPU's zero tile does.  The TPU composes
// the chains in rounds over (9, 1024) tiles with roll-and-select shifts;
// here one thread follows its two chains forward.  Bound: bytes — 16 bytes
// in, 8 out per position; the hops re-read neighbours' entries from cache.
// --------------------------------------------------------------------------
__global__ void extend2_kernel(const int* __restrict__ l1,
                               const int* __restrict__ d1,
                               const int* __restrict__ l2,
                               const int* __restrict__ d2,
                               const int* __restrict__ limit,
                               int* __restrict__ out_len,
                               int* __restrict__ out_dist,
                               int B, int W, int cap) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= static_cast<long long>(B) * W) return;
  int b = static_cast<int>(gid / W);
  int p = static_cast<int>(gid - static_cast<long long>(b) * W);
  long long base = static_cast<long long>(b) * W;
  const int* la = l1 + base;
  const int* da = d1 + base;
  const int* lb = l2 + base;
  const int* db = d2 + base;
  int rounds = (kMaxMatch + cap - 1) / cap + 1;
  int maxlen = max(0, min(limit[b] - p, kMaxMatch));
  // extended length of the chain that starts with a link of length `cur`
  // and distance `d` at p
  auto follow = [&](int cur, int d) -> int {
    int total = 0;
    int q = p;
    for (int r = 0; r < rounds; ++r) {
      if (cur != cap || d <= 0 || q + cap >= W) break;
      q += cap;
      if (da[q] == d) cur = la[q];       // the first candidate is preferred
      else if (db[q] == d) cur = lb[q];
      else { cur = cap; break; }         // the link at q-cap ends the chain
      total += cap;
    }
    return min(min(total + cur, kMaxMatch), maxlen);
  };
  int d[2] = {da[p], db[p]};
  int t[2] = {follow(la[p], d[0]), follow(lb[p], d[1])};
  int s1 = t[0] >= kMinMatch ? (t[0] << 16) - d[0] : -1;
  int s2 = t[1] >= kMinMatch ? (t[1] << 16) - d[1] : -1;
  int ol = s2 > s1 ? t[1] : t[0];
  int od = s2 > s1 ? d[1] : d[0];
  bool live = ol >= kMinMatch;
  out_len[gid] = live ? ol : 0;
  out_dist[gid] = live ? od : 0;
}

// --------------------------------------------------------------------------
// B9 parse walk — replaces flate_tpu/jx/parse.py:_walk_kernel (via
// _parse_walk_pallas).  Per row of n steps >= 1: from 0, mark i, add
// step[i], until i >= n; the marks are the token starts.  One block per
// row: its threads clear the mask with 16-byte stores (byte stores when n
// is no multiple of 16), then one thread follows the chain.  A row of at
// most 8192 steps (a parse block: 1024 or 4096) is first copied into
// shared memory with its mask, so that the chase waits on shared memory
// and the mask leaves in wide stores; a longer row (a whole shard) is
// chased in device memory.  The TPU marks through one-hot row updates
// because it has no scalar stores; here a mark is one byte store.
// Bound: operations, and latency at that — every step waits for the load
// before it, one thread a row.  With rows = parse blocks the card has
// thousands of short chains to interleave; with rows = shards only B
// threads of it work.
// --------------------------------------------------------------------------
__global__ void parse_walk_kernel(const int* __restrict__ step,
                                  uint8_t* __restrict__ mask, int n,
                                  int staged) {
  extern __shared__ int shared_row[];
  long long base = static_cast<long long>(blockIdx.x) * n;
  const int* s = step + base;
  uint8_t* m = mask + base;
  uint8_t* sm = reinterpret_cast<uint8_t*>(shared_row + n);
  bool wide = (n & 15) == 0;             // rows start 16-byte aligned
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      shared_row[i] = s[i];
      sm[i] = 0;
    }
  } else if (wide) {
    uint4* m16 = reinterpret_cast<uint4*>(m);
    for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
      m16[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) m[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* sp = staged ? shared_row : s;
    uint8_t* mp = staged ? sm : m;
    int i = 0;
    while (i < n) {
      mp[i] = 1;
      int a = sp[i];
      i += a > 0 ? a : 1;                // a step of 0 would never end
    }
  }
  if (!staged) return;
  __syncthreads();
  if (wide) {
    const uint4* sm16 = reinterpret_cast<const uint4*>(sm);
    uint4* m16 = reinterpret_cast<uint4*>(m);
    for (int i = threadIdx.x; i < n / 16; i += blockDim.x) m16[i] = sm16[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) m[i] = sm[i];
  }
}

// --------------------------------------------------------------------------
// B5 bit placement — replaces flate_tpu/jx/pack.py:_pack_kernel (via
// pack_fields).  One thread per field: ORs v<<sh into word off>>5 and, when
// the field straddles, v>>(32-sh) into the next word.  Offsets are the
// exclusive prefix sum of the field widths (computed by the wrapper); the
// words are zeroed by the wrapper, so the zero tail is exact.  The TPU uses
// two bf16 one-hot matmuls per 512 fields because it has no scatter; the
// H100 has atomics.  Bound: bytes — 12 bytes in per field, the packed
// words out.
// --------------------------------------------------------------------------
__global__ void pack_kernel(const long long* __restrict__ vals,
                            const int* __restrict__ off,
                            uint32_t* __restrict__ words,
                            int B, int slots, int nwords) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= static_cast<long long>(B) * slots) return;
  uint32_t v = static_cast<uint32_t>(vals[gid]);
  if (v == 0) return;
  int b = static_cast<int>(gid / slots);
  int o = off[gid];
  int w = o >> 5;
  int sh = o & 31;
  uint32_t* row = words + static_cast<long long>(b) * nwords;
  if (w < nwords) atomicOr(row + w, v << sh);
  if (sh != 0 && w + 1 < nwords) {
    uint32_t hi = v >> (32 - sh);
    if (hi) atomicOr(row + w + 1, hi);
  }
}

}  // namespace

extern "C" {

int flate_prep(const void* window, void* key, void* words, int B, int W,
               int Wp, int ne, int nf, int hash_bytes, void* stream) {
  long long n = static_cast<long long>(B) * Wp;
  if (n > 0)
    prep_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(window), static_cast<long long*>(key),
        static_cast<uint32_t*>(words), B, W, Wp, ne, nf, hash_bytes);
  return static_cast<int>(cudaGetLastError());
}

int flate_matcher(const void* skey, const void* words, const void* min_src,
                  const void* limit, void* out, void* out2, int B, int W,
                  int Wp, int ne, int nf, int K, int max_dist, void* stream) {
  long long n = static_cast<long long>(B) * Wp;
  if (n > 0)
    matcher_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(skey), static_cast<const uint32_t*>(words),
        static_cast<const int*>(min_src), static_cast<const int*>(limit),
        static_cast<int*>(out), static_cast<int*>(out2), B, W, Wp, ne, nf, K,
        max_dist);
  return static_cast<int>(cudaGetLastError());
}

int flate_small_runs(const void* window, const void* limit,
                     const void* min_src, void* out_len, void* out_dist,
                     int B, int W, void* stream) {
  long long n = static_cast<long long>(B) * W;
  if (n > 0)
    small_runs_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(window), static_cast<const int*>(limit),
        static_cast<const int*>(min_src), static_cast<int*>(out_len),
        static_cast<int*>(out_dist), B, W);
  return static_cast<int>(cudaGetLastError());
}

int flate_extend(const void* mlen, const void* mdist, const void* limit,
                 void* out, int B, int W, int cap, void* stream) {
  long long n = static_cast<long long>(B) * W;
  if (n > 0)
    extend_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(mlen), static_cast<const int*>(mdist),
        static_cast<const int*>(limit), static_cast<int*>(out), B, W, cap);
  return static_cast<int>(cudaGetLastError());
}

int flate_extend2(const void* l1, const void* d1, const void* l2,
                  const void* d2, const void* limit, void* out_len,
                  void* out_dist, int B, int W, int cap, void* stream) {
  long long n = static_cast<long long>(B) * W;
  if (n > 0)
    extend2_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(l1), static_cast<const int*>(d1),
        static_cast<const int*>(l2), static_cast<const int*>(d2),
        static_cast<const int*>(limit), static_cast<int*>(out_len),
        static_cast<int*>(out_dist), B, W, cap);
  return static_cast<int>(cudaGetLastError());
}

int flate_parse_walk(const void* step, void* mask, int R, int n,
                     void* stream) {
  if (R > 0 && n > 0) {
    int staged = n <= kWalkSharedMax;
    size_t shared = staged ? static_cast<size_t>(n) * 5 : 0;   // steps + mask
    parse_walk_kernel<<<static_cast<unsigned>(R), kWalkThreads, shared,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(step), static_cast<uint8_t*>(mask), n, staged);
  }
  return static_cast<int>(cudaGetLastError());
}

int flate_pack(const void* vals, const void* off, void* words, int B,
               int slots, int nwords, void* stream) {
  long long n = static_cast<long long>(B) * slots;
  if (n > 0)
    pack_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(vals), static_cast<const int*>(off),
        static_cast<uint32_t*>(words), B, slots, nwords);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels of the device gzip encode path.
//
// Seven kernels, each the counterpart of one Pallas kernel of the JAX
// package, and the squeeze's cost DP, which the JAX package leaves to XLA
// (a half-warp a parse block: see squeeze_dp_kernel).  They compute what
// the TPU kernels compute, not how: the TPU versions tile (8, 1024) vregs,
// halo neighbouring tiles through extra BlockSpecs and count runs by
// saturating doubling because VMEM rounds are cheap there.  On the H100 the
// chain extensions (B4, B8) are one thread per position, reading device
// memory directly; the prep (B1: a block stages a tile of bytes and a
// thread hashes 4 positions), the matcher (B2: a block stages a tile of
// sorted rows and their candidates), the small-distance runs (B3: a block
// stages a tile and reads runs off stop bitmaps) and the bit pack (B5: a
// block packs a tile of fields into its words, its offset from a
// single-pass scan) work from shared memory, and the parse walk (B9) chases
// one chain per row there — a warp stages a parse block, a longer row
// streams through ring_walk.cuh.
// B1 and B3-B5 are bound by memory traffic (a few bytes moved per
// position, a handful of integer operations).
//
// Interface: plain C (ctypes), every entry point launches on the caller's
// stream and returns cudaGetLastError().  Buffers are allocated by the
// Python wrappers (flate_tpu_torch/device/*.py), which check dtype, shape,
// device and contiguity before calling.
//
// u32 quantities travel as int32 bit patterns in 32-bit buffers; a sort
// key travels as u32 key ^ 0x80000000, whose int32 order is the u32 order.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_walk.cuh"

namespace {

constexpr uint32_t kHashMul = 0x9E3779B1u;   // Fibonacci hashing multiplier
constexpr int kPosBits = 18;                  // window <= 256 KiB positions
constexpr uint32_t kPosMask = (1u << kPosBits) - 1u;
constexpr int kHashBits = 32 - kPosBits;      // 14-bit buckets
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kThreads = 256;
constexpr uint32_t kFpMul = 0x01000193u;      // FNV prime: fingerprint polynomial

inline unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// --------------------------------------------------------------------------
// B1 prep — replaces flate_tpu/jx/match2.py:_prep_kernel (via _prep).
// Per position: the sort key hash<<18 | pos, or 0xFFFFFFFF for pad
// positions pos >= W, and nf fingerprint words — word j mixes the
// little-endian words [ne*2^j, ne*2^(j+1)) of the bytes from pos onward
// (zero past W) as fp = fp * 0x01000193 + word in u32 wraparound.  The
// TPU kernel also writes the ne exact carry words, which ride its sort;
// here B2 builds them from the window, so they are not written.  The key
// is written as the int32 bit pattern of key ^ 0x80000000 (kKeyFlip), so
// that a signed 32-bit sort orders it as the u32 key: PyTorch's CUDA sort
// takes no uint32, and an int64 key would double the bytes of B1 and of
// the sort.
// Bound: bytes — W bytes in, 4 + 4*nf bytes out a position.  So no byte
// is loaded twice from device memory or bounds-tested alone: a block takes
// a tile of kPrepTile positions of one row and stages its bytes and the
// halo a position reads past it (up to 4*(ne<<nf) - 1 bytes, zero past W,
// never the next row) in shared memory with cp.async 16-byte copies (byte
// copies when W % 16 != 0 or the row is unaligned); a thread then takes 4
// consecutive positions at a time from two aligned words and each word
// past them by funnel shifts (the big-endian hash prefix by __byte_perm),
// and writes its 4 keys, and 4 words of each fingerprint plane, with
// 16-byte stores.
// --------------------------------------------------------------------------
constexpr int kPrepTile = 4096;                 // positions a block
constexpr int kPrepThreads = 256;
constexpr uint32_t kSentinel32 = 0xFFFFFFFFu;
constexpr uint32_t kKeyFlip = 0x80000000u;      // stored key = u32 key ^ flip
constexpr int kMaxGridY = 65535;                // rows past it go to gridDim.z

// Bytes prep_kernel stages: the tile and the words past it that its last
// group of 4 positions reads (4 * span4 bytes), in 16-byte copies.
__host__ __device__ constexpr int prep_stage(int span4) {
  return kPrepTile + ((4 * span4 + 15) & ~15);
}

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const uint8_t* __restrict__ window, int* __restrict__ key,
            uint32_t* __restrict__ words, int B, int W, int Wp, int ne,
            int nf, int hash_bytes, int stage, int vec_in) {
  extern __shared__ __align__(16) uint8_t prep_smem[];   // w[t0 + i], 0 past W
  const int t0 = blockIdx.x * kPrepTile;
  const int b = blockIdx.z * kMaxGridY + blockIdx.y;
  if (b >= B) return;
  const uint8_t* row = window + static_cast<long long>(b) * W;
  if (vec_in) {                                // W % 16 == 0: no copy straddles W
    for (int i = threadIdx.x; i < stage / 16; i += kPrepThreads) {
      const int y = t0 + 16 * i;
      if (y < W) ring::cp_async16(prep_smem + 16 * i, row + y);
      else reinterpret_cast<uint4*>(prep_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    ring::cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < stage; i += kPrepThreads) {
      const int y = t0 + i;
      prep_smem[i] = y < W ? row[y] : 0;
    }
  }
  __syncthreads();
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(prep_smem);
  const int hshift = 8 * (4 - hash_bytes);     // big-endian prefix of hash_bytes
  const long long at = static_cast<long long>(b) * Wp + t0;
  for (int g = threadIdx.x; g < kPrepTile / 4; g += kPrepThreads) {
    const int p = 4 * g;                       // the group's first position
    const uint32_t a0 = s32[g], a1 = s32[g + 1];
    uint32_t k[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t le = __funnelshift_r(a0, a1, 8 * q);
      const uint32_t v = __byte_perm(le, 0u, 0x0123) >> hshift;
      const uint32_t h = (v * kHashMul) >> (32 - kHashBits);
      const int pos = t0 + p + q;
      k[q] = (pos < W ? (h << kPosBits) | static_cast<uint32_t>(pos) : kSentinel32)
             ^ kKeyFlip;
    }
    *reinterpret_cast<int4*>(key + at + p) =
        make_int4(static_cast<int>(k[0]), static_cast<int>(k[1]),
                  static_cast<int>(k[2]), static_cast<int>(k[3]));
    for (int j = 0; j < nf; ++j) {
      const int lo = ne << j, hi = ne << (j + 1);
      uint32_t fp[4];
      uint32_t w0 = s32[g + lo];
      for (int w = lo; w < hi; ++w) {
        const uint32_t w1 = s32[g + w + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t x = __funnelshift_r(w0, w1, 8 * q);
          fp[q] = w == lo ? x : fp[q] * kFpMul + x;
        }
        w0 = w1;
      }
      *reinterpret_cast<uint4*>(words + (static_cast<long long>(b) * nf + j) * Wp +
                                t0 + p) = make_uint4(fp[0], fp[1], fp[2], fp[3]);
    }
  }
}

// --------------------------------------------------------------------------
// B2 matcher — replaces flate_tpu/jx/match2.py:_matcher_kernel (via
// _run_matcher).  Per sorted row i: scans rows i-1 .. i-K of the same batch
// row (sorted by (hash, pos), so these are the K most recent same-bucket
// predecessors); a candidate is valid with the same bucket,
// 1 <= dist <= max_dist and a source in [min_src, limit).  Length = equal
// leading bytes over the ne exact carry words, capped at min(258,
// limit-pos).  With nf > 0 a candidate that fills the exact cap ranks as
// longer by cap<<j for every leading fingerprint word j that agrees; the
// fingerprints themselves are compared, so a collision ranks as it does in
// the reference, and the length written is always the exact one.  Keeps
// the best (rank<<16)-dist with len >= 3 and, with out2, the runner-up.
// Writes len<<16|dist at the row's POSITION: the unsort is the
// inverse-permutation scatter, fused here, for both outputs.
//
// Design.  Sorted neighbours share almost all their candidates, so one
// block takes a tile of T consecutive sorted rows of one batch row and
// stages, once, the T + K keys (as u32) and each staged row's NE carry
// words in shared memory; each thread then scans its rows' predecessors
// from there with the target's words in registers (NE is a template
// parameter, so the compares unroll).  The words are built from the
// window (B, W) bytes, which stay in L2 (10.5 MB a batch): word t of
// position pos is the little-endian bytes from pos + 4t, zero past W, word
// 0 masked to hash_bytes bytes in the 3-byte pass — the TPU kernel's carry
// words exactly.  Fingerprint words (nf > 0) are read from B1's output,
// only for candidates that fill the exact cap.  A row of NE|1 words (odd)
// spreads a warp's rows over the banks.  NE is the least of 1, 2, 4, 8,
// 16 and 65 that holds ne: the length is cut at the cap 4*ne, so the words
// past ne change nothing, and 65 words (260 bytes) reach past any length's
// 258.  Within a row every candidate has its own distance, so the scores
// are distinct and the best and runner-up are the two largest whatever the
// scan order.  Going back in sort order, a bucket's positions fall, so the
// scan ends at the first candidate of another bucket, past max_dist or
// below min_src (every later one fails too); a row with fewer than 3 bytes
// before its limit has no match and is not scanned.  The next candidate's
// key is loaded while the current one is compared.
// When the T + K staged rows' words do not fit in shared memory even at T
// = kMatchThreads (NE = 65 with K >= 625), HALO is set: only the tile's T
// rows keep their words in shared memory, the K halo rows keep their keys,
// and a halo candidate's words are built from the window as it is compared
// (window_match), as far as the first word that differs.
// The sorted keys arrive as B1 stores them (int32, u32 key ^ kKeyFlip) and
// are flipped back as they are staged.
// Bound: bytes — the sorted keys (u32), the window, one or two outputs
// (scattered 4-byte stores), and the fingerprint words when nf > 0; the
// window is read (T + K) / T times and every other candidate read comes
// from shared memory.
// --------------------------------------------------------------------------
constexpr int kMatchThreads = 256;
constexpr int kMatchRowsMax = 1024;           // sorted rows a block scans
constexpr size_t kMatchSmemTarget = 64 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

// Words a staged row takes in shared memory: odd, so a warp's rows fall
// in different banks.
__host__ __device__ constexpr int match_stride(int ne) { return ne | 1; }

// Equal leading bytes of the target's words tw and the NE words of the
// window row wrow (nw4 u32 words, zero past them) from position pos, word
// 0 masked by mask0: the staged compare, with the candidate's words built
// as they are needed.
template <int NE>
__device__ __forceinline__ int window_match(const uint32_t (&tw)[NE],
                                            const uint32_t* __restrict__ wrow,
                                            int nw4, int pos, uint32_t mask0) {
  const int w0 = pos >> 2;
  const int sh = (pos & 3) * 8;
  uint32_t lo = w0 < nw4 ? __ldg(wrow + w0) : 0u;
  int ml = 0;
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const uint32_t hi = w0 + t + 1 < nw4 ? __ldg(wrow + w0 + t + 1) : 0u;
    const uint32_t v = __funnelshift_r(lo, hi, sh);
    const uint32_t x = tw[t] ^ (t == 0 ? v & mask0 : v);
    if (x == 0) {
      ml += 4;
      lo = hi;
      continue;
    }
    ml += (__ffs(x) - 1) >> 3;
    break;
  }
  return ml;
}

template <int NE, bool HALO>
__global__ void __launch_bounds__(kMatchThreads)
matcher_kernel(const int* __restrict__ skey,
               const uint32_t* __restrict__ window,
               const uint32_t* __restrict__ fps,
               const int* __restrict__ min_src,
               const int* __restrict__ limit,
               int* __restrict__ out, int* __restrict__ out2,
               int W, int Ww, int Wp, int ne, int nf, int K, int max_dist,
               int hash_bytes, int T) {
  constexpr int stride = match_stride(NE);
  extern __shared__ uint32_t msm[];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * T;               // first sorted row of the tile
  const int rows = T + K;                      // staged: rows i0-K .. i0+T-1
  const int worded = HALO ? K : 0;             // first row staged with words
  uint32_t* skeys = msm;
  uint32_t* cw = msm + rows;                   // words of rows worded ..
  const int* krow = skey + static_cast<long long>(b) * Wp;
  const int nw4 = Ww >> 2;
  const uint32_t* wrow = window + static_cast<long long>(b) * nw4;
  const uint32_t mask0 = hash_bytes < 4 ? (1u << (8 * hash_bytes)) - 1u : ~0u;
  // a thread stages a row: its key, then the NE + 1 aligned window words
  // under its NE words, loaded together, and NE funnel shifts
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int g = i0 - K + r;
    const uint32_t k =                         // B1's stored key, flipped back
        g >= 0 && g < Wp ? static_cast<uint32_t>(krow[g]) ^ kKeyFlip : kSentinel32;
    skeys[r] = k;
    if (r < worded) continue;
    uint32_t* dst = cw + (r - worded) * stride;
    uint32_t a[NE + 1];
    const int pos = static_cast<int>(k & kPosMask);
    const int w0 = pos >> 2;
#pragma unroll
    for (int t = 0; t <= NE; ++t)
      a[t] = k != kSentinel32 && w0 + t < nw4 ? __ldg(wrow + w0 + t) : 0u;
    const int sh = (pos & 3) * 8;
#pragma unroll
    for (int t = 0; t < NE; ++t) {
      const uint32_t v = __funnelshift_r(a[t], a[t + 1], sh);
      dst[t] = t == 0 ? v & mask0 : v;
    }
  }
  __syncthreads();
  const int ms = min_src[b];
  const int lim = limit[b];
  const int cap = 4 * ne;
  const uint32_t* frow = fps + static_cast<long long>(b) * nf * Wp;
  for (int l = threadIdx.x; l < T; l += blockDim.x) {
    const int i = i0 + l;
    if (i >= Wp) break;
    const uint32_t tkey = skeys[l + K];
    if (tkey == kSentinel32) continue;         // pad rows sort last
    const int tpos = static_cast<int>(tkey & kPosMask);
    const uint32_t tbucket = tkey >> kPosBits;
    const int maxlen = min(kMaxMatch, lim - tpos);
    const int mlcap = min(maxlen, cap);
    int best_score = -1, best = 0;
    int sec_score = -1, sec = 0;
    if (maxlen >= kMinMatch) {
      uint32_t tw[NE];
      const uint32_t* trow = cw + (l + K - worded) * stride;
#pragma unroll
      for (int t = 0; t < NE; ++t) tw[t] = trow[t];
      const int kmax = min(K, i);
      uint32_t ck = kmax >= 1 ? skeys[l + K - 1] : kSentinel32;
      for (int k = 1; k <= kmax; ++k) {
        const int r = l + K - k;
        const uint32_t cur = ck;
        ck = k < kmax ? skeys[r - 1] : kSentinel32;   // the next candidate
        const int cpos = static_cast<int>(cur & kPosMask);
        const int dist = tpos - cpos;
        if ((cur >> kPosBits) != tbucket || dist > max_dist || cpos < ms) break;
        if (dist < 1 || cpos >= lim) continue;
        int ml = 0;
        if (HALO && r < worded) {
          ml = window_match<NE>(tw, wrow, nw4, cpos, mask0);
        } else {
          const uint32_t* crow = cw + (r - worded) * stride;
#pragma unroll
          for (int t = 0; t < NE; ++t) {
            const uint32_t x = tw[t] ^ crow[t];
            if (x == 0) { ml += 4; continue; }
            ml += (__ffs(x) - 1) >> 3;         // equal low-order bytes
            break;
          }
        }
        ml = min(ml, mlcap);
        if (ml < kMinMatch) continue;
        int est = ml;
        if (ml == cap) {
          for (int j = 0; j < nf; ++j) {
            if (frow[static_cast<long long>(j) * Wp + tpos] !=
                frow[static_cast<long long>(j) * Wp + cpos]) break;
            est += cap << j;
          }
        }
        const int score = (est << 16) - dist;
        const int ld = (ml << 16) | dist;
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
    }
    out[static_cast<long long>(b) * W + tpos] = best;
    if (out2 != nullptr) out2[static_cast<long long>(b) * W + tpos] = sec;
  }
}

// --------------------------------------------------------------------------
// B3 small-distance runs — replaces flate_tpu/jx/runs.py:_small_runs_kernel
// (via small_dist_runs).  For d in {1,2,3,4,8}: the forward run of
// w[y] == w[y-d] from x, zero unless x >= min_src + d, clamped to
// min(258, limit - x); the best (len, d) by (len<<16)-d, first d on ties,
// only where len >= 3.  Since x >= min_src + d is monotone in x, a run is
// the distance from x to the first y >= x that mismatches or lies at or
// past min(W, limit), capped at 258.
// Bound: bytes — W bytes in, 8 bytes out per position (0.028 ms for a
// 64 x 163,840 batch at 3.35 TB/s).  The first port ran a dependent loop
// of byte loads per (position, d), up to 258 long: a warp waited for its
// longest run, and runs of small d are long in indented text (0.20 ms on
// the mixed batch, 5.3 ms on zeros, replayed from a CUDA graph on an H100
// at 700 W).
// Here a block takes one tile of kRunTile positions of one row (row and
// tile from blockIdx, no division), stages its bytes and the 257-byte
// right halo a run may reach in shared memory, and builds for each d a
// stop bitmap over them with __ballot_sync (a lane a position, 32
// positions a word).  A thread then scores 4 consecutive positions: a d
// whose word shows no three clear bits from any of them is skipped (most
// positions of text and of random bytes have no run of 3); otherwise each
// run is a count of trailing zeros in the positions' own word, or the
// first stop of the next at most 9 words, shared once by the four; both
// outputs go out as 16-byte stores.  Measured the same way: 0.053 ms on
// the mixed batch, 0.037 on random bytes (no run of 3: the stores' time),
// 0.087 on zeros.  On text a warp takes the full path for a d whenever one
// of its 128 positions has a run of 3 there, which is most warps.
// --------------------------------------------------------------------------
constexpr int kNumDists = 5;
constexpr int kRunTile = 4096;                  // positions a block
constexpr int kRunThreads = 256;
constexpr int kRunHalo = kMaxMatch - 1;         // bits right of the tile a run reads
constexpr int kRunWords = (kRunTile + kRunHalo) / 32 + 1;   // stop words a d
constexpr int kRunLead = 16;                    // staged bytes left of the tile (d <= 8)
constexpr int kRunStage = kRunLead + 32 * kRunWords;        // a multiple of 16

__global__ void __launch_bounds__(kRunThreads)
small_runs_kernel(const uint8_t* __restrict__ window,
                  const int* __restrict__ limit,
                  const int* __restrict__ min_src,
                  int* __restrict__ out_len, int* __restrict__ out_dist,
                  int B, int W, int vec_in, int vec_out) {
  __shared__ __align__(16) uint8_t sb[kRunStage];   // sb[i] = w[t0 - 16 + i]
  __shared__ uint32_t stop[kNumDists][kRunWords];
  const int t0 = blockIdx.x * kRunTile;
  const int b = blockIdx.z * kMaxGridY + blockIdx.y;
  if (b >= B) return;
  const uint8_t* row = window + static_cast<long long>(b) * W;
  const int end = min(W, limit[b]);
  const int ms = min_src[b];

  // bytes outside the row read as 0, as the plain version pads them
  if (vec_in) {                                // W % 16 == 0: no copy straddles W
    for (int i = threadIdx.x; i < kRunStage / 16; i += kRunThreads) {
      const int y = t0 - kRunLead + 16 * i;
      if (y >= 0 && y < W) ring::cp_async16(sb + 16 * i, row + y);
      else reinterpret_cast<uint4*>(sb)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    ring::cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < kRunStage; i += kRunThreads) {
      const int y = t0 - kRunLead + i;
      sb[i] = (y >= 0 && y < W) ? row[y] : 0;
    }
  }
  __syncthreads();

  // stop bit j of d: position t0 + j mismatches at d or lies at or past end
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < kRunWords; i += kRunThreads / 32) {
    const int j = 32 * i + lane;
    const uint8_t* p = sb + kRunLead + j;
    const int c = p[0];
    const bool past = t0 + j >= end;
    const uint32_t s1 = __ballot_sync(~0u, past || c != p[-1]);
    const uint32_t s2 = __ballot_sync(~0u, past || c != p[-2]);
    const uint32_t s3 = __ballot_sync(~0u, past || c != p[-3]);
    const uint32_t s4 = __ballot_sync(~0u, past || c != p[-4]);
    const uint32_t s8 = __ballot_sync(~0u, past || c != p[-8]);
    if (lane == 0) {
      stop[0][i] = s1;
      stop[1][i] = s2;
      stop[2][i] = s3;
      stop[3][i] = s4;
      stop[4][i] = s8;
    }
  }
  __syncthreads();

  // A position's best is the longest run, the first d among equals, so
  // the best key over d is len << 3 | (7 - j), kept only where len >= 3.
  // A run of 3 needs three clear stop bits from its position: where the
  // group's word shows none (bits past it read clear), the d is skipped.
  const int dists[kNumDists] = {1, 2, 3, 4, 8};
  const bool near_src = t0 < ms + 8;           // min_src + d may cut runs
  for (int o = 4 * threadIdx.x; o < kRunTile; o += 4 * kRunThreads) {
    const int x0 = t0 + o;
    if (x0 >= W) break;
    const int wi = o >> 5;
    int key[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kNumDists; ++j) {
      const uint32_t m0 = stop[j][wi] >> (o & 31);
      const uint32_t c = ~m0;
      if ((c & (c >> 1) & (c >> 2) & 15u) == 0u) continue;
      const int d = dists[j];
      int nb = 1 << 30;                        // first stop past word wi
      if ((m0 >> 3) == 0) {                    // position o + 3 leaves the word
        const int last = (o + 3 + kRunHalo) >> 5;
        for (int k = wi + 1; k <= last; ++k) {
          const uint32_t v = stop[j][k];
          if (v != 0u) {
            nb = 32 * k + __ffs(v) - 1;
            break;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t mq = m0 >> q;
        int ln = mq != 0u ? __ffs(mq) - 1 : nb - (o + q);
        ln = min(ln, kMaxMatch);
        if (near_src && x0 + q < ms + d) ln = 0;
        if (ln >= kMinMatch) key[q] = max(key[q], ln << 3 | (7 - j));
      }
    }
    int bl[4], bd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 7 - (key[q] & 7);
      bl[q] = key[q] >> 3;
      bd[q] = key[q] == 0 ? 0 : j < 4 ? j + 1 : 8;
    }
    const long long at = static_cast<long long>(b) * W + x0;
    if (vec_out) {                             // W % 4 == 0: x0 + 3 < W
      *reinterpret_cast<int4*>(out_len + at) = make_int4(bl[0], bl[1], bl[2], bl[3]);
      *reinterpret_cast<int4*>(out_dist + at) = make_int4(bd[0], bd[1], bd[2], bd[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (x0 + q < W) {
          out_len[at + q] = bl[q];
          out_dist[at + q] = bd[q];
        }
      }
    }
  }
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
// _parse_walk_pallas).  Per row of n steps: from 0, mark i, add step[i]
// (a step below 1 counts as 1), until i >= n; the marks are the token
// starts.  The TPU marks through one-hot row updates because it has no
// scalar stores; here a mark is one byte store.
// Bound: latency — every step waits for the load before it, one chain a
// row; the bytes (4 in and 1 out a position) take 12.5 us for a batch.
//
// Rows of at most kWalkSharedMax steps (the parse blocks: 1,024, or 4,096
// at levels 7-9; parse_rows_kernel): one warp a row, kRowsPerBlock rows a
// block, so an SM holds 64 chains at level 6 and the whole grid is about
// one wave.  The lanes stage each position's next position i + step in
// shared memory as u16 — cut at n, which changes no mark since any i +
// step >= n ends the walk — and zero the row's mask there; lane 0 walks,
// a shared load and a mark a step, four steps a test.  With 64 walkers an
// SM the walk is bound by issue slots, so it takes fewer steps: a lane
// stages 8 positions, and a literal (a step of 1) leads to the end of its
// run within those 8, whose mask the lane fills in behind the walker as
// it stores it (8-byte stores).  Rows of n % 8 != 0 step one by one and
// leave in byte stores.
//
// Longer rows (a whole shard, parse_walk; parse_ring_kernel): one block a
// row streams the steps through the shared-memory ring of ring_walk.cuh
// (the walk B7 takes), and the copying warps turn them into next
// positions: a step that leaves the chunk leads to a trap (the pad word
// before it, which leads to itself), so the walker takes four steps a
// test and reads the step that left from device memory, once a chunk.  It
// stores its marks straight into the mask, which the block zeroes first.
// --------------------------------------------------------------------------
constexpr int kWalkSharedMax = 8192;          // longest row a warp stages
constexpr int kRowsPerBlock = 4;              // warps (rows) a block

// Shared bytes a row takes in parse_rows_kernel: np u16 next positions,
// np mask bytes and np / 8 literal bytes, rounded up to 16.
__host__ __device__ constexpr int rows_stride(int np) {
  return (3 * np + np / 8 + 15) & ~15;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock, 16)
parse_rows_kernel(const int* __restrict__ step, uint8_t* __restrict__ mask,
                  int R, int n, int np, int vec) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + warp;
  if (r >= R) return;
  // np > n, so position n is a sentinel that leads to itself
  uint8_t* mine = rows_smem + static_cast<size_t>(warp) * rows_stride(np);
  uint16_t* nx = reinterpret_cast<uint16_t*>(mine);
  uint8_t* m8 = mine + 2 * np;
  uint8_t* lit8 = m8 + np;            // bit j of byte g: 8g + j is a literal
  const long long base = static_cast<long long>(r) * n;
  const int* s = step + base;
  uint8_t* m = mask + base;
  auto next = [n](int p, int a) -> uint32_t {
    return a >= n - p ? n : p + max(a, 1);
  };
  if (vec) {                          // groups of 8 positions, one a lane
    const int4* s4 = reinterpret_cast<const int4*>(s);
    uint4* d = reinterpret_cast<uint4*>(nx);
    for (int g = lane; g < (n >> 3); g += 32) {
      const int4 x = __ldg(s4 + 2 * g);
      const int4 y = __ldg(s4 + 2 * g + 1);
      const int p = 8 * g;
      uint32_t q[8] = {next(p, x.x), next(p + 1, x.y), next(p + 2, x.z),
                       next(p + 3, x.w), next(p + 4, y.x), next(p + 5, y.y),
                       next(p + 6, y.z), next(p + 7, y.w)};
      // a literal (next = p + 1) jumps to the end of its run within the
      // group: the mask is filled in behind it at the end
      uint32_t lits = 0;
      uint32_t to = p + 8;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (q[j] == static_cast<uint32_t>(p + j + 1)) {
          lits |= 1u << j;
          q[j] = to;
        } else {
          to = p + j;
        }
      }
      d[g] = make_uint4(q[0] | q[1] << 16, q[2] | q[3] << 16,
                        q[4] | q[5] << 16, q[6] | q[7] << 16);
      lit8[g] = static_cast<uint8_t>(lits);
    }
  } else {
    for (int i = lane; i < n; i += 32) nx[i] = next(i, __ldg(s + i));
  }
  if (lane == 0) nx[n] = n;
  uint4* mz = reinterpret_cast<uint4*>(m8);
  for (int i = lane; i < (np >> 4); i += 32) mz[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  if (lane == 0) {                    // four steps a test: past the end they
    int i = 0;                        // mark the sentinel, which stays put
    while (i < n) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m8[i] = 1;
        i = nx[i];
      }
    }
  }
  __syncwarp();
  if (vec) {                          // fill the literal runs, 8 bytes a lane
    const unsigned long long* src =
        reinterpret_cast<const unsigned long long*>(m8);
    unsigned long long* dst = reinterpret_cast<unsigned long long*>(m);
    for (int g = lane; g < (n >> 3); g += 32) {
      const unsigned long long b = src[g];
      const uint32_t lits = lit8[g];
      uint32_t mk = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mk |= (static_cast<uint32_t>(b >> (8 * j)) & 1u) << j;
#pragma unroll
      for (int j = 0; j < 7; ++j) mk |= (mk & lits) << 1;
      unsigned long long o = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o |= static_cast<unsigned long long>((mk >> j) & 1u) << (8 * j);
      dst[g] = o;
    }
  } else {
    for (int i = lane; i < n; i += 32) m[i] = m8[i];
  }
}

__global__ void __launch_bounds__(ring::kThreads)
parse_ring_kernel(const int* __restrict__ step, uint8_t* __restrict__ mask,
                  int n, int vec_in, int vec_out) {
  extern __shared__ __align__(16) int ring_smem[];
  int* slots = ring_smem;                        // 2 x ring::kSlot
  ring::State* st = reinterpret_cast<ring::State*>(slots + 2 * ring::kSlot);
  const long long base = static_cast<long long>(blockIdx.x) * n;
  uint8_t* m = mask + base;
  if (vec_out) {
    uint4* m16 = reinterpret_cast<uint4*>(m);
    for (int i = threadIdx.x; i < (n >> 4); i += blockDim.x)
      m16[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) m[i] = 0;
  }
  if (threadIdx.x == 0) st[0] = {0, 0, 0, n <= 0 ? 1 : 0};
  __syncthreads();                    // the zeroes land before any mark
  const int* row = step + base;
  ring::run(
      row, n, vec_in != 0, slots, st,
      [&](int sl, int p, int i) {     // the step -> the next position
        int* nx = ring::chunk_of(slots, sl);
        const int lo = p - i;
        const int end = min(n, lo + ring::kChunk);
        const int a = nx[i];
        const int to = a >= n - p ? n : p + max(a, 1);
        nx[i] = to < end ? to : lo - 1;          // leaving: the trap
        if (i == 0) nx[-1] = lo - 1;
      },
      [&](int sl, int lo, int end, ring::State& t) {
        const int* nx = ring::chunk_of(slots, sl) - lo;   // by position
        const int trap = lo - 1;
        int cur = t.cur, last;
        for (;;) {                    // four steps a test, none leaves
          const int c1 = nx[cur];     // the chunk but to the trap
          const int c2 = nx[c1];
          const int c3 = nx[c2];
          const int c4 = nx[c3];
          m[cur] = 1;
          if (c1 != trap) m[c1] = 1;
          if (c2 != trap) m[c2] = 1;
          if (c3 != trap) m[c3] = 1;
          if (c4 == trap) {
            last = c3 != trap ? c3 : c2 != trap ? c2 : c1 != trap ? c1 : cur;
            break;
          }
          cur = c4;
        }
        // the step that leaves the chunk, from the row in device memory
        const int a = __ldg(row + last);
        cur = a >= n - last ? n : last + max(a, 1);
        t.cur = cur;
        t.done = cur >= n ? 1 : 0;
      },
      [](const ring::State&, int, int) {});
}

// --------------------------------------------------------------------------
// Squeeze cost DP — replaces the step loop of flate_tpu/jx/squeeze.py:73
// squeeze_parse, which is plain XLA there (no Pallas kernel); the port's
// plain version is device/squeeze.py _squeeze_dp_plain.  A lane is one
// parse block of blk positions; backward from its end,
//     cost[i] = min over the options o of cost_o(i) + cost[i + len_o(i)]
// with cost[blk] = 0, read from a ring of the next kDpWin costs exactly as
// the plain version's ring (slot (h + len - 1) % kDpWin, the head h one
// slot back a step, zeros where nothing was written).  The 16 options in
// rank order: the literal (its code length, 15 where it is 0), the full
// match length (its length code, extra bits and distance cost; none
// below 3), then the grid lengths ascending (a match longer than the grid
// length, or at least as long with GRID_ONLY, where the 15 grid lengths
// take the full length's place).  The first minimum in that order wins,
// and its length (literal 1) is written at the position.
// Bound: latency — a lane is a chain of blk steps (1,024 at levels 2 and
// 4-6, 4,096 at 7-9); the bytes (13 a position: byte, length and distance
// in, the chosen length out) take 33 us for a level-6 batch.  A half-warp
// takes a lane, one thread an option: a step is the option's ring read,
// an add and one __reduce_min_sync over the half-warp, which gives every
// thread the cost just chosen.  Only the literal reads that cost (from a
// register); the others read costs 3 or more positions on.  Every thread
// writes the chosen cost into the lane's ring, so a thread reads what it
// wrote itself and no step needs a barrier.  Keys are 32 bits,
// cost << 5 | rank: a winning cost is at most the literal path's,
// 15 * blk <= 15 * kDpMaxBlk, so every sum of an option's cost (<= 48) and
// a ring cost fits in 26 bits, and an option without a match costs
// kDpNone = 2^26, whose key is above every real one.  A tile of kDpOpts
// positions of each lane (one a thread) is loaded while the tile before
// runs and costed into shared memory; the chosen lengths go out from there.
// --------------------------------------------------------------------------
constexpr int kDpWin = 264;                     // squeeze.WIN
constexpr int kDpOpts = 16;                     // options: threads a lane
constexpr int kDpLanes = 8;                     // lanes a block
constexpr int kDpMaxBlk = 1 << 16;              // keeps 15 * blk < 2^26
constexpr uint32_t kDpNone = 1u << 26;          // cost of an option with no match
constexpr int kNumLitLen = 286;
constexpr int kNumDist = 30;

// The squeeze's grid lengths (squeeze.GRID) and a match length's DEFLATE
// length code and extra bits.
__host__ __device__ constexpr int dp_grid(int j) {
  return j < 4 ? 3 + j : j == 4 ? 8 : j == 5 ? 12 : j == 6 ? 16 : j == 7 ? 24
         : j == 8 ? 32 : j == 9 ? 48 : j == 10 ? 64 : j == 11 ? 96
         : j == 12 ? 128 : j == 13 ? 192 : 258;
}
__host__ __device__ constexpr int dp_log2(int n) {
  int e = 0;
  while (n > 1) {
    n >>= 1;
    ++e;
  }
  return e;
}
__host__ __device__ constexpr int dp_length_code(int length) {
  return length - 3 < 8 ? length - 3 : length == 258 ? 28
         : ((dp_log2(length - 3) - 2) << 2) +
               ((length - 3) >> (dp_log2(length - 3) - 2));
}
__host__ __device__ constexpr int dp_length_ebits(int length) {
  return length - 3 < 8 || length == 258 ? 0 : (dp_length_code(length) >> 2) - 1;
}
static_assert(dp_length_code(12) == 8 && dp_length_ebits(12) == 1 &&
              dp_length_code(192) == 25 && dp_length_ebits(192) == 5 &&
              dp_length_code(258) == 28 && dp_length_code(10) == 7,
              "DEFLATE length codes");

struct DpShared {
  int ring[kDpLanes][kDpWin];                   // the next kDpWin costs
  int lit[kDpLanes][kDpOpts];                   // a tile's literal costs
  int mlen[kDpLanes][kDpOpts];                  // match lengths
  int dist[kDpLanes][kDpOpts];                  // distance costs
  int full[kDpLanes][kDpOpts];                  // full-length costs
  int rank[kDpLanes][kDpOpts];                  // the winners' ranks
};

template <bool GRID_ONLY>
__global__ void __launch_bounds__(kDpLanes * kDpOpts)
squeeze_dp_kernel(const uint8_t* __restrict__ window,
                  const int* __restrict__ mlen, const int* __restrict__ mdist,
                  const int* __restrict__ ll_bits,
                  const int* __restrict__ d_bits, int* __restrict__ sel,
                  int L, int nb, long long ldw, long long ldm, long long ldd,
                  int blk) {
  __shared__ DpShared sh;
  const int ln = threadIdx.x / kDpOpts;         // the lane in the block
  const int r = threadIdx.x % kDpOpts;          // the option; a tile's position
  const unsigned half = 0xFFFFu << (threadIdx.x & 16);
  const int gl = blockIdx.x * kDpLanes + ln;
  const bool live = gl < L;
  const int lane = live ? gl : L - 1;           // a lane past L reruns the last
  const int b = lane / nb;
  const long long p0 = static_cast<long long>(lane % nb) * blk;
  const uint8_t* wrow = window + b * ldw + p0;
  const int* mrow = mlen + b * ldm + p0;
  const int* drow = mdist + b * ldd + p0;
  const int* lrow = ll_bits + static_cast<long long>(b) * kNumLitLen;
  const int* trow = d_bits + static_cast<long long>(b) * kNumDist;
  int* ring = sh.ring[ln];
  for (int s = r; s < kDpWin; s += kDpOpts) ring[s] = 0;
  // this thread's option: its grid length and that length's code bits
  const bool is_full = !GRID_ONLY && r == 1;
  const int j = r - (GRID_ONLY ? 1 : 2);        // grid index
  const int g = j >= 0 ? dp_grid(j) : kMinMatch;
  const int gc = j >= 0 ? __ldg(lrow + 257 + dp_length_code(g)) +
                              dp_length_ebits(g)
                        : 0;
  // the next tile's byte, length and distance at this thread's position
  int nw = 0, nm = 0, nd = 0;
  auto fetch = [&](int p) {
    if (p >= 0) {
      nw = wrow[p];
      nm = mrow[p];
      nd = drow[p];
    }
  };
  int h = 0;                                    // ring slot of cost[i + 1]
  uint32_t prev = 0;                            // cost[i + 1]
  fetch(blk - kDpOpts + r);
  for (int base = blk - kDpOpts; base > -kDpOpts; base -= kDpOpts) {
    if (base + r >= 0) {                        // cost this thread's position
      const int dm = max(nd, 1) - 1;
      int dc;
      if (dm < 4) {
        dc = __ldg(trow + dm);
      } else {
        const int e = 31 - __clz(dm);
        const int code = min((e << 1) + ((dm >> (e - 1)) & 1), kNumDist - 1);
        dc = __ldg(trow + code) + (code >> 1) - 1;
      }
      const int ml = min(nm, kMaxMatch);
      const int lb = __ldg(lrow + nw);
      sh.lit[ln][r] = lb == 0 ? 15 : lb;        // an unseen byte: 15 bits
      sh.mlen[ln][r] = nm;
      sh.dist[ln][r] = dc;
      sh.full[ln][r] = nm >= kMinMatch
          ? __ldg(lrow + 257 + dp_length_code(ml)) + dp_length_ebits(ml) + dc
          : static_cast<int>(kDpNone);
    }
    fetch(base - kDpOpts + r);                  // lands while the chain runs
    __syncwarp();
#pragma unroll
    for (int k = kDpOpts - 1; k >= 0; --k) {
      if (base + k >= 0) {                      // a ragged tile's first steps
        const int m = sh.mlen[ln][k];
        const bool ok = GRID_ONLY ? m >= g : m > g;
        const int c = r == 0 ? sh.lit[ln][k]
                      : is_full ? sh.full[ln][k]
                      : ok ? gc + sh.dist[ln][k] : static_cast<int>(kDpNone);
        int slot = h + (is_full ? min(max(m, kMinMatch), kMaxMatch) : g) - 1;
        slot -= slot >= kDpWin ? kDpWin : 0;
        const uint32_t next = r == 0 ? prev : static_cast<uint32_t>(ring[slot]);
        const uint32_t best = __reduce_min_sync(
            half, ((static_cast<uint32_t>(c) + next) << 5) |
                      static_cast<uint32_t>(r));
        prev = best >> 5;
        h = h == 0 ? kDpWin - 1 : h - 1;
        ring[h] = static_cast<int>(prev);
        if (r == 0) sh.rank[ln][k] = static_cast<int>(best & 31u);
      }
    }
    __syncwarp();
    if (live && base + r >= 0) {                // the winner's length out
      const int rk = sh.rank[ln][r];
      sel[static_cast<long long>(gl) * blk + base + r] =
          rk == 0 ? 1 : !GRID_ONLY && rk == 1 ? sh.mlen[ln][r]
                                              : dp_grid(rk - (GRID_ONLY ? 1 : 2));
    }
  }
}

// --------------------------------------------------------------------------
// B5 bit pack — replaces flate_tpu/jx/pack.py:_pack_kernel (via
// pack_fields).  Fields (value, width) of a row go LSB-first, each at the
// exclusive prefix sum of the widths before it in its row; the words are
// zero past the stream and bits at or past word nwords are dropped; the
// row's total width is written too.  The TPU does the prefix sums in XLA
// and places groups of 512 fields with two bf16 one-hot matmuls, because
// it has no scatter.
// Bound: bytes — u32 values and widths in, the words out.  So the offsets
// are not a pass of their own and a field is not an atomic in device
// memory: a block takes a tile of kPackTile consecutive fields of one
// row, 16 a thread, read with 16-byte loads, and finds the tile's offset
// in its row by a single-pass scan with decoupled look-back (Merrill &
// Garland): tiles are handed out in order by an atomic ticket, so every
// tile a block waits on is already running; a tile publishes its width
// sum, then its inclusive prefix, each with its flag in one 64-bit status
// word, and warp 0 of the next tile sums the 32 statuses before it at a
// time back to the first inclusive one.  The status words and the ticket are zeroed by the
// wrapper for every call (it zeroes the words as well), so a CUDA graph
// replays the kernel as it is.  Each thread assembles its run of fields in
// registers into whole words (a field spans at most 2) and puts them into a
// shared-memory buffer of the tile's words (the first and the last word of
// a thread's run by a shared atomicOr: its neighbours' runs share them).
// The block then stores the buffer with 16-byte stores; only the tile's
// first and last word, which the tiles beside it may share, are ORed into
// device memory with atomics.
// --------------------------------------------------------------------------
constexpr int kPackTile = 4096;                 // fields a block
constexpr int kPackThreads = 256;
constexpr int kPackPer = kPackTile / kPackThreads;   // consecutive fields a thread
// the tile's words: at most (31 + 32 * kPackTile) / 32 + 1, from a lead
// of up to 3 that aligns them with the row's 16-byte words
constexpr int kPackWords = kPackTile + 8;
constexpr unsigned long long kTileAggregate = 1ull << 32;   // status flags
constexpr unsigned long long kTileInclusive = 2ull << 32;

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint32_t* __restrict__ vals, const int* __restrict__ bits,
            uint32_t* __restrict__ words, int* __restrict__ total_bits,
            unsigned long long* __restrict__ status,
            unsigned int* __restrict__ ticket, int slots, int nwords,
            int tiles, int vec_in, int vec_out) {
  __shared__ __align__(16) uint32_t buf[kPackWords];
  __shared__ uint32_t warp_sum[kPackThreads / 32];
  __shared__ unsigned int s_tile;
  __shared__ uint32_t s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  for (int i = threadIdx.x; i < kPackWords / 4; i += kPackThreads)
    reinterpret_cast<uint4*>(buf)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int b = static_cast<int>(s_tile / tiles);
  const int t = static_cast<int>(s_tile - static_cast<unsigned>(b) * tiles);

  // this thread's fields; past the row they are empty
  const int first = t * kPackTile + kPackPer * threadIdx.x;
  const long long f0 = static_cast<long long>(b) * slots + first;
  uint32_t v[kPackPer];
  uint32_t n[kPackPer];
  if (vec_in && first + kPackPer <= slots) {   // slots % 4 == 0: aligned
#pragma unroll
    for (int i = 0; i < kPackPer / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(vals + f0) + i);
      const int4 y = __ldg(reinterpret_cast<const int4*>(bits + f0) + i);
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
      n[4 * i] = y.x; n[4 * i + 1] = y.y; n[4 * i + 2] = y.z; n[4 * i + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPackPer; ++i) {
      const bool in = first + i < slots;
      v[i] = in ? __ldg(vals + f0 + i) : 0u;
      n[i] = in ? static_cast<uint32_t>(__ldg(bits + f0 + i)) : 0u;
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kPackPer; ++i) sum += n[i];

  // the thread's offset in the tile and the tile's width: warp shuffles
  uint32_t x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  uint32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kPackThreads / 32; ++w) {
    const uint32_t s = warp_sum[w];
    before += w < warp ? s : 0u;
    agg += s;
  }
  const uint32_t mine = before + x - sum;

  // the tile's offset in its row: decoupled look-back
  if (warp == 0) {
    unsigned long long* st = status + static_cast<long long>(b) * tiles;
    uint32_t excl = 0;
    if (t == 0) {
      if (lane == 0) store_status(st, kTileInclusive | agg);
    } else {
      if (lane == 0) store_status(st + t, kTileAggregate | agg);
      for (int j = t - 1 - lane;; j -= 32) {   // lane l reads tile j
        unsigned long long s = kTileInclusive;  // before the row: 0
        if (j >= 0) {
          do {
            s = load_status(st + j);
          } while ((s >> 32) == 0);
        }
        const unsigned inc = __ballot_sync(~0u, (s >> 32) == 2);
        const int stop = inc ? __ffs(inc) - 1 : 31;   // the nearest inclusive
        uint32_t add = lane <= stop ? static_cast<uint32_t>(s) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(~0u, add, o);
        excl += add;
        if (inc) break;
      }
      if (lane == 0) store_status(st + t, kTileInclusive | (excl + agg));
    }
    if (lane == 0) {
      s_excl = excl;
      if (t == tiles - 1) total_bits[b] = static_cast<int>(excl + agg);
    }
  }
  __syncthreads();
  const uint32_t E = s_excl;
  const long long row0 = static_cast<long long>(b) * nwords;
  const int wf = static_cast<int>(E >> 5);     // the tile's first word
  const int lead = vec_out ? static_cast<int>((row0 + wf) & 3) : 0;

  // the thread's run into whole words: the first and the last (partial)
  // word may be shared with the threads beside it, the others are its own
  uint32_t* tb = buf + lead;
  const uint32_t at = (E & 31u) + mine;        // bit in the tile's words
  int wi = static_cast<int>(at >> 5);
  uint32_t sh = at & 31u;
  uint32_t cur = 0;
  bool shared_word = true;
#pragma unroll
  for (int i = 0; i < kPackPer; ++i) {
    cur |= v[i] << sh;
    if (sh + n[i] >= 32u) {                    // the word is full
      if (shared_word) {
        if (cur) atomicOr(tb + wi, cur);
        shared_word = false;
      } else {
        tb[wi] = cur;
      }
      ++wi;
      cur = sh ? v[i] >> (32u - sh) : 0u;
      sh = sh + n[i] - 32u;
    } else {
      sh += n[i];
    }
  }
  if (sh != 0u && cur) atomicOr(tb + wi, cur);
  __syncthreads();

  // out: the tile's words, dropped at or past nwords
  if (agg == 0u) return;
  const int nloc = static_cast<int>(((E & 31u) + agg + 31u) >> 5);
  const bool at0 = (E & 31u) != 0u;            // shares word 0 with tiles before
  const bool atn = ((E + agg) & 31u) != 0u;    // shares its last with tiles after
  uint32_t* wrow = words + row0 + wf;
  const int room = nwords - wf;
  if (threadIdx.x == 0 && at0 && room > 0 && tb[0]) atomicOr(wrow, tb[0]);
  if (threadIdx.x == 32 && atn && !(at0 && nloc == 1) && nloc - 1 < room &&
      tb[nloc - 1])
    atomicOr(wrow + nloc - 1, tb[nloc - 1]);
  const int i0 = at0 ? 1 : 0;
  const int i1 = min(atn ? nloc - 1 : nloc, room);
  if (i1 <= i0) return;
  int ia = i0, ib = i0;                        // the 16-byte body [ia, ib)
  if (vec_out) {
    ia = min(i1, ((i0 + lead + 3) & ~3) - lead);
    ib = max(ia, ((i1 + lead) & ~3) - lead);
  }
  for (int i = i0 + threadIdx.x; i < ia; i += kPackThreads) wrow[i] = tb[i];
  for (int i = ia + 4 * threadIdx.x; i < ib; i += 4 * kPackThreads)
    *reinterpret_cast<uint4*>(wrow + i) = *reinterpret_cast<const uint4*>(tb + i);
  for (int i = ib + threadIdx.x; i < i1; i += kPackThreads) wrow[i] = tb[i];
}

}  // namespace

extern "C" {

// key: (B, Wp) int32, words: (B, nf, Wp); Wp a multiple of kPrepTile.
int flate_prep(const void* window, void* key, void* words, int B, int W,
               int Wp, int ne, int nf, int hash_bytes, void* stream) {
  if (B <= 0 || Wp <= 0) return static_cast<int>(cudaGetLastError());
  if (Wp % kPrepTile != 0 || W > Wp || ne < 1 || nf < 0 || hash_bytes < 1 ||
      hash_bytes > 4 || reinterpret_cast<uintptr_t>(key) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int span4 = nf > 0 ? ne << nf : 1;     // words a position reads past it
  const int stage = prep_stage(span4);
  if (static_cast<size_t>(stage) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (stage > 48 * 1024) {
    int rc = static_cast<int>(cudaFuncSetAttribute(
        prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, stage));
    if (rc != 0) return rc;
  }
  const int vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(window) % 16 == 0;
  const dim3 grid(Wp / kPrepTile, min(B, kMaxGridY), (B + kMaxGridY - 1) / kMaxGridY);
  prep_kernel<<<grid, kPrepThreads, stage, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(window), static_cast<int*>(key),
      static_cast<uint32_t*>(words), B, W, Wp, ne, nf, hash_bytes, stage, vec_in);
  return static_cast<int>(cudaGetLastError());
}

// window: (B, Ww) bytes as u32 words, Ww a multiple of 4 >= W with zeros
// past W; fps: B1's (B, nf, Wp) fingerprint words.
int flate_matcher(const void* skey, const void* window, const void* fps,
                  const void* min_src, const void* limit, void* out,
                  void* out2, int B, int W, int Ww, int Wp, int ne, int nf,
                  int K, int max_dist, int hash_bytes, void* stream) {
  if (B == 0 || Wp == 0) return static_cast<int>(cudaGetLastError());
  if (K < 0 || ne < 1 || Ww % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the words a row is staged with: see matcher_kernel
  int NE = 1;
  while (NE < ne && NE < 16) NE *= 2;
  if (NE < ne) NE = 65;
  // keys of T + K rows, words of T + K rows (T rows with halo)
  auto smem_for = [&](int T, bool halo) {
    return (static_cast<size_t>(T + K) +
            static_cast<size_t>(halo ? T : T + K) * match_stride(NE)) *
           sizeof(uint32_t);
  };
  auto tile = [&](bool halo) {
    int T = kMatchRowsMax;
    while (T > kMatchThreads && smem_for(T, halo) > kMatchSmemTarget) T /= 2;
    return T;
  };
  int T = tile(false);
  const bool halo = smem_for(T, false) > kSmemMax;
  if (halo) T = tile(true);
  const size_t smem = smem_for(T, halo);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((Wp + T - 1) / T), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    int rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (rc != 0) return rc;
    kernel<<<grid, kMatchThreads, smem, s>>>(
        static_cast<const int*>(skey), static_cast<const uint32_t*>(window),
        static_cast<const uint32_t*>(fps), static_cast<const int*>(min_src),
        static_cast<const int*>(limit), static_cast<int*>(out),
        static_cast<int*>(out2), W, Ww, Wp, ne, nf, K, max_dist, hash_bytes, T);
    return static_cast<int>(cudaGetLastError());
  };
  if (halo) {                          // only NE = 65 needs it at K <= 1024
    switch (NE) {
      case 1: return run(matcher_kernel<1, true>);
      case 2: return run(matcher_kernel<2, true>);
      case 4: return run(matcher_kernel<4, true>);
      case 8: return run(matcher_kernel<8, true>);
      case 16: return run(matcher_kernel<16, true>);
      default: return run(matcher_kernel<65, true>);
    }
  }
  switch (NE) {
    case 1: return run(matcher_kernel<1, false>);
    case 2: return run(matcher_kernel<2, false>);
    case 4: return run(matcher_kernel<4, false>);
    case 8: return run(matcher_kernel<8, false>);
    case 16: return run(matcher_kernel<16, false>);
    default: return run(matcher_kernel<65, false>);
  }
}

int flate_small_runs(const void* window, const void* limit,
                     const void* min_src, void* out_len, void* out_dist,
                     int B, int W, void* stream) {
  if (B > 0 && W > 0) {
    const int vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(window) % 16 == 0;
    const int vec_out = W % 4 == 0 && reinterpret_cast<uintptr_t>(out_len) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out_dist) % 16 == 0;
    const dim3 grid((W + kRunTile - 1) / kRunTile, min(B, kMaxGridY),
                    (B + kMaxGridY - 1) / kMaxGridY);
    small_runs_kernel<<<grid, kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(window), static_cast<const int*>(limit),
        static_cast<const int*>(min_src), static_cast<int*>(out_len),
        static_cast<int*>(out_dist), B, W, vec_in, vec_out);
  }
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
  if (R <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec_in = n % 4 == 0 && reinterpret_cast<uintptr_t>(step) % 16 == 0;
  const int vec_out = n % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  if (n <= kWalkSharedMax) {
    const int np = (n + 16) & ~15;       // > n: room for the sentinel
    const size_t smem = static_cast<size_t>(kRowsPerBlock) * rows_stride(np);
    // groups of 8: 16-byte step loads, 8-byte mask stores
    const int vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(step) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(mask) % 8 == 0;
    int rc = static_cast<int>(cudaFuncSetAttribute(
        parse_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (rc == 0)                       // 16 blocks an SM need 204 KB of it
      rc = static_cast<int>(cudaFuncSetAttribute(
          parse_rows_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared)));
    if (rc != 0) return rc;
    parse_rows_kernel<<<static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock),
                        32 * kRowsPerBlock, smem, s>>>(
        static_cast<const int*>(step), static_cast<uint8_t*>(mask), R, n, np,
        vec);
  } else {
    int rc = static_cast<int>(cudaFuncSetAttribute(
        parse_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ring::kSharedBytes)));
    if (rc != 0) return rc;
    parse_ring_kernel<<<static_cast<unsigned>(R), ring::kThreads,
                        ring::kSharedBytes, s>>>(
        static_cast<const int*>(step), static_cast<uint8_t*>(mask), n,
        vec_in, vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// window (B, S) u8, mlen and mdist (B, S) int32, each row contiguous and
// ld* elements after the one before; ll_bits (B, 286) and d_bits (B, 30)
// int32; sel (B * S / blk, blk) int32.
int flate_squeeze_dp(const void* window, const void* mlen, const void* mdist,
                     const void* ll_bits, const void* d_bits, void* sel, int B,
                     int S, long long ldw, long long ldm, long long ldd,
                     int blk, int grid_only, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (blk <= 0 || blk > kDpMaxBlk || S % blk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = S / blk;                        // lanes a row
  const int L = B * nb;
  auto run = [&](auto kernel) {
    kernel<<<static_cast<unsigned>((L + kDpLanes - 1) / kDpLanes),
             kDpLanes * kDpOpts, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(window), static_cast<const int*>(mlen),
        static_cast<const int*>(mdist), static_cast<const int*>(ll_bits),
        static_cast<const int*>(d_bits), static_cast<int*>(sel), L, nb, ldw,
        ldm, ldd, blk);
    return static_cast<int>(cudaGetLastError());
  };
  return grid_only ? run(squeeze_dp_kernel<true>) : run(squeeze_dp_kernel<false>);
}

// vals: (B, slots) u32, bits: (B, slots) int32 widths (<= 32); words: (B,
// nwords) and total_bits: (B,), zeroed; scratch: zeroed, 8 * B * tiles +
// 4 bytes (the tiles' status words, then the ticket), tiles = ceil(slots /
// kPackTile), 8-byte aligned.
int flate_pack(const void* vals, const void* bits, void* words,
               void* total_bits, void* scratch, int B, int slots, int nwords,
               void* stream) {
  if (B <= 0 || slots <= 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(scratch) % 8 != 0 || nwords < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (slots + kPackTile - 1) / kPackTile;
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned int*>(status + static_cast<long long>(B) * tiles);
  const int vec_in = slots % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  const int vec_out = reinterpret_cast<uintptr_t>(words) % 16 == 0;
  pack_kernel<<<static_cast<unsigned>(B) * tiles, kPackThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), static_cast<const int*>(bits),
      static_cast<uint32_t*>(words), static_cast<int*>(total_bits), status,
      ticket, slots, nwords, tiles, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels of the encoder's field build: three
// launches a batch in place of the plain version's chain of small PyTorch
// ops (flate_tpu_torch/device/encode2.py _build_fields_plain, which is
// plain XLA in the JAX package: flate_tpu/jx/encode2.py build_fields).
//
//   F1 fields_hist_kernel  grid (nseg, B): a block a segment.  Each
//      position's litlen and distance symbols and extra bits; the
//      segment's litlen, distance and byte histograms in shared memory,
//      its extra bits and whether a token crosses its end.
//   F2 fields_plan_kernel  grid B: a block a shard.  Everything per shard
//      or per segment: the entropy estimate and the stored decision, the
//      crossing chain, the pass-2 histograms, the three package-merges,
//      the two dynamic headers (RLE and the codegen package-merges), the
//      four costs and the kind, the covers, the selected code tables, the
//      bit account and the trailer.
//   F3 fields_emit_kernel  grid (nseg, B): a block a segment writes its
//      boundary slots, its header slots and its body (two slots a
//      position); the last segment's block the trailer and the padding.
//
// F1 and F3 are bound by memory traffic (about 11 bytes a position read
// by each, 8 bytes a slot written by F3); F2 by its chain of barriers,
// a block of threads over at most 602 symbols.  Every integer is the
// plain version's exactly: histograms and sums are integers, the float
// estimate is a sum of products exact in 64-bit fixed point (a float32
// length in [1, 15] is a multiple of 2^-23) rounded to float32 once, as
// the plain version's float64 sum is.  Optimal length-limited codes are
// not unique, so the package-merge takes the plain version's steps: the
// symbols ranked by (weight << 9 | symbol), and each level's merge of the
// sorted originals with the sorted packages placed by co-rank (a binary
// search into the other list), originals first on equal weights, which is
// the order of the plain version's sort over (weight << 1 | is_package).
//
// Interface: plain C (ctypes), every entry point launches on the caller's
// stream and returns cudaGetLastError().  Buffers are allocated by the
// Python wrapper (device/encode2.py _build_fields_kernels), which checks
// dtype, shape, device and row contiguity before calling.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNumLitLen = 286;
constexpr int kNumDist = 30;
constexpr int kNumCodegen = 19;
constexpr int kEob = 256;
constexpr int kSeq = kNumLitLen + kNumDist;        // header.SEQ
constexpr int kHdrSlots = 23 + 2 * kSeq;           // header.HDR_SLOTS
constexpr int kBnd = 4 + kHdrSlots;                // slots before a body
constexpr int kMaxBits = 15;
constexpr int kMaxCgBits = 7;
constexpr int kInf = 1 << 21;                      // huff.INF
constexpr int kSymBits = 9;                        // huff.SYM_BITS
constexpr int kHyst = 192;                         // encode2._HYST
constexpr int kMaxStored = 65535;

enum Kind { kDyn = 0, kFix = 1, kLit = 2, kSto = 3 };

// F1's histogram row of a segment: litlen, distance, byte, extras, crosses
constexpr int kHLL = 0;
constexpr int kHD = kNumLitLen;
constexpr int kHByte = kSeq;
constexpr int kHExtra = kHByte + kNumLitLen;       // 602
constexpr int kHCross = kHExtra + 1;
constexpr int kHistStride = kHCross + 1;           // 604

// F2's plan row of a shard (int32), read by F3
constexpr int kPLLTab = 0;                         // litlen, distance tables
constexpr int kPHdr = kSeq;                        // dyn hv, hb; lit hv, hb
constexpr int kPMisc = kPHdr + 4 * kHdrSlots;      // kind, trailer
constexpr int kPSeg = kPMisc + 8;                  // 4 a segment
constexpr int kSegInfo = 4;
// a segment's flags
constexpr int kFStored0 = 1, kFCross = 2, kFStored = 4, kFCoded = 8,
              kFOpen = 16, kFClose = 32, kFHdr = 64;

constexpr int kHistThreads = 256;
constexpr int kPlanThreads = 512;
constexpr int kEmitThreads = 256;

__device__ __forceinline__ int floor_log2(long long x) {   // x >= 1
  return 63 - __clzll(x);
}

// RFC 1951 3.2.5 as device/encode.py computes them (length 3..258,
// distance 1..32768, each clamped from below first)
__device__ __forceinline__ int length_code(int len) {
  const int n = len - 3;
  if (n == 255) return 28;
  if (n < 8) return n;
  const int e = max(floor_log2(max(n, 1)) - 2, 1);
  return (e << 2) + (n >> e);
}
__device__ __forceinline__ int length_ebits(int code) {
  return code < 8 || code == 28 ? 0 : max((code >> 2) - 1, 0);
}
__device__ __forceinline__ int length_extra(int len, int code, int eb) {
  int base = code < 8 ? code + 3 : ((4 + (code & 3)) << eb) + 3;
  if (code == 28) base = 258;
  return max(len - base, 0);
}
__device__ __forceinline__ int dist_code(int dist) {
  const int m = dist - 1;
  if (m < 4) return m;
  const int e = floor_log2(max(m, 1));
  return (e << 1) + ((m >> max(e - 1, 0)) & 1);
}
__device__ __forceinline__ int dist_ebits(int code) {
  return max((code >> 1) - 1, 0);
}
__device__ __forceinline__ int dist_extra(int dist, int code, int eb) {
  const int base = code < 4 ? code + 1 : ((2 + (code & 1)) << eb) + 1;
  return max(dist - base, 0);
}

__device__ __forceinline__ long long ceil_div(long long a, long long b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);          // b > 0
}

__device__ __forceinline__ long long load_int(const void* p, int is64, int i) {
  return is64 ? static_cast<const long long*>(p)[i]
              : static_cast<long long>(static_cast<const int*>(p)[i]);
}

// One position's token: is it a match, and its symbols and extras.
struct Token {
  int live, tok, match, llsym, lcode, leb, lev, dcode, deb, dev;
};

__device__ __forceinline__ Token token_at(
    const uint8_t* __restrict__ window, const int* __restrict__ mlen,
    const int* __restrict__ mdist, const uint8_t* __restrict__ starts,
    const uint8_t* __restrict__ take, long long vl, int p) {
  Token t;
  const int wt = window[p];
  t.live = p < vl;
  t.tok = t.live && starts[p] != 0;
  t.match = t.tok && take[p] != 0;
  t.lcode = t.leb = t.lev = t.dcode = t.deb = t.dev = 0;
  if (t.match) {
    const int len = max(mlen[p], 3);
    t.lcode = length_code(len);
    t.leb = length_ebits(t.lcode);
    t.lev = length_extra(len, t.lcode, t.leb);
    const int dist = max(mdist[p], 1);
    t.dcode = dist_code(dist);
    t.deb = dist_ebits(t.dcode);
    t.dev = dist_extra(dist, t.dcode, t.deb);
  }
  t.llsym = t.match ? 257 + t.lcode : t.tok ? wt : 0;
  return t;
}

// --------------------------------------------------------------------------
// F1: a segment's histograms.  hist row (kHistStride int32): litlen counts
// of the token starts, distance counts of the matches, byte counts of the
// live positions, the matches' extra bits, and 1 where a match runs past
// the segment's end.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kHistThreads)
fields_hist_kernel(const uint8_t* __restrict__ window,
                   const int* __restrict__ mlen, const int* __restrict__ mdist,
                   const uint8_t* __restrict__ starts,
                   const uint8_t* __restrict__ take, const void* valid_len,
                   int vl64, int* __restrict__ hist, int S, int seg, int nseg,
                   long long ldw, long long ldm, long long ldd, long long lds,
                   long long ldt) {
  __shared__ int h[kHExtra];
  __shared__ int extra, cross;
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  for (int s = threadIdx.x; s < kHExtra; s += blockDim.x) h[s] = 0;
  if (threadIdx.x == 0) extra = cross = 0;
  __syncthreads();
  const long long vl = load_int(valid_len, vl64, b);
  const uint8_t* w = window + b * ldw;
  const int* ml = mlen + b * ldm;
  const int* md = mdist + b * ldd;
  const uint8_t* st = starts + b * lds;
  const uint8_t* tk = take + b * ldt;
  const int p0 = j * seg;
  const int p1 = min(p0 + seg, S);
  const long long next_bnd = static_cast<long long>(p0) + seg;
  int my_extra = 0, my_cross = 0;
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const Token t = token_at(w, ml, md, st, tk, vl, p);
    if (t.live) atomicAdd(&h[kHByte + w[p]], 1);
    if (t.tok) atomicAdd(&h[kHLL + t.llsym], 1);
    if (t.match) {
      atomicAdd(&h[kHD + t.dcode], 1);
      my_extra += t.leb + t.deb;
      if (static_cast<long long>(p) + ml[p] > next_bnd) my_cross = 1;
    }
  }
  if (my_extra) atomicAdd(&extra, my_extra);
  if (my_cross) atomicOr(&cross, 1);
  __syncthreads();
  int* out = hist + (static_cast<long long>(b) * nseg + j) * kHistStride;
  for (int s = threadIdx.x; s < kHExtra; s += blockDim.x) out[s] = h[s];
  if (threadIdx.x == 0) {
    out[kHExtra] = extra;
    out[kHCross] = cross;
  }
}

// --------------------------------------------------------------------------
// F2's building blocks, each run by the whole block over a few lists of
// symbols side by side (concatenated at offsets).
// --------------------------------------------------------------------------
struct Lists {
  int nl;                 // lists (<= 3)
  int n[3];               // symbols of each
  int off[3];             // offset of each in the concatenation
  int N;                  // all symbols
  __device__ int of(int e) const {
    int k = 0;
    while (k + 1 < nl && e >= off[k + 1]) ++k;
    return k;
  }
};

// Package-merge scratch in shared memory, sized for N symbols and
// max_bits levels.
struct PmScratch {
  int* ws;                // N sorted weights (kInf where unused)
  uint16_t* ssym;         // N: the symbol of each rank
  int* lw0;               // 2N: a level's merged list
  int* lw1;               // 2N
  int* pk;                // N: a level's packages
  uint16_t* posa;         // (max_bits + 1) x N: originals' merged places
  int* olv;               // 3 x 16: originals taken at each level
  int* nact;              // 3
};

__device__ __forceinline__ int lower_count_lt(const int* a, int n, int x) {
  int lo = 0, hi = n;                     // #{i : a[i] < x}, a ascending
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int lower_count_le(const int* a, int n, int x) {
  int lo = 0, hi = n;                     // #{i : a[i] <= x}, a ascending
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// huff.pm_lengths over each list: freq (N) -> lens (N), both shared.
// Ends with a barrier.
__device__ void pm_lengths(const int* freq, int* lens, const Lists& L,
                           int max_bits, const PmScratch& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid < L.nl) s.nact[tid] = 0;
  __syncthreads();
  // rank by (w << 9 | symbol): the symbols' order in the plain sort
  for (int e = tid; e < L.N; e += nt) {
    const int k = L.of(e), o = L.off[k], n = L.n[k], i = e - o;
    const int f = freq[e];
    const long long w = f > 0 ? f : kInf;
    const long long key = (w << kSymBits) | i;
    int rank = 0;
    for (int q = 0; q < n; ++q) {
      const int fq = freq[o + q];
      const long long wq = fq > 0 ? fq : kInf;
      rank += ((wq << kSymBits) | q) < key;
    }
    s.ws[o + rank] = static_cast<int>(w);
    s.ssym[o + rank] = static_cast<uint16_t>(i);
    if (f > 0) atomicAdd(&s.nact[k], 1);
  }
  __syncthreads();
  for (int e = tid; e < L.N; e += nt) {
    const int k = L.of(e), o = L.off[k], n = L.n[k], i = e - o;
    s.lw0[2 * o + i] = s.ws[e];
    s.lw0[2 * o + n + i] = kInf;
  }
  __syncthreads();
  int* cur = s.lw0;
  int* nxt = s.lw1;
  for (int level = 2; level <= max_bits; ++level) {
    for (int e = tid; e < L.N; e += nt) {
      const int k = L.of(e), o = L.off[k], i = e - o;
      s.pk[e] = min(cur[2 * o + 2 * i] + cur[2 * o + 2 * i + 1], kInf);
    }
    __syncthreads();
    for (int e = tid; e < L.N; e += nt) {
      const int k = L.of(e), o = L.off[k], n = L.n[k], i = e - o;
      const int w = s.ws[e];              // an original: after the
      const int pa = i + lower_count_lt(s.pk + o, n, w);   // lighter packages
      nxt[2 * o + pa] = w;
      s.posa[level * L.N + e] = static_cast<uint16_t>(pa);
      const int p = s.pk[e];              // a package: after the originals
      nxt[2 * o + i + lower_count_le(s.ws + o, n, p)] = p;   // of <= weight
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  // backward: the originals taken at each level
  if (tid < L.nl) {
    const int k = tid, o = L.off[k], n = L.n[k];
    const int nact = s.nact[k];
    long long m = max(2 * (nact - 1), 0);
    for (int level = max_bits; level >= 2; --level) {
      int taken = 0;
      if (m > 0) {                        // originals among the first m
        const uint16_t* pa = s.posa + level * L.N + o;
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (pa[mid] <= m - 1) lo = mid + 1; else hi = mid;
        }
        taken = lo;
      }
      s.olv[16 * k + level] = taken;
      m = 2 * (m - taken);
    }
    s.olv[16 * k + 1] = static_cast<int>(min(m, static_cast<long long>(nact)));
  }
  __syncthreads();
  for (int e = tid; e < L.N; e += nt) {
    const int k = L.of(e), o = L.off[k], r = e - o;
    int len = 0;
    for (int level = 1; level <= max_bits; ++level)
      len += r < s.olv[16 * k + level];
    const int sym = s.ssym[e];
    const int active = freq[o + sym] > 0;
    if (s.nact[k] == 1) len = 1;          // a single symbol gets length 1
    lens[o + sym] = active ? len : 0;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t rev16(uint32_t x) {
  x = ((x & 0x5555u) << 1) | ((x & 0xAAAAu) >> 1);
  x = ((x & 0x3333u) << 2) | ((x & 0xCCCCu) >> 2);
  x = ((x & 0x0F0Fu) << 4) | ((x & 0xF0F0u) >> 4);
  return ((x & 0x00FFu) << 8) | ((x & 0xFF00u) >> 8);
}

// huff.packed_tables over each list: lens (N, shared) -> packed (N):
// the bit-reversed canonical code | (length << 24).  cnt and next: 3 x 16
// shared ints.  Ends with a barrier.
__device__ void packed_tables(const int* lens, int* packed, const Lists& L,
                              int max_bits, int* cnt, long long* next) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int q = tid; q < 48; q += nt) cnt[q] = 0;
  __syncthreads();
  for (int e = tid; e < L.N; e += nt) {
    const int l = lens[e];
    if (l >= 1 && l <= max_bits) atomicAdd(&cnt[16 * L.of(e) + l], 1);
  }
  __syncthreads();
  if (tid < L.nl) {
    long long code = 0, prev = 0;
    for (int l = 1; l <= max_bits; ++l) {
      code = (code + prev) << 1;
      next[16 * tid + l] = code;
      prev = cnt[16 * tid + l];
    }
  }
  __syncthreads();
  for (int e = tid; e < L.N; e += nt) {
    const int k = L.of(e), o = L.off[k], i = e - o;
    const int l = lens[e];
    long long code = 0;
    if (l >= 1 && l <= max_bits) {
      int rank = 0;
      for (int q = 0; q < i; ++q) rank += lens[o + q] == l;
      code = next[16 * k + l] + rank;
    }
    const uint32_t rev = rev16(static_cast<uint32_t>(code & 0xFFFF));
    const int v = l > 0 ? static_cast<int>(rev >> (16 - max(l, 1))) : 0;
    packed[e] = v | (l << 24);
  }
  __syncthreads();
}

// DEFLATE's order of the codegen lengths (consts.CODEGEN_ORDER)
__constant__ int kCodegenOrder[kNumCodegen] = {16, 17, 18, 0, 8,  7, 9,
                                               6,  10, 5,  11, 4, 12, 3,
                                               13, 2,  14, 1,  15};

struct HdrScratch {
  int* key;               // 2 x kSeq
  int* item;              // 2 x kSeq: sym | ev << 8 | eb << 16 | emit << 24
  int* cg_freq;           // 2 x 19
  int* cg_lens;           // 2 x 19
  int* cg_packed;         // 2 x 19
  int* hlit;              // 2
  int* hdist;             // 2
  int* hclen;             // 2
  int* hbits;             // 2
};

// header.build_headers (BFINAL 0) of two (litlen, distance) length sets:
// v (2 x kSeq, shared: litlen then distance lengths) -> out (2 x (hv
// kHdrSlots, hb kHdrSlots), device memory) and hs.hbits.  Ends with a
// barrier.
__device__ void build_headers(const int* v, int* out, const HdrScratch& hs,
                              const PmScratch& pm, int* cnt, long long* next) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid < 2) {
    hs.hlit[tid] = 257;
    hs.hdist[tid] = 1;
    hs.hclen[tid] = 4;
    hs.hbits[tid] = 0;
  }
  for (int q = tid; q < 2 * kNumCodegen; q += nt) hs.cg_freq[q] = 0;
  __syncthreads();
  for (int e = tid; e < 2 * kSeq; e += nt) {
    const int h = e / kSeq, i = e % kSeq;
    if (v[e] > 0) {
      if (i < kNumLitLen) atomicMax(&hs.hlit[h], i + 1);
      else atomicMax(&hs.hdist[h], i - kNumLitLen + 1);
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * kSeq; e += nt) {
    const int h = e / kSeq, i = e % kSeq;
    const int sec = i >= kNumLitLen;
    const int live = sec ? i - kNumLitLen < hs.hdist[h] : i < hs.hlit[h];
    hs.key[e] = live ? v[e] + 16 * sec : -1 - i;   // dead: a key of its own
  }
  __syncthreads();
  // codegen RLE (header._rle_emit), a position a thread
  for (int e = tid; e < 2 * kSeq; e += nt) {
    const int h = e / kSeq, i = e % kSeq;
    const int* key = hs.key + h * kSeq;
    const int kk = key[i];
    int start = i;
    while (start > 0 && key[start - 1] == kk) --start;
    int end = i + 1;
    while (end < kSeq && key[end] == kk) ++end;
    const int live = kk >= 0;
    const int r = end - start, o = i - start;
    const int val = v[e];
    int sym, ev, eb, emit;
    if (val == 0) {
      const int q = r / 138, s = r - 138 * q;
      const int c18 = q + (s >= 11);
      const int tail = s >= 11 ? 0 : s;
      const int at_chunk = (o % 138 == 0) && (o / 138 < c18);
      const int sz18 = min(r - o, 138);
      const int z_tail = 138 * q + (s >= 11 ? s : 0);
      const int e17 = tail >= 3 && o == z_tail;
      const int lit0 = tail < 3 && o >= z_tail;
      sym = at_chunk ? 18 : e17 ? 17 : 0;
      ev = at_chunk ? sz18 - 11 : e17 ? tail - 3 : 0;
      eb = at_chunk ? 7 : e17 ? 3 : 0;
      emit = at_chunk || e17 || lit0;
    } else {
      const int rem = r - 1, q2 = rem / 6, s2 = rem - 6 * q2;
      const int c16 = q2 + (s2 >= 3);
      const int tail2 = s2 >= 3 ? 0 : s2;
      const int at16 = o >= 1 && (o - 1) % 6 == 0 && (o - 1) / 6 < c16;
      const int sz16 = min(r - o, 6);
      const int nz_tail = 1 + 6 * q2 + (s2 >= 3 ? s2 : 0);
      const int litv = o == 0 || (tail2 > 0 && o >= nz_tail);
      sym = at16 ? 16 : val;
      ev = at16 ? sz16 - 3 : 0;
      eb = at16 ? 2 : 0;
      emit = at16 || litv;
    }
    emit = emit && live;
    hs.item[e] = sym | (ev << 8) | (eb << 16) | (emit << 24);
    if (emit) atomicAdd(&hs.cg_freq[h * kNumCodegen + sym], 1);
  }
  __syncthreads();
  Lists cg;
  cg.nl = 2;
  cg.n[0] = cg.n[1] = cg.n[2] = kNumCodegen;
  cg.off[0] = 0;
  cg.off[1] = kNumCodegen;
  cg.off[2] = 2 * kNumCodegen;
  cg.N = 2 * kNumCodegen;
  pm_lengths(hs.cg_freq, hs.cg_lens, cg, kMaxCgBits, pm);
  packed_tables(hs.cg_lens, hs.cg_packed, cg, kMaxCgBits, cnt, next);
  for (int e = tid; e < 2 * kNumCodegen; e += nt) {
    const int h = e / kNumCodegen, k = e % kNumCodegen;
    if (hs.cg_lens[h * kNumCodegen + kCodegenOrder[k]] > 0)
      atomicMax(&hs.hclen[h], k + 1);
  }
  __syncthreads();
  // the fields: 4 head fields, 19 codegen lengths, 2 a sequence position
  for (int e = tid; e < 2 * kHdrSlots; e += nt) {
    const int h = e / kHdrSlots, q = e % kHdrSlots;
    int val, bits;
    if (q < 4) {
      val = q == 0 ? 2 << 1 : q == 1 ? hs.hlit[h] - 257
            : q == 2 ? hs.hdist[h] - 1 : hs.hclen[h] - 4;
      bits = q == 0 ? 3 : q == 3 ? 4 : 5;
    } else if (q < 23) {
      val = hs.cg_lens[h * kNumCodegen + kCodegenOrder[q - 4]];
      bits = q - 4 < hs.hclen[h] ? 3 : 0;
    } else {
      const int it = hs.item[h * kSeq + (q - 23) / 2];
      const int sym = it & 0xFF, emit = it >> 24;
      if ((q - 23) % 2 == 0) {
        const int pe = hs.cg_packed[h * kNumCodegen + sym];
        val = pe & 0xFFFFFF;
        bits = emit ? pe >> 24 : 0;
      } else {
        val = (it >> 8) & 0xFF;
        bits = emit ? (it >> 16) & 0xFF : 0;
      }
    }
    out[2 * h * kHdrSlots + q] = val;
    out[(2 * h + 1) * kHdrSlots + q] = bits;
    if (bits) atomicAdd(&hs.hbits[h], bits);
  }
  __syncthreads();
}

// A bump allocator over the dynamic shared memory.
struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(int n) {
    T* r = reinterpret_cast<T*>(p);
    p += (static_cast<size_t>(n) * sizeof(T) + 15) & ~static_cast<size_t>(15);
    return r;
  }
};

constexpr size_t rnd16(size_t bytes) { return (bytes + 15) & ~size_t{15}; }
constexpr int kPlanN = kHExtra;                    // 602: ll, d, byte
// F2's dynamic shared memory, taken in this order by Carve
constexpr size_t kPlanSmem =
    3 * rnd16(kPlanN * 4) +                        // h2, lens, ebfix
    rnd16(kPlanN * 4) + rnd16(kPlanN * 2) +        // pm ws, ssym
    2 * rnd16(2 * kPlanN * 4) + rnd16(kPlanN * 4) +  // pm lw0, lw1, pk
    rnd16((kMaxBits + 1) * kPlanN * 2) +           // pm posa
    rnd16(64 * 4) + rnd16(4 * 4) +                 // pm olv, nact
    3 * rnd16(2 * kSeq * 4) +                      // hv_in, key, item
    3 * rnd16(2 * kNumCodegen * 4) +               // cg freq, lens, packed
    rnd16(16 * 4) + rnd16(48 * 4) + rnd16(48 * 8); // small, cnt, next

// --------------------------------------------------------------------------
// F2: a shard's plan.  hist (B, nseg, kHistStride) from F1; fixtab the
// fixed litlen and distance tables, packed (316 int32); plan (B,
// plan_stride) int32 for F3; total_bits and kind (B,) int64.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kPlanThreads)
fields_plan_kernel(const int* __restrict__ hist, const void* valid_len,
                   int vl64, const int* __restrict__ fixtab,
                   int* __restrict__ plan, long long* __restrict__ total_bits,
                   long long* __restrict__ kind_out, int S, int seg, int nseg,
                   int plan_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long sums[8];
  __shared__ int nopen_sh, kind_sh, anyd, sum_ll, sum_d;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int b = blockIdx.x;
  const int* H = hist + static_cast<long long>(b) * nseg * kHistStride;
  int* PL = plan + static_cast<long long>(b) * plan_stride;
  int* SG = PL + kPSeg;
  const long long vl = load_int(valid_len, vl64, b);
  const long long merge = max(1, kMaxStored / seg);

  Carve cv{smem};
  int* h2 = cv.take<int>(kPlanN);          // pass-2 histograms (+ totals)
  int* lens = cv.take<int>(kPlanN);        // ll, d, lit lengths
  unsigned* ebfix = cv.take<unsigned>(kPlanN);   // estimate lengths * 2^23
  PmScratch pm;
  pm.ws = cv.take<int>(kPlanN);
  pm.ssym = cv.take<uint16_t>(kPlanN);
  pm.lw0 = cv.take<int>(2 * kPlanN);
  pm.lw1 = cv.take<int>(2 * kPlanN);
  pm.pk = cv.take<int>(kPlanN);
  pm.posa = cv.take<uint16_t>((kMaxBits + 1) * kPlanN);
  pm.olv = cv.take<int>(64);
  pm.nact = cv.take<int>(4);
  int* hv_in = cv.take<int>(2 * kSeq);
  HdrScratch hs;
  hs.key = cv.take<int>(2 * kSeq);
  hs.item = cv.take<int>(2 * kSeq);
  hs.cg_freq = cv.take<int>(2 * kNumCodegen);
  hs.cg_lens = cv.take<int>(2 * kNumCodegen);
  hs.cg_packed = cv.take<int>(2 * kNumCodegen);
  int* small = cv.take<int>(16);
  hs.hlit = small;
  hs.hdist = small + 2;
  hs.hclen = small + 4;
  hs.hbits = small + 6;
  int* cnt = cv.take<int>(48);
  long long* next = cv.take<long long>(48);

  // ---- totals over all segments, live bytes ----
  if (tid == 0) sum_ll = sum_d = nopen_sh = anyd = 0;
  if (tid < 8) sums[tid] = 0;
  __syncthreads();
  for (int s = tid; s < kSeq; s += nt) {
    int t = 0;
    for (int j = 0; j < nseg; ++j) t += H[j * kHistStride + s];
    h2[s] = t;
    if (t) atomicAdd(s < kNumLitLen ? &sum_ll : &sum_d, t);
  }
  for (int j = tid; j < nseg; j += nt) {
    const long long start = static_cast<long long>(j) * seg;
    const long long len = min(static_cast<long long>(seg), S - start);
    SG[kSegInfo * j + 1] = static_cast<int>(
        min(max(vl - start, 0LL), len));
  }
  __syncthreads();
  // ---- the estimate's lengths (squeeze._entropy_lens), times 2^23 ----
  for (int s = tid; s < kSeq; s += nt) {
    const int h = h2[s];
    unsigned fix = 0;
    if (h > 0) {
      const float total = static_cast<float>(
          max(s < kNumLitLen ? sum_ll : sum_d, 1));
      const float p = fmaxf(static_cast<float>(h) / total, 1e-9f);
      const float lg = static_cast<float>(log2(static_cast<double>(p)));
      const float bits = fminf(fmaxf(-lg + 0.35f, 1.0f), 15.0f);
      fix = static_cast<unsigned>(bits * 8388608.0f);     // exact
    }
    ebfix[s] = fix;
  }
  __syncthreads();
  // ---- each segment's estimate and stored decision: a warp a segment ----
  for (int j = warp; j < nseg; j += nwarps) {
    const int* row = H + j * kHistStride;
    long long acc = 0;
    for (int s = lane; s < kSeq; s += 32)
      acc += static_cast<long long>(row[s]) * ebfix[s];
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
    if (lane == 0) {
      const long long est = acc + (static_cast<long long>(row[kHExtra]) << 23);
      const float coded = static_cast<float>(static_cast<double>(est) * 0x1p-23);
      const int lb = SG[kSegInfo * j + 1];
      const float stored = static_cast<float>(8 * lb + 40);
      int f = 0;
      if (coded > stored + static_cast<float>(kHyst) && lb > 0) f |= kFStored0;
      if (row[kHCross]) f |= kFCross;
      SG[kSegInfo * j] = f;
    }
  }
  __syncthreads();
  // ---- tokens across a boundary chain both sides' choice ----
  if (tid == 0) {
    int col = 0, prev_coded = 0, nopen = 0, prev_cross = 0;
    for (int j = 0; j < nseg; ++j) {
      int f = SG[kSegInfo * j];
      const int live = SG[kSegInfo * j + 1] > 0;
      const int st0 = (f & kFStored0) != 0;
      col = j == 0 ? st0 : (prev_cross && live) ? col : st0;
      const int stored = col && live;
      const int coded = live && !stored;
      if (stored) f |= kFStored;
      if (coded) f |= kFCoded;
      if (coded && !prev_coded) ++nopen;
      prev_coded = coded;
      prev_cross = (f & kFCross) != 0;
      SG[kSegInfo * j] = f;
    }
    nopen_sh = nopen;
  }
  __syncthreads();
  // ---- pass 2: histograms and extras over the coded segments ----
  for (int s = tid; s <= kHExtra; s += nt) {
    int t = 0;
    for (int j = 0; j < nseg; ++j)
      if (SG[kSegInfo * j] & kFCoded) t += H[j * kHistStride + s];
    if (s < kHExtra) h2[s] = t;
    else sums[7] = static_cast<unsigned long long>(t);   // extras
  }
  __syncthreads();
  if (tid == 0) {
    const int eobs = max(nopen_sh, 1);
    h2[kHLL + kEob] += eobs;
    h2[kHByte + kEob] += eobs;
  }
  __syncthreads();
  // ---- the three package-merges: litlen, distance, literal-only ----
  Lists three;
  three.nl = 3;
  three.n[0] = kNumLitLen;
  three.n[1] = kNumDist;
  three.n[2] = kNumLitLen;
  three.off[0] = kHLL;
  three.off[1] = kHD;
  three.off[2] = kHByte;
  three.N = kPlanN;
  pm_lengths(h2, lens, three, kMaxBits, pm);
  if (tid < kNumDist && lens[kHD + tid] > 0) atomicOr(&anyd, 1);
  __syncthreads();
  if (tid == 0 && !anyd) lens[kHD] = 1;    // no distance: one code of 1 bit
  __syncthreads();
  // ---- the dynamic and literal-only headers ----
  for (int e = tid; e < 2 * kSeq; e += nt) {
    const int h = e / kSeq, i = e % kSeq;
    hv_in[e] = i < kNumLitLen ? lens[(h ? kHByte : kHLL) + i]
               : h ? (i == kNumLitLen) : lens[kHD + i - kNumLitLen];
  }
  __syncthreads();
  build_headers(hv_in, PL + kPHdr, hs, pm, cnt, next);
  // ---- the four costs ----
  {
    unsigned long long dyn = 0, fix = 0, lit = 0;
    for (int s = tid; s < kNumLitLen; s += nt) {
      const long long f = h2[kHLL + s];
      dyn += f * lens[kHLL + s];
      fix += f * (fixtab[s] >> 24);
      lit += static_cast<long long>(h2[kHByte + s]) * lens[kHByte + s];
    }
    for (int d = tid; d < kNumDist; d += nt) {
      const long long f = h2[kHD + d];
      dyn += f * lens[kHD + d];
      fix += f * (fixtab[kNumLitLen + d] >> 24);
    }
    if (dyn) atomicAdd(&sums[0], dyn);
    if (fix) atomicAdd(&sums[1], fix);
    if (lit) atomicAdd(&sums[2], lit);
  }
  __syncthreads();
  if (tid == 0) {
    long long stored_bytes = 0;
    int any_stored = 0;
    for (int j = 0; j < nseg; ++j)
      if (SG[kSegInfo * j] & kFStored) {
        stored_bytes += SG[kSegInfo * j + 1];
        any_stored = 1;
      }
    const long long stored_hdrs =
        any_stored ? ceil_div(stored_bytes, merge * seg) + 1 : 0;
    const long long stored_const = 44 * stored_hdrs + 8 * stored_bytes;
    const long long extras = static_cast<long long>(sums[7]);
    const long long nopen = nopen_sh;
    long long cost[4];
    cost[kDyn] = nopen * hs.hbits[0] + static_cast<long long>(sums[0]) +
                 extras + stored_const;
    cost[kFix] = nopen * 3 + static_cast<long long>(sums[1]) + extras +
                 stored_const;
    cost[kLit] = nopen * hs.hbits[1] + static_cast<long long>(sums[2]) +
                 stored_const;
    const long long all_hdrs = max(ceil_div(vl, merge * seg), 1LL);
    cost[kSto] = 44 * all_hdrs + 8 * vl;
    int kind = 0;
    for (int k = 1; k < 4; ++k)
      if (cost[k] < cost[kind]) kind = k;            // the first minimum
    kind_sh = kind;
    kind_out[b] = kind;
    // all-stored shards: every live segment goes raw; then the openings,
    // closings and stored-block headers
    int prev_coded = 0, prev_stored = 0;
    for (int j = 0; j < nseg; ++j) {
      int f = SG[kSegInfo * j] & (kFStored0 | kFCross | kFStored);
      const int live = SG[kSegInfo * j + 1] > 0;
      if (kind == kSto) f = live ? f | kFStored : f & ~kFStored;
      const int stored = (f & kFStored) != 0;
      const int coded = live && !stored;
      if (coded) f |= kFCoded;
      if (coded && !prev_coded) f |= kFOpen;
      if (prev_coded && stored) f |= kFClose;
      if (stored && (!prev_stored || j % merge == 0)) f |= kFHdr;
      prev_coded = coded;
      prev_stored = stored;
      SG[kSegInfo * j] = f;
    }
    // each stored-block header's byte cover (backward)
    long long nxt = 0;
    for (int j = nseg - 1; j >= 0; --j) {
      long long c = SG[kSegInfo * j + 1];
      if (j + 1 < nseg) {
        const int fn = SG[kSegInfo * (j + 1)];
        if ((fn & kFStored) && !(fn & kFHdr)) c += nxt;
      }
      SG[kSegInfo * j + 2] = static_cast<int>(c);
      nxt = c;
    }
  }
  __syncthreads();
  const int kind = kind_sh;
  // ---- the selected code tables ----
  if (kind == kFix) {
    for (int s = tid; s < kSeq; s += nt) PL[kPLLTab + s] = fixtab[s];
    __syncthreads();
  } else {
    // the selected lengths into ebfix (free now): litlen then distance
    int* sel = reinterpret_cast<int*>(ebfix);
    for (int s = tid; s < kSeq; s += nt)
      sel[s] = s < kNumLitLen ? lens[(kind == kDyn ? kHLL : kHByte) + s]
               : kind == kDyn ? lens[kHD + s - kNumLitLen]
                              : (s == kNumLitLen);
    __syncthreads();
    Lists two;
    two.nl = 2;
    two.n[0] = kNumLitLen;
    two.n[1] = kNumDist;
    two.n[2] = 0;
    two.off[0] = 0;
    two.off[1] = kNumLitLen;
    two.off[2] = kSeq;
    two.N = kSeq;
    packed_tables(sel, PL + kPLLTab, two, kMaxBits, cnt, next);
  }
  // ---- each segment's body bits: a warp a segment ----
  for (int j = warp; j < nseg; j += nwarps) {
    const int* row = H + j * kHistStride;
    const int f = SG[kSegInfo * j];
    long long acc = 0;
    if (!(f & kFStored)) {
      if (kind == kLit) {
        for (int s = lane; s < kNumLitLen; s += 32)
          acc += static_cast<long long>(row[kHByte + s]) * (PL[kPLLTab + s] >> 24);
      } else {
        for (int s = lane; s < kSeq; s += 32)
          acc += static_cast<long long>(row[s]) * (PL[kPLLTab + s] >> 24);
      }
    }
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
    if (lane == 0) {
      if (f & kFStored) acc = 8LL * SG[kSegInfo * j + 1];
      else if (kind != kLit) acc += row[kHExtra];
      SG[kSegInfo * j + 3] = static_cast<int>(acc);
    }
  }
  __syncthreads();
  // ---- the running bit account, the trailer ----
  if (tid == 0) {
    const int eob = PL[kPLLTab + kEob];
    const long long eob_b = eob >> 24;
    const long long hbits_sel = kind == kDyn ? hs.hbits[0]
                                : kind == kFix ? 3 : hs.hbits[1];
    long long run = 0;
    for (int j = 0; j < nseg; ++j) {
      const int f = SG[kSegInfo * j];
      if (f & kFClose) run += eob_b;
      int s1 = 0;
      if (f & kFHdr) {
        const int pad = static_cast<int>((8 - (run + 3) % 8) % 8);
        s1 = 3 + pad;
        run += 35 + pad;
      }
      if (f & kFOpen) run += hbits_sel;
      run += SG[kSegInfo * j + 3];
      SG[kSegInfo * j] = f | (s1 << 8);
    }
    const long long last_live = min(max(ceil_div(vl, seg) - 1, 0LL),
                                    static_cast<long long>(nseg - 1));
    const int last_coded =
        vl > 0 && (SG[kSegInfo * last_live] & kFCoded) != 0;
    const long long t_eob = last_coded ? eob_b : 0;
    run += t_eob;
    const long long m1 = 3 + (8 - (run + 3) % 8) % 8;
    PL[kPMisc + 0] = kind;
    PL[kPMisc + 1] = static_cast<int>(t_eob);
    PL[kPMisc + 2] = static_cast<int>(m1);
    total_bits[b] = run + m1 + 32;
  }
}

// --------------------------------------------------------------------------
// F3: a segment's slots.  vals / bits (B, slots) int32; every slot is
// written (zero bits, zero value where dead).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kEmitThreads)
fields_emit_kernel(const uint8_t* __restrict__ window,
                   const int* __restrict__ mlen, const int* __restrict__ mdist,
                   const uint8_t* __restrict__ starts,
                   const uint8_t* __restrict__ take, const void* valid_len,
                   int vl64, const void* final_flag, int fin64,
                   const int* __restrict__ plan, int* __restrict__ vals,
                   int* __restrict__ bits, int S, int seg, int nseg,
                   int plan_stride, int slots, long long ldw, long long ldm,
                   long long ldd, long long lds, long long ldt) {
  __shared__ int tab[kSeq];
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int* PL = plan + static_cast<long long>(b) * plan_stride;
  for (int s = tid; s < kSeq; s += nt) tab[s] = PL[kPLLTab + s];
  __syncthreads();
  const int kind = PL[kPMisc];
  const int f = PL[kPSeg + kSegInfo * j];
  const int cover = PL[kPSeg + kSegInfo * j + 2];
  const int eob_v = tab[kEob] & 0xFFFFFF, eob_b = tab[kEob] >> 24;
  const long long vl = load_int(valid_len, vl64, b);
  int* V = vals + static_cast<long long>(b) * slots;
  int* W = bits + static_cast<long long>(b) * slots;
  const long long base = static_cast<long long>(j) * (kBnd + 2LL * seg);

  if (tid < 4) {              // close, stored header + pad, LEN, NLEN
    const int hh = (f & kFHdr) != 0;
    const int bw = tid == 0 ? ((f & kFClose) ? eob_b : 0)
                   : tid == 1 ? (f >> 8) : hh ? 16 : 0;
    const int v = tid == 0 ? eob_v : tid == 1 ? 0
                  : tid == 2 ? cover : (~cover) & 0xFFFF;
    V[base + tid] = bw > 0 ? v : 0;
    W[base + tid] = bw;
  }
  const int open = (f & kFOpen) != 0;
  const int* hsrc = PL + kPHdr + (kind == kDyn ? 0 : 2 * kHdrSlots);
  for (int q = tid; q < kHdrSlots; q += nt) {
    int v = 0, bw = 0;
    if (open) {
      if (kind == kFix) {
        v = q == 0 ? 1 << 1 : 0;
        bw = q == 0 ? 3 : 0;
      } else {
        v = hsrc[q];
        bw = hsrc[kHdrSlots + q];
      }
    }
    V[base + 4 + q] = bw > 0 ? v : 0;
    W[base + 4 + q] = bw;
  }
  const uint8_t* wr = window + b * ldw;
  const int* ml = mlen + b * ldm;
  const int* md = mdist + b * ldd;
  const uint8_t* st = starts + b * lds;
  const uint8_t* tk = take + b * ldt;
  const int p0 = j * seg;
  const int n = min(seg, S - p0);
  const int stored = (f & kFStored) != 0;
  const long long body = base + kBnd;
  for (int q = tid; q < n; q += nt) {
    const int p = p0 + q;
    int av = 0, ab = 0, bv = 0, bb = 0;
    if (stored) {
      av = wr[p];
      ab = p < vl ? 8 : 0;
    } else if (kind == kLit) {
      const int e = tab[wr[p]];
      av = e & 0xFFFFFF;
      ab = p < vl ? e >> 24 : 0;
    } else {
      const Token t = token_at(wr, ml, md, st, tk, vl, p);
      const int e = tab[t.llsym];
      const int lb = e >> 24;
      av = (e & 0xFFFFFF) | (t.lev << lb);
      ab = t.tok ? lb + t.leb : 0;
      if (t.match) {
        const int d = tab[kNumLitLen + t.dcode];
        const int db = d >> 24;
        bv = (d & 0xFFFFFF) | (t.dev << db);
        bb = db + t.deb;
      }
    }
    V[body + 2 * q] = ab > 0 ? av : 0;
    W[body + 2 * q] = ab;
    V[body + 2 * q + 1] = bb > 0 ? bv : 0;
    W[body + 2 * q + 1] = bb;
  }
  if (j == nseg - 1) {
    const long long tr = static_cast<long long>(nseg) * kBnd + 2LL * S;
    if (tid < 4) {            // close, the empty stored block
      const int bw = tid == 0 ? PL[kPMisc + 1] : tid == 1 ? PL[kPMisc + 2] : 16;
      const int v = tid == 0 ? eob_v
                    : tid == 1 ? static_cast<int>(load_int(final_flag, fin64, b))
                    : tid == 2 ? 0 : 0xFFFF;
      V[tr + tid] = bw > 0 ? v : 0;
      W[tr + tid] = bw;
    }
    for (long long q = tr + 4 + tid; q < slots; q += nt) {
      V[q] = 0;
      W[q] = 0;
    }
  }
}

}  // namespace

extern "C" {

// window (B, S) u8, mlen and mdist (B, S) int32, starts and take (B, S)
// bool, each row contiguous and ld* elements after the one before;
// valid_len and final (B,) int32 or int64 (vl64, fin64); fixtab (316,)
// int32; hist (B, nseg, 604) and plan (B, plan_stride) int32 scratch;
// vals and bits (B, slots) int32; total_bits and kind (B,) int64.
int flate_fields_hist(const void* window, const void* mlen, const void* mdist,
                      const void* starts, const void* take,
                      const void* valid_len, int vl64, void* hist, int B,
                      int S, int seg, long long ldw, long long ldm,
                      long long ldd, long long lds, long long ldt,
                      void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (S + seg - 1) / seg;
  fields_hist_kernel<<<dim3(static_cast<unsigned>(nseg), static_cast<unsigned>(B)),
                       kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(window), static_cast<const int*>(mlen),
      static_cast<const int*>(mdist), static_cast<const uint8_t*>(starts),
      static_cast<const uint8_t*>(take), valid_len, vl64,
      static_cast<int*>(hist), S, seg, nseg, ldw, ldm, ldd, lds, ldt);
  return static_cast<int>(cudaGetLastError());
}

int flate_fields_plan(const void* hist, const void* valid_len, int vl64,
                      const void* fixtab, void* plan, void* total_bits,
                      void* kind, int B, int S, int seg, int plan_stride,
                      void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (S + seg - 1) / seg;
  if (plan_stride < kPSeg + kSegInfo * nseg)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      fields_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPlanSmem)));
  if (rc != 0) return rc;
  fields_plan_kernel<<<static_cast<unsigned>(B), kPlanThreads, kPlanSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), valid_len, vl64,
      static_cast<const int*>(fixtab), static_cast<int*>(plan),
      static_cast<long long*>(total_bits), static_cast<long long*>(kind), S,
      seg, nseg, plan_stride);
  return static_cast<int>(cudaGetLastError());
}

int flate_fields_emit(const void* window, const void* mlen, const void* mdist,
                      const void* starts, const void* take,
                      const void* valid_len, int vl64, const void* final_flag,
                      int fin64, const void* plan, void* vals, void* bits,
                      int B, int S, int seg, int plan_stride, int slots,
                      long long ldw, long long ldm, long long ldd,
                      long long lds, long long ldt, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (S + seg - 1) / seg;
  if (slots < nseg * kBnd + 2LL * S + 4)
    return static_cast<int>(cudaErrorInvalidValue);
  fields_emit_kernel<<<dim3(static_cast<unsigned>(nseg), static_cast<unsigned>(B)),
                       kEmitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(window), static_cast<const int*>(mlen),
      static_cast<const int*>(mdist), static_cast<const uint8_t*>(starts),
      static_cast<const uint8_t*>(take), valid_len, vl64, final_flag, fin64,
      static_cast<const int*>(plan), static_cast<int*>(vals),
      static_cast<int*>(bits), S, seg, nseg, plan_stride, slots, ldw, ldm,
      ldd, lds, ldt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

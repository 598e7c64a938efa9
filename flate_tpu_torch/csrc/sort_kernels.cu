// Hand-written Hopper (sm_90a) kernel of the bitonic sort probe (B10).
//
// Replaces tools/bitonic_probe.py:_kernel (via run): per row of n u32
// elements (2^18 in the probe), a list of bitonic compare-exchange substages
// (j, k) over a key and NOPS-1 carried operands.  The rule is per element,
// not per pair: element i takes its partner i^j's key and operands where
//
//     (key[i^j] < key[i]) == ((i & j) == 0) == ((i & k) == 0)
//
// (unsigned compare).  With equal keys one element of a pair copies the
// other's operands and the other keeps its own, so operands are duplicated,
// not swapped; the kernel keeps that rule exactly.
//
// Design.  Every operand follows the same decisions, and those depend on the
// keys alone, so the network runs on (key, source index) pairs, one packed
// 8-byte word an element, and each operand is gathered once at the end:
// op_out[i] = op_in[src[i]].  `src` is a map, not a permutation, so
// duplicates survive.  The wrapper (flate_tpu_torch/device/bitonic.py,
// plan_passes) cuts the substage list into passes over device memory:
//
//  - a tile group: a run of substages with j < kTile.  One block holds an
//    aligned tile of 16,384 elements, 16 in each of its 1,024 threads'
//    registers.  A substage whose partner sits in the same thread runs in
//    registers; one whose partner sits in the same warp runs by
//    __shfl_xor_sync.  Two layouts of the tile's 14 index bits cover all of
//    them: A (lane = bits 0-4, slot = bits 5-8, warp = bits 9-13) for
//    j < 2^9 and B (warp = bits 0-4, lane = bits 5-9, slot = bits 10-13) for
//    j >= 2^9.  Only a change of layout goes through shared memory (128 KiB,
//    XOR-swizzled so neither layout has bank conflicts), with two
//    __syncthreads.  Layout A is the one that loads and stores device memory:
//    a warp's lanes then hold 32 consecutive elements.  Rows shorter than a
//    tile share one (the last tile of a batch is then cut short).
//  - a device-memory group: up to kDevMax consecutive substages with
//    j >= kTile.  A thread loads 16 elements, 16 / 2^d groups of the 2^d
//    elements i | (subsets of the d distinct j bits), runs the substages in
//    registers and stores them back; consecutive threads take consecutive i.
//
// Most substages ascend or descend in all of a thread's slots (k's bit is a
// lane, warp or row bit); their compares then take the direction as one
// predicate instead of a bit a slot.  The last pass also writes the keys
// out; then the operands are gathered, one thread an element in row order.
// A random 4-byte read costs a 32-byte sector, so the operands, up to 8 at
// a time, are first interleaved into one 16- or 32-byte record an element
// (a streaming pass) and each element then reads its source's record once.
// The gather is not fused into the last pass: a tile pass keeps one
// 16,384-element tile on each SM, ~8 rows in flight, and their operands
// overflow the 50 MB L2.  The full network on 2^18 elements is 9 passes
// (one tile pass for k <= 2^14, then a device-memory pass and a tile pass
// for each k from 2^15 to 2^18) and the gather, where tiles of 4,096
// elements in shared memory and one device-memory pass per substage with
// j >= 4,096 took 28 passes and the gather.
//
// Bound: bytes — each array read once and written once (9 x 2 x 4 bytes an
// element at NOPS = 9).  The passes move 16 bytes an element each (the
// first reads 4-byte keys, the last also writes them); the gather reads
// each operand once and writes and reads its record once, and reads the
// 8-byte (key, src) once.
//
// Interface: plain C (ctypes), launches on the caller's stream and returns
// cudaGetLastError().  Buffers are allocated and checked by the wrapper.
// u32 values travel in 32-bit buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileBits = 14;
constexpr int kTile = 1 << kTileBits;        // elements a tile pass holds
constexpr int kSlotBits = 4;
constexpr int kSlots = 1 << kSlotBits;       // elements a thread holds
constexpr int kTileThreads = kTile / kSlots;  // 1,024
constexpr int kHighBit = 9;                  // j >= 2^9 runs in layout B
constexpr int kDevMax = 4;                   // substages of a device-memory group
constexpr int kRunMax = 128;                 // substages of a tile group
constexpr int kOpsMax = 8;                   // operands of one record
constexpr int kThreads = 256;
constexpr uint32_t kFull = 0xFFFFFFFFu;

struct StageRun {
  int j[kRunMax];
  int k[kRunMax];
};

struct DevGroup {
  int bit[kDevMax];   // the group's distinct j bits, ascending
  int q[kDevMax];     // each substage's slot bit (its j bit's place in `bit`)
  int k[kDevMax];
  int m;              // substages
};

struct OpPtrs {
  const uint32_t* in[kOpsMax];
  uint32_t* out[kOpsMax];
};

// What a pass reads and writes.  first: the keys come from key_in and the
// sources start at the row index, else both come from the (key, src)
// scratch `pairs`, which every pass writes; last: the keys also go to
// key_out.
struct Pass {
  const uint32_t* key_in;
  uint2* pairs;
  uint32_t* key_out;
  long long total;
  int n;
  bool first, last;
};

// The probe's rule applied to both elements of the pair (lo, hi = lo | j),
// each on its own: lo takes hi's where (khi < klo) == asc_lo, hi takes lo's
// where (klo < khi) != asc_hi.
__device__ __forceinline__ void exchange(uint32_t& klo, uint32_t& slo,
                                         uint32_t& khi, uint32_t& shi,
                                         bool asc_lo, bool asc_hi) {
  const bool take_lo = (khi < klo) == asc_lo;
  const bool take_hi = (klo < khi) != asc_hi;
  const uint32_t k0 = klo, k1 = khi, s0 = slo, s1 = shi;
  klo = take_lo ? k1 : k0;
  slo = take_lo ? s1 : s0;
  khi = take_hi ? k0 : k1;
  shi = take_hi ? s0 : s1;
}

// The 16-bit set of slots s with (s & x) == 0, x a set of slot bits.
__device__ __forceinline__ uint32_t free_slots(int x) {
  uint32_t m = 0xFFFFu;
  if (x & 1) m &= 0x5555u;
  if (x & 2) m &= 0x3333u;
  if (x & 4) m &= 0x0F0Fu;
  if (x & 8) m &= 0x00FFu;
  return m;
}

// A substage whose partner is slot s ^ 2^Q of the same thread; Asc(s) says
// whether slot s lies in an ascending region ((i & k) == 0).
template <int Q, class Asc>
__device__ __forceinline__ void reg_stage(uint32_t (&key)[kSlots],
                                          uint32_t (&src)[kSlots], Asc asc) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (s & (1 << Q)) continue;
    constexpr int b = 1 << Q;
    exchange(key[s], src[s], key[s | b], src[s | b], asc(s), asc(s | b));
  }
}

// Bit s of `mask`: slot s ascends.  Most substages ascend or descend in all
// of a thread's slots (k's bit is a lane, warp or row bit); their compares
// then take the direction as one predicate.
template <int Q>
__device__ __forceinline__ void reg_stage_m(uint32_t (&key)[kSlots],
                                            uint32_t (&src)[kSlots],
                                            uint32_t mask) {
  if (mask == 0u || mask == 0xFFFFu) {
    const bool up = mask != 0u;
    reg_stage<Q>(key, src, [=](int) { return up; });
  } else {
    reg_stage<Q>(key, src, [=](int s) { return ((mask >> s) & 1u) != 0u; });
  }
}

__device__ __forceinline__ void reg_stage_q(int q, uint32_t (&key)[kSlots],
                                            uint32_t (&src)[kSlots],
                                            uint32_t mask) {
  switch (q) {
    case 0: reg_stage_m<0>(key, src, mask); break;
    case 1: reg_stage_m<1>(key, src, mask); break;
    case 2: reg_stage_m<2>(key, src, mask); break;
    default: reg_stage_m<3>(key, src, mask); break;
  }
}

// A substage whose partner sits in lane ^ off of the same warp; Same(s):
// this lane's element of slot s is the lower of its pair exactly when
// the slot ascends.
template <class Same>
__device__ __forceinline__ void shfl_stage(uint32_t (&key)[kSlots],
                                           uint32_t (&src)[kSlots], Same same,
                                           int off) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const uint32_t kp = __shfl_xor_sync(kFull, key[s], off);
    const uint32_t sp = __shfl_xor_sync(kFull, src[s], off);
    const bool take = (kp < key[s]) == same(s);
    key[s] = take ? kp : key[s];
    src[s] = take ? sp : src[s];
  }
}

// up: this lane holds the lower element of its pairs; bit s of `mask`:
// slot s ascends.
__device__ __forceinline__ void shfl_stage_m(uint32_t (&key)[kSlots],
                                             uint32_t (&src)[kSlots],
                                             uint32_t mask, int off, bool up) {
  const uint32_t same = up ? mask : ~mask & 0xFFFFu;   // bit s: up == asc
  if (same == 0u || same == 0xFFFFu) {
    const bool u = same != 0u;
    shfl_stage(key, src, [=](int) { return u; }, off);
  } else {
    shfl_stage(key, src, [=](int s) { return ((same >> s) & 1u) != 0u; },
               off);
  }
}

// Shared-memory position of tile element i: bits 5-9 XORed into bits 0-4,
// so the 32 lanes of either layout spread over all 32 banks (two wavefronts
// a warp, the least an 8-byte access takes).
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

// Tile element of (lane, warp, slot s) in layout A or B.
__device__ __forceinline__ int elem_a(int lane, int warp, int s) {
  return lane | (s << 5) | (warp << kHighBit);
}
__device__ __forceinline__ int elem_b(int lane, int warp, int s) {
  return warp | (lane << 5) | (s << (kTileBits - kSlotBits));
}

// Move a thread's elements from one layout of the tile to the other through
// shared memory.
__device__ __forceinline__ void relayout(uint2* tile, uint32_t (&key)[kSlots],
                                         uint32_t (&src)[kSlots], int lane,
                                         int warp, bool to_high) {
  __syncthreads();              // every read of the last layout is done
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = to_high ? elem_a(lane, warp, s) : elem_b(lane, warp, s);
    tile[swz(i)] = make_uint2(key[s], src[s]);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = to_high ? elem_b(lane, warp, s) : elem_a(lane, warp, s);
    const uint2 v = tile[swz(i)];
    key[s] = v.x;
    src[s] = v.y;
  }
}

// A tile group: one block per aligned tile of kTile elements.
__global__ void __launch_bounds__(kTileThreads, 1)
tile_pass(Pass p, StageRun run, int nrun) {
  extern __shared__ uint2 tile[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int nm = p.n - 1;
  const int rb = static_cast<int>(base & nm);   // tile offset in its row
  // elements of this tile (fewer in a batch's last tile of short rows)
  const int len = p.total - base < kTile ? static_cast<int>(p.total - base)
                                         : kTile;
  uint2* const pairs = p.pairs + base;
  uint32_t key[kSlots], src[kSlots];
  // load in layout A: slot s of a warp is 32 consecutive elements
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = elem_a(lane, warp, s);
    if (i < len) {
      if (p.first) {
        key[s] = p.key_in[base + i];
        src[s] = static_cast<uint32_t>((rb + i) & nm);
      } else {
        const uint2 v = pairs[i];
        key[s] = v.x;
        src[s] = v.y;
      }
    } else {                    // past the batch's end: never stored
      key[s] = kFull;
      src[s] = 0;
    }
  }
  bool high = false;
  for (int t = 0; t < nrun; ++t) {
    const int b = __ffs(run.j[t]) - 1;
    const int kk = run.k[t] & nm;
    const bool need_high = b >= kHighBit;
    if (need_high != high) {
      relayout(tile, key, src, lane, warp, need_high);
      high = need_high;
    }
    // slot s of this thread is row index rbase | s << sh
    const int sh = high ? kTileBits - kSlotBits : 5;
    const int rbase = rb + (high ? warp | (lane << 5) : lane | (warp << kHighBit));
    const uint32_t asc =
        (rbase & kk) == 0 ? free_slots((kk >> sh) & (kSlots - 1)) : 0u;
    if (b >= sh) {
      reg_stage_q(b - sh, key, src, asc);
    } else {
      const int lb = high ? b - 5 : b;         // the lane bit
      shfl_stage_m(key, src, asc, 1 << lb, (lane & (1 << lb)) == 0);
    }
  }
  if (high) relayout(tile, key, src, lane, warp, false);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = elem_a(lane, warp, s);
    if (i < len) {
      pairs[i] = make_uint2(key[s], src[s]);
      if (p.last) p.key_out[base + i] = key[s];
    }
  }
}

// A device-memory group of substages with j >= kTile, D distinct j bits:
// a group of 2^D elements connected by those bits, 16 / 2^D groups a
// thread (16 elements, their loads in flight together); group q of the
// batch starts at q with a zero inserted at each j bit, which keeps the row
// in the bits above n.
template <int D>
__global__ void device_pass(Pass p, DevGroup grp) {
  constexpr int NS = 1 << D;                   // elements of a group
  constexpr int U = kSlots / NS;               // groups of a thread
  const long long nthreads = p.total / kSlots;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= nthreads) return;
  int bm[D];                                   // the j bits
#pragma unroll
  for (int d = 0; d < D; ++d) bm[d] = 1 << grp.bit[d];
  long long g0[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    long long q = t + u * nthreads;
#pragma unroll
    for (int d = 0; d < D; ++d) {              // a zero at each j bit
      const long long lo = q & (bm[d] - 1);
      q = lo | ((q ^ lo) << 1);
    }
    g0[u] = q;
  }
  auto at = [&](int s) {                       // element of slot s
    long long g = g0[s >> D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (s & (1 << d)) g |= bm[d];
    return g;
  };
  const int nm = p.n - 1;
  uint32_t key[kSlots], src[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (p.first) {
      key[s] = p.key_in[at(s)];
      src[s] = static_cast<uint32_t>(at(s)) & nm;
    } else {
      const uint2 v = p.pairs[at(s)];
      key[s] = v.x;
      src[s] = v.y;
    }
  }
  for (int m = 0; m < grp.m; ++m) {
    // slot s = u << D | s': ascending where group u's base and the j bits
    // of s' miss k
    const int kk = grp.k[m] & nm;
    int x = 0;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (kk & bm[d]) x |= 1 << d;
    const uint32_t free = free_slots(x);
    uint32_t asc = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if ((static_cast<int>(g0[u]) & kk) == 0)
        asc |= free & (((1u << NS) - 1u) << (u * NS));
    reg_stage_q(grp.q[m], key, src, asc);
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    p.pairs[at(s)] = make_uint2(key[s], src[s]);
    if (p.last) p.key_out[at(s)] = key[s];
  }
}

// rec[i] = (op_0[i], ..., op_{nops-1}[i], 0...): R words an element, R = 4
// or 8 >= nops, so one element's operands sit in one aligned 16- or
// 32-byte record: a random source then costs one sector, not one a
// 4-byte operand.
template <int R>
__global__ void interleave(OpPtrs ops, int nops, uint4* __restrict__ rec,
                           long long total) {
  const long long gid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (gid >= total) return;
  uint32_t v[R];
#pragma unroll
  for (int o = 0; o < R; ++o) v[o] = o < nops ? __ldg(ops.in[o] + gid) : 0u;
#pragma unroll
  for (int w = 0; w < R / 4; ++w)
    rec[gid * (R / 4) + w] = make_uint4(v[4 * w], v[4 * w + 1], v[4 * w + 2],
                                        v[4 * w + 3]);
}

// op_out[o][b, i] = rec[b, src[b, i]][o]: one record read a source.
template <int R>
__global__ void gather_records(const uint2* __restrict__ pairs,
                               const uint4* __restrict__ rec, OpPtrs ops,
                               int nops, long long total, int n) {
  const long long gid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (gid >= total) return;
  const long long from = gid - gid % n + pairs[gid].y;
  uint32_t v[R];
#pragma unroll
  for (int w = 0; w < R / 4; ++w) {
    const uint4 x = rec[from * (R / 4) + w];
    v[4 * w] = x.x;
    v[4 * w + 1] = x.y;
    v[4 * w + 2] = x.z;
    v[4 * w + 3] = x.w;
  }
#pragma unroll
  for (int o = 0; o < R; ++o)
    if (o < nops) ops.out[o][gid] = v[o];
}

inline unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

int launch_device(int D, const Pass& p, const DevGroup& g, cudaStream_t s) {
  const unsigned grid = grid_for(p.total / kSlots);
  switch (D) {
    case 1: device_pass<1><<<grid, kThreads, 0, s>>>(p, g); break;
    case 2: device_pass<2><<<grid, kThreads, 0, s>>>(p, g); break;
    case 3: device_pass<3><<<grid, kThreads, 0, s>>>(p, g); break;
    case 4: device_pass<4><<<grid, kThreads, 0, s>>>(p, g); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

OpPtrs op_chunk(const void* const* ins, void* const* outs, int o0, int m) {
  OpPtrs ops{};
  for (int o = 0; o < m; ++o) {
    ops.in[o] = static_cast<const uint32_t*>(ins[o0 + o]);
    ops.out[o] = static_cast<uint32_t*>(outs[o0 + o]);
  }
  return ops;
}

}  // namespace

extern "C" {

// key_in, key_out: (B, n) u32; op_in / op_out: host arrays of nops device
// pointers to (B, n) u32; pairs: (B, n) 8-byte scratch; stages: host array
// of nstages (j, k) pairs, each j a power of two below n, n a power of two;
// plan: host array of ngroups (kind, first, count) triples that cover the
// stages in order, kind 0 a tile group (every j < 16,384, count <= 128),
// kind 1 a device-memory group (every j >= 16,384, count <= 4); rec: (B, n)
// 32-byte scratch (unused without operands).
int flate_bitonic(const void* key_in, const void* op_in, const void* op_out,
                  int nops, void* key_out, void* pairs, void* rec, int B,
                  int n, const void* stages, int nstages, const void* plan,
                  int ngroups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const* ins = static_cast<const void* const*>(op_in);
  void* const* outs = static_cast<void* const*>(op_out);
  const int* st = static_cast<const int*>(stages);
  const int* pl = static_cast<const int*>(plan);
  const long long total = static_cast<long long>(B) * n;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const size_t row_bytes = static_cast<size_t>(total) * sizeof(uint32_t);
  if (ngroups == 0) {
    if (nstages != 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaMemcpyAsync(key_out, key_in, row_bytes, cudaMemcpyDeviceToDevice, s);
    for (int o = 0; o < nops; ++o)
      cudaMemcpyAsync(outs[o], ins[o], row_bytes, cudaMemcpyDeviceToDevice, s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(kTile) * sizeof(uint2);
  // set on every call: the attribute belongs to the current device's context
  int rc = static_cast<int>(cudaFuncSetAttribute(
      tile_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  Pass p{};
  p.key_in = static_cast<const uint32_t*>(key_in);
  p.pairs = static_cast<uint2*>(pairs);
  p.key_out = static_cast<uint32_t*>(key_out);
  p.total = total;
  p.n = n;
  int covered = 0;
  for (int gi = 0; gi < ngroups; ++gi) {
    const int kind = pl[3 * gi], at = pl[3 * gi + 1], cnt = pl[3 * gi + 2];
    if (at != covered || cnt < 1 || at + cnt > nstages)
      return static_cast<int>(cudaErrorInvalidValue);
    covered += cnt;
    p.first = gi == 0;
    p.last = gi == ngroups - 1;
    if (kind == 0) {
      if (cnt > kRunMax) return static_cast<int>(cudaErrorInvalidValue);
      StageRun run;
      for (int t = 0; t < cnt; ++t) {
        run.j[t] = st[2 * (at + t)];
        run.k[t] = st[2 * (at + t) + 1];
        if (run.j[t] >= kTile) return static_cast<int>(cudaErrorInvalidValue);
      }
      const unsigned tiles = static_cast<unsigned>((total + kTile - 1) / kTile);
      tile_pass<<<tiles, kTileThreads, smem, s>>>(p, run, cnt);
      rc = static_cast<int>(cudaGetLastError());
    } else {
      if (cnt > kDevMax) return static_cast<int>(cudaErrorInvalidValue);
      DevGroup g{};
      g.m = cnt;
      int mask = 0;
      for (int t = 0; t < cnt; ++t) {
        const int j = st[2 * (at + t)];
        if (j < kTile || j >= n) return static_cast<int>(cudaErrorInvalidValue);
        mask |= j;
        g.k[t] = st[2 * (at + t) + 1];
      }
      int D = 0;
      for (int b = 0; b < 31; ++b)
        if (mask & (1 << b)) g.bit[D++] = b;
      for (int t = 0; t < cnt; ++t) {
        const int b = __builtin_ctz(st[2 * (at + t)]);
        for (int d = 0; d < D; ++d)
          if (g.bit[d] == b) g.q[t] = d;
      }
      rc = launch_device(D, p, g, s);
    }
    if (rc != 0) return rc;
  }
  if (covered != nstages) return static_cast<int>(cudaErrorInvalidValue);
  uint4* r4 = static_cast<uint4*>(rec);
  for (int o0 = 0; o0 < nops; o0 += kOpsMax) {
    const int m = nops - o0 < kOpsMax ? nops - o0 : kOpsMax;
    const OpPtrs ops = op_chunk(ins, outs, o0, m);
    const unsigned grid = grid_for(total);
    if (m <= 4) {
      interleave<4><<<grid, kThreads, 0, s>>>(ops, m, r4, total);
      gather_records<4><<<grid, kThreads, 0, s>>>(p.pairs, r4, ops, m, total, n);
    } else {
      interleave<8><<<grid, kThreads, 0, s>>>(ops, m, r4, total);
      gather_records<8><<<grid, kThreads, 0, s>>>(p.pairs, r4, ops, m, total, n);
    }
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

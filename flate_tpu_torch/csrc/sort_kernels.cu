// Hand-written Hopper (sm_90a) kernel of the bitonic sort probe (B10).
//
// Replaces tools/bitonic_probe.py:_kernel (via run): per row of n = 2^18
// u32 elements, a list of bitonic compare-exchange substages (j, k) over a
// key and NOPS-1 carried operands.  The rule is per element, not per pair:
// element i takes its partner i^j's key and operands where
//
//     (key[i^j] < key[i]) == ((i & j) == 0) == ((i & k) == 0)
//
// (unsigned compare).  With equal keys one element of a pair copies the
// other's operands and the other keeps its own, so operands are duplicated,
// not swapped; the kernel keeps that rule exactly.
//
// Design.  Every operand follows the same decisions, and those depend on the
// keys alone, so the network runs on (key, source index) pairs and each
// operand is gathered once at the end: op_out[i] = op_in[src[i]].  `src` is a
// map, not a permutation, so duplicates survive.  Runs of substages with
// j < kTile stay inside one aligned tile of kTile elements: they run fused in
// one pass per run, the tile's keys and indices in shared memory (32 KiB).
// A substage with j >= kTile is one in-place pass over device memory, one
// thread per pair.  The TPU kernel keeps the whole row resident in VMEM;
// a row's 2 MiB of key + index exceeds a block's 227 KB of shared memory.
//
// Bound: bytes — each array read once and written once (9 x 2 x 4 bytes an
// element at NOPS = 9); a full 2^18 network here makes 28 passes over the
// 8-byte (key, index) pairs (7 tile passes that hold 150 of the 171
// substages, 21 single substages in device memory) and one gather, so it is
// far from that bound.
// Fewer global passes (larger tiles, a cluster's distributed shared memory,
// TMA) are later work.
//
// Interface: plain C (ctypes), launches on the caller's stream and returns
// cudaGetLastError().  Buffers are allocated and checked by the wrapper
// (flate_tpu_torch/device/bitonic.py).  u32 values travel in 32-bit buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;        // elements a block sorts in shared memory
constexpr int kTileThreads = 512;  // kTile / 2 pairs, 4 a thread
constexpr int kThreads = 256;
constexpr int kRunMax = 128;       // substages of one fused run (kernel parameter)
constexpr int kOpsMax = 16;        // operands of one gather launch

struct StageRun {
  int j[kRunMax];
  int k[kRunMax];
};

struct OpPtrs {
  const uint32_t* in[kOpsMax];
  uint32_t* out[kOpsMax];
};

// Lower element of pair p for partner distance j (a power of two): insert
// a zero bit at j's position.
__device__ __forceinline__ int pair_lo(int p, int j) {
  return (p & (j - 1)) | ((p & ~(j - 1)) << 1);
}

// One compare-exchange of the pair (lo, hi = lo | j) at row index lo, the
// probe's rule applied to each element on its own.  Returns the new
// (key, src) of both through the references.
__device__ __forceinline__ void exchange(uint32_t& klo, int& slo, uint32_t& khi,
                                         int& shi, int lo, int j, int k) {
  const bool asc_lo = (lo & k) == 0;
  const bool asc_hi = ((lo | j) & k) == 0;
  // element lo: up is true, so it takes hi's where (khi < klo) == asc_lo
  const bool take_lo = (khi < klo) == asc_lo;
  // element hi: up is false, so it takes lo's where (klo < khi) != asc_hi
  const bool take_hi = (klo < khi) != asc_hi;
  const uint32_t k0 = klo, k1 = khi;
  const int s0 = slo, s1 = shi;
  klo = take_lo ? k1 : k0;
  slo = take_lo ? s1 : s0;
  khi = take_hi ? k0 : k1;
  shi = take_hi ? s0 : s1;
}

// A run of substages, all with j < tile, fused in shared memory.  One block
// per aligned tile of a row; `init` reads the input keys and starts the
// index map at the identity.
__global__ void tile_pass(const uint32_t* __restrict__ key_in,
                          uint32_t* __restrict__ key, int* __restrict__ src,
                          int n, int tile, StageRun run, int nrun, bool init) {
  extern __shared__ uint32_t smem[];
  uint32_t* sk = smem;
  int* ss = reinterpret_cast<int*>(smem + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const int row_base = static_cast<int>(base % n);   // tile offset in its row
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = init ? key_in[base + t] : key[base + t];
    ss[t] = init ? row_base + t : src[base + t];
  }
  __syncthreads();
  for (int s = 0; s < nrun; ++s) {
    const int j = run.j[s], k = run.k[s];
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int lo = pair_lo(p, j);
      const int hi = lo | j;
      uint32_t klo = sk[lo], khi = sk[hi];
      int slo = ss[lo], shi = ss[hi];
      exchange(klo, slo, khi, shi, row_base + lo, j, k);
      sk[lo] = klo; ss[lo] = slo;
      sk[hi] = khi; ss[hi] = shi;
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    key[base + t] = sk[t];
    src[base + t] = ss[t];
  }
}

// One substage over device memory, in place, one thread per pair.
__global__ void global_pass(const uint32_t* __restrict__ key_in,
                            uint32_t* __restrict__ key, int* __restrict__ src,
                            int B, int n, int j, int k, bool init) {
  const long long pairs = static_cast<long long>(B) * (n / 2);
  const long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= pairs) return;
  const long long b = gid / (n / 2);
  const int lo = pair_lo(static_cast<int>(gid % (n / 2)), j);
  const int hi = lo | j;
  const long long r = b * n;
  uint32_t klo = init ? key_in[r + lo] : key[r + lo];
  uint32_t khi = init ? key_in[r + hi] : key[r + hi];
  int slo = init ? lo : src[r + lo];
  int shi = init ? hi : src[r + hi];
  exchange(klo, slo, khi, shi, lo, j, k);
  key[r + lo] = klo; src[r + lo] = slo;
  key[r + hi] = khi; src[r + hi] = shi;
}

// op_out[b, i] = op_in[b, src[b, i]] for up to kOpsMax operands; src is
// read once for all of them.
__global__ void gather_ops(const int* __restrict__ src, OpPtrs ops, int nops,
                           long long total, int n) {
  const long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= total) return;
  const long long from = gid - gid % n + src[gid];
  for (int o = 0; o < nops; ++o) ops.out[o][gid] = ops.in[o][from];
}

inline unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// key_in, key_out: (B, n) u32; op_in / op_out: host arrays of nops device
// pointers to (B, n) u32; src: (B, n) int32 scratch; stages: host array of
// nstages (j, k) pairs, each j a power of two below n; n a power of two.
int flate_bitonic(const void* key_in, const void* op_in, const void* op_out,
                  int nops, void* key_out, void* src, int B, int n,
                  const void* stages, int nstages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* kin = static_cast<const uint32_t*>(key_in);
  uint32_t* key = static_cast<uint32_t*>(key_out);
  int* idx = static_cast<int*>(src);
  const void* const* ins = static_cast<const void* const*>(op_in);
  void* const* outs = static_cast<void* const*>(op_out);
  const int* st = static_cast<const int*>(stages);
  const long long total = static_cast<long long>(B) * n;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const size_t row_bytes = static_cast<size_t>(total) * sizeof(uint32_t);
  if (nstages == 0) {
    cudaMemcpyAsync(key, kin, row_bytes, cudaMemcpyDeviceToDevice, s);
    for (int o = 0; o < nops; ++o)
      cudaMemcpyAsync(outs[o], ins[o], row_bytes, cudaMemcpyDeviceToDevice, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int tile = n < kTile ? n : kTile;
  const unsigned tiles = static_cast<unsigned>(total / tile);
  const size_t smem = static_cast<size_t>(tile) * 2 * sizeof(uint32_t);
  bool init = true;
  int i = 0;
  while (i < nstages) {
    if (st[2 * i] >= tile) {
      global_pass<<<grid_for(total / 2), kThreads, 0, s>>>(
          kin, key, idx, B, n, st[2 * i], st[2 * i + 1], init);
      ++i;
    } else {
      StageRun run;
      int nrun = 0;
      while (i < nstages && st[2 * i] < tile && nrun < kRunMax) {
        run.j[nrun] = st[2 * i];
        run.k[nrun] = st[2 * i + 1];
        ++nrun;
        ++i;
      }
      tile_pass<<<tiles, kTileThreads, smem, s>>>(kin, key, idx, n, tile, run,
                                                   nrun, init);
    }
    init = false;
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  for (int o0 = 0; o0 < nops; o0 += kOpsMax) {
    OpPtrs ops;
    const int m = nops - o0 < kOpsMax ? nops - o0 : kOpsMax;
    for (int o = 0; o < m; ++o) {
      ops.in[o] = static_cast<const uint32_t*>(ins[o0 + o]);
      ops.out[o] = static_cast<uint32_t*>(outs[o0 + o]);
    }
    gather_ops<<<grid_for(total), kThreads, 0, s>>>(idx, ops, m, total, n);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Pair overlap analysis for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces fqtool_tpu/ops/pallas_overlap2.py::analyze_pallas2 (the Pallas
// TPU kernel) and computes what fqtool_tpu/ops/overlap.py::analyze computes
// (reference: src/overlapanalysis.cpp:7-72): read1 is compared with the
// reverse complement of read2 at every offset in reference order -- phase 1
// o = 0 .. rlen1-require-1, then phase 2 o = 0, -1, .. down to
// require-rlen2+1 -- and the first offset whose mismatch count over the first
// 50 compared bases is below diff_limit wins (the collapsed predicate
// "d50 < limit", proven equivalent to the reference's early-exit loop in
// fqtool_tpu/ops/overlap.py).  Outputs per pair: overlapped, offset,
// overlap_len and diff (the full mismatch count at the chosen offset).
//
// Design: one warp per pair.  Read1 and revcomp(read2) are staged in shared
// memory (revcomp computed on the fly while staging); the 32 lanes take 32
// consecutive offsets in reference order, each counts its own mismatches
// over up to 50 bases, and __ballot_sync + __ffs pick the first accepted
// offset of the group.  The scan stops at the first hit, and the full diff
// is then counted once, warp-parallel, at that offset.
//
// What bounds it: integer compares and warp divergence, not bytes -- a
// 2x151 bp pair is ~300 bytes of input for up to ~240 offsets x 50 compares.
// Packing 4 bases per 32-bit word and comparing with __vcmpeq4/__popc is
// left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCompareRequire = 50;  // overlapanalysis.cpp:14
constexpr int kMaxWarpsPerBlock = 8;

__device__ __forceinline__ uint8_t complement(uint8_t c) {
  switch (c) {
    case 'A': case 'a': return 'T';
    case 'T': case 't': return 'A';
    case 'C': case 'c': return 'G';
    case 'G': case 'g': return 'C';
    default: return 'N';
  }
}

// Mismatches between a[i] and b[i] for i < n, stopping once `limit` is
// reached (the caller only asks whether the count is below the limit).
__device__ __forceinline__ int mismatches_capped(const uint8_t* a,
                                                 const uint8_t* b, int n,
                                                 int limit) {
  int d = 0;
  for (int i = 0; i < n && d < limit; ++i) d += (a[i] != b[i]);
  return d;
}

// First accepted offset k in [0, count) of one phase, or -1.  At offset k the
// compared spans are x[k*kx + i] vs y[k*ky + i] for i < min(ol(k), 50),
// where ol(k) = min(nx - k, ny) in phase 1 and min(nx, ny - k) in phase 2;
// the phases differ only in which operand moves.
__device__ int scan_phase(const uint8_t* s1, const uint8_t* rs2, int n1, int n2,
                          int count, bool phase1, int diff_limit, int lane) {
  for (int base = 0; base < count; base += 32) {
    const int k = base + lane;
    bool hit = false;
    if (k < count) {
      int ol, d;
      if (phase1) {
        ol = min(n1 - k, n2);
        d = mismatches_capped(s1 + k, rs2, min(ol, kCompareRequire), diff_limit);
      } else {
        ol = min(n1, n2 - k);
        d = mismatches_capped(s1, rs2 + k, min(ol, kCompareRequire), diff_limit);
      }
      hit = d < diff_limit;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot) return base + __ffs(ballot) - 1;
  }
  return -1;
}

__global__ void overlap_kernel(const uint8_t* __restrict__ seq1,
                               const uint8_t* __restrict__ seq2,
                               const int32_t* __restrict__ rlen1,
                               const int32_t* __restrict__ rlen2,
                               int B, int L1, int L2, int stride1, int stride2,
                               int diff_limit, int require,
                               int32_t* __restrict__ out_found,
                               int32_t* __restrict__ out_offset,
                               int32_t* __restrict__ out_olen,
                               int32_t* __restrict__ out_diff) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // the whole warp leaves together

  uint8_t* s1 = smem + warp * (stride1 + stride2);
  uint8_t* rs2 = s1 + stride1;
  // lengths are clamped to the row widths for memory safety only: the
  // pipeline never hands out a length outside [0, L]
  const int n1 = min(max(rlen1[row], 0), L1);
  const int n2 = min(max(rlen2[row], 0), L2);
  const uint8_t* r1 = seq1 + (size_t)row * L1;
  const uint8_t* r2 = seq2 + (size_t)row * L2;
  for (int i = lane; i < n1; i += 32) s1[i] = r1[i];
  for (int i = lane; i < n2; i += 32) rs2[i] = complement(r2[n2 - 1 - i]);
  __syncwarp();

  // phase 1: offsets o with o < rlen1 - require (overlapanalysis.cpp:18-42);
  // phase 2 re-tests o = 0 under its own validity j < rlen2 - require
  int offset = 0;
  bool found = false;
  int k = scan_phase(s1, rs2, n1, n2, max(n1 - require, 0), true,
                     diff_limit, lane);
  if (k >= 0) {
    offset = k;
    found = true;
  } else {
    k = scan_phase(s1, rs2, n1, n2, max(n2 - require, 0), false,
                   diff_limit, lane);
    if (k >= 0) {
      offset = -k;
      found = true;
    }
  }

  int ol = 0, diff = 0;
  if (found) {
    const int a = max(offset, 0), b = max(-offset, 0);
    ol = offset >= 0 ? min(n1 - a, n2) : min(n1, n2 - b);
    for (int i = lane; i < ol; i += 32) diff += (s1[a + i] != rs2[b + i]);
    diff = __reduce_add_sync(0xffffffffu, diff);
  }
  if (lane == 0) {
    out_found[row] = found ? 1 : 0;
    out_offset[row] = found ? offset : 0;
    out_olen[row] = ol;
    out_diff[row] = diff;
  }
}

}  // namespace

// Launches the kernel on `stream` over B pairs of uint8 rows (row-major,
// contiguous, widths L1 and L2) and int32 lengths; writes four int32 [B]
// outputs.  Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue when even one warp's staging does not fit in shared
// memory.
extern "C" int fq_overlap_launch(const void* seq1, const void* seq2,
                                 const void* rlen1, const void* rlen2,
                                 int B, int L1, int L2,
                                 int diff_limit, int require,
                                 void* found, void* offset, void* olen,
                                 void* diff, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int stride1 = (L1 + 15) & ~15;
  const int stride2 = (L2 + 15) & ~15;
  const size_t per_warp = (size_t)stride1 + stride2;
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t budget = 48 * 1024;
  int warps = (int)(budget / per_warp);
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (warps < 1) warps = 1;
  const size_t smem = per_warp * warps;
  if (smem > (size_t)max_optin) return cudaErrorInvalidValue;
  if (smem > budget) {
    cudaError_t e = cudaFuncSetAttribute(
        overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + warps - 1) / warps;
  overlap_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)seq1, (const uint8_t*)seq2, (const int32_t*)rlen1,
      (const int32_t*)rlen2, B, L1, L2, stride1, stride2, diff_limit, require,
      (int32_t*)found, (int32_t*)offset, (int32_t*)olen, (int32_t*)diff);
  return cudaGetLastError();
}

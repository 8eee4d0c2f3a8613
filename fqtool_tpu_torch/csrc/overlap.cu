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
// fqtool_tpu/ops/overlap.py).  Outputs per pair: overlapped (a bool plane),
// then offset, overlap_len and diff (the full mismatch count at the chosen
// offset) as the rows of one int32 [3, B] plane.  Bases compare as raw
// bytes; the complement maps A/a->T, T/t->A, C/c->G, G/g->C, anything
// else -> N.
//
// What bounds it: bytes.  A 16,384-pair chunk of 2 x 151 bp in planes 152
// wide reads 5.0 MB of bases and 0.13 MB of lengths and writes 0.2 MB, about
// 1.6 us at 3.35 TB/s.  The byte compares that the scan order needs on such
// pairs (~6,300 a pair), at four per 32-bit op, take about as long at the
// card's int32 rate: the compare loop has to test several bases per
// instruction with every lane busy, and staging has to keep the loads of
// many pairs in flight, to come near the bound.
//
// Design: one warp per pair, both reads staged in shared memory; each warp
// walks pairs with the grid's stride, and the grid holds as many blocks as
// the card runs at once.
// - Vector staging: rows load as 8-byte words where the row width and both
//   planes' addresses allow (the kernel is instantiated per load width),
//   bytewise otherwise.  A pair's lengths and the first chunk of
//   both reads are loaded together, one pair ahead of the pair the warp
//   works on, so the round trip to memory overlaps the previous pair's
//   scan.  Shared memory past each length is zeroed.
// - Base codes: revcomp(read2) holds only A, C, G, T and N, so a byte of
//   read1 can equal it only if it is one of those five.  Each base is staged
//   as a 4-bit code (A C G T N = 0..4, any other byte of read1 = 5), which
//   keeps byte equality exact and puts 8 bases in a 32-bit word.  Read2 is
//   reversed and complemented in the same pass, through 256-entry shared
//   tables (no branch per byte).
// - Word-wise, branch-free window: the 32 lanes take 32 consecutive offsets;
//   each builds its unaligned window from two aligned shared-memory words
//   with __funnelshift_r, finds the differing bases of 8 at once (the
//   nonzero nibbles of a ^ b) and counts them with __popc, over 7 words at a
//   fixed trip count, with the bases past min(overlap, 50) masked by length
//   (constant masks when every lane compares 50).  The first 50 bases of the
//   fixed operand (revcomp(read2) in phase 1, read1 in phase 2) sit in
//   registers for the whole phase.  No lane leaves early: after 16 and 32
//   bases the warp stops the group only once no lane can still be under the
//   limit, so a group of 32 offsets costs the same in every lane.
//   __ballot_sync + __ffs pick the group's first accepted offset, and the
//   scan stops at the first group with one.  Phase 2 re-tests offset 0.
// - The full diff at the chosen offset is counted 8 bases a word by the warp
//   and reduced with __reduce_add_sync.
// - Launch: the SM count, the shared-memory opt-in and the blocks an SM
//   holds are read at most once per device, load width and shape, not on
//   every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCompareRequire = 50;  // overlapanalysis.cpp:14
constexpr int kBasesPerWord = 8;     // 4-bit codes
constexpr int kWindowWords = (kCompareRequire + kBasesPerWord - 1) / kBasesPerWord;
constexpr int kWarpsPerBlock = 8;
// code words past each read: a window of kWindowWords + 1 words starting at
// its last data word stays inside
constexpr int kPadWords = kWindowWords + 1;
// zeroed words ahead of the raw read2, so that reversed windows never index
// below the row
constexpr int kLeadWords = 4;
constexpr int kTableBytes = 2 * 256;
constexpr int kMaxDevices = 64;
constexpr uint32_t kHighBits = 0x88888888u;  // bit 3 of each code

// The 4-bit code of a read1 byte: A C G T N = 0..4, any other byte 5 (which
// no code of revcomp(read2) has).
__device__ __forceinline__ uint8_t code_of(int c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    case 'N': return 4;
    default: return 5;
  }
}

// The code of the complement of a read2 byte: A/a->T, T/t->A, C/c->G,
// G/g->C, anything else -> N.
__device__ __forceinline__ uint8_t complement_code(int c) {
  switch (c) {
    case 'A': case 'a': return 3;
    case 'T': case 't': return 0;
    case 'C': case 'c': return 2;
    case 'G': case 'g': return 1;
    default: return 4;
  }
}

// The low `valid` bytes of a word (none for valid <= 0, all for valid >= 4).
__device__ __forceinline__ uint32_t byte_mask(int valid) {
  return valid >= 4 ? 0xffffffffu
                    : (valid <= 0 ? 0u : (1u << (8 * valid)) - 1u);
}

// The low `valid` codes of a word (none for valid <= 0, all for valid >= 8).
__device__ __forceinline__ uint32_t code_mask(int valid) {
  return valid >= 8 ? 0xffffffffu
                    : (valid <= 0 ? 0u : (1u << (4 * valid)) - 1u);
}

// Bit 3 of each code set where the codes of a and b differ: the nonzero
// nibbles of a ^ b, found without carries between nibbles.
__device__ __forceinline__ uint32_t mismatch_bits(uint32_t a, uint32_t b) {
  const uint32_t t = a ^ b;
  return (((t & 0x77777777u) + 0x77777777u) | t) & kHighBits;
}

// Bytes k .. k+3 of the word array w.
__device__ __forceinline__ uint32_t bytes_at(const uint32_t* w, int k) {
  return __funnelshift_r(w[k >> 2], w[(k >> 2) + 1], 8 * (k & 3));
}

// Codes k .. k+7 of the code word array w.
__device__ __forceinline__ uint32_t codes_at(const uint32_t* w, int k) {
  return __funnelshift_r(w[k >> 3], w[(k >> 3) + 1], 4 * (k & 7));
}

// Words per chunk of a kVec-byte load (kVec 1: 4 bytes one at a time).
template <int kVec>
constexpr int kChunkWords = kVec == 8 ? 2 : 1;

// Chunk c of a row of L bytes as up to two words: 8 bytes at once for kVec 8
// (the launcher picks it where 8 divides L and the row's address), or 4
// bytes one at a time for kVec 1; zero past the row.
template <int kVec>
__device__ __forceinline__ uint2 load_chunk(const uint8_t* __restrict__ row,
                                            int L, int c) {
  uint2 v = make_uint2(0u, 0u);
  if (kVec == 8) {
    if (8 * c < L) v = reinterpret_cast<const uint2*>(row)[c];
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (4 * c + b < L) v.x |= (uint32_t)row[4 * c + b] << (8 * b);
    }
  }
  return v;
}

// Stores chunk c at dst, bytes at or past n zeroed, words at or past nwords
// dropped.
template <int kVec>
__device__ __forceinline__ void store_chunk(uint32_t* dst, uint2 v, int c,
                                            int n, int nwords) {
  const uint32_t w2[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < kChunkWords<kVec>; ++i) {
    const int w = c * kChunkWords<kVec> + i;
    if (w < nwords) dst[w] = w2[i] & byte_mask(n - 4 * w);
  }
}

// A pair's lengths and each lane's first chunk of both reads, loaded one
// pair ahead of the one the warp works on.
struct PairLoad {
  int r1, r2;
  uint2 a, b;
};

template <int kVec>
__device__ __forceinline__ PairLoad load_pair(
    const uint8_t* __restrict__ seq1, const uint8_t* __restrict__ seq2,
    const int32_t* __restrict__ rlen1, const int32_t* __restrict__ rlen2,
    int row, int L1, int L2, int lane) {
  PairLoad p;
  p.r1 = rlen1[row];
  p.r2 = rlen2[row];
  p.a = load_chunk<kVec>(seq1 + (size_t)row * L1, L1, lane);
  p.b = load_chunk<kVec>(seq2 + (size_t)row * L2, L2, lane);
  return p;
}

// Whether this lane's offset k is accepted: mismatches over the first n
// (<= 50) bases of the moving window at code k against the fixed operand's
// first 50 codes `f`.  Every lane runs the same words; the warp stops after
// 16 and after 32 bases once no valid lane can still be under the limit.
// kFull: every lane's n is 50, so the masks are constants.
template <bool kFull>
__device__ __forceinline__ bool accepted(const uint32_t (&f)[kWindowWords],
                                         const uint32_t* moving, int k, int n,
                                         int max_q, bool valid,
                                         int diff_limit) {
  const int q = min(k >> 3, max_q);
  const int shift = 4 * (k & 7);
  uint32_t lo = moving[q];
  int d = 0;
#pragma unroll
  for (int j = 0; j < kWindowWords; ++j) {
    if (j == 2 || j == 4) {
      if (!__any_sync(0xffffffffu, valid && d < diff_limit)) return false;
    }
    const uint32_t hi = moving[q + j + 1];
    const int left = (kFull ? kCompareRequire : n) - kBasesPerWord * j;
    const uint32_t keep = code_mask(left) & kHighBits;
    d += __popc(mismatch_bits(__funnelshift_r(lo, hi, shift), f[j]) & keep);
    lo = hi;
  }
  return valid && d < diff_limit;
}

// First accepted offset k in [0, count) of one phase, or -1.  At offset k the
// moving operand's window starts at its code k and the fixed operand at its
// code 0; ol(k) = min(nm - k, nf) and the first min(ol(k), 50) bases count.
// `max_q` is the moving operand's last data word: lanes past `count` read
// clamped, in-bounds words and are masked out of the ballot.
__device__ __forceinline__ int scan_phase(const uint32_t* fixed,
                                          const uint32_t* moving, int nf,
                                          int nm, int count, int max_q,
                                          int diff_limit, int lane) {
  uint32_t f[kWindowWords];
#pragma unroll
  for (int j = 0; j < kWindowWords; ++j) f[j] = fixed[j];
  for (int base = 0; base < count; base += 32) {
    const int k = base + lane;
    const bool valid = k < count;
    // warp-uniform: whether every lane of the group compares 50 bases
    const bool full =
        nf >= kCompareRequire && nm - (base + 31) >= kCompareRequire;
    const bool hit =
        full ? accepted<true>(f, moving, k, kCompareRequire, max_q, valid,
                              diff_limit)
             : accepted<false>(f, moving, k,
                               min(min(nm - k, nf), kCompareRequire), max_q,
                               valid, diff_limit);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot) return base + __ffs(ballot) - 1;
  }
  return -1;
}

// Shared memory of one warp, in words.
struct Staging {
  uint32_t* raw1;  // read1's bytes: wl1 + 2 words
  uint32_t* raw2;  // kLeadWords zero words, then read2's bytes: wl2 + 2 words
  uint32_t* c1;    // read1's codes: cw1 + kPadWords words
  uint32_t* c2;    // revcomp(read2)'s codes: cw2 + kPadWords words
};

__host__ __device__ __forceinline__ int staging_words(int L1, int L2) {
  const int wl1 = (L1 + 3) / 4, wl2 = (L2 + 3) / 4;
  const int cw1 = (L1 + kBasesPerWord - 1) / kBasesPerWord;
  const int cw2 = (L2 + kBasesPerWord - 1) / kBasesPerWord;
  return (wl1 + 2) + (kLeadWords + wl2 + 2) + (cw1 + kPadWords)
         + (cw2 + kPadWords);
}

// One pair: stages both reads as codes (the first chunk of each lane comes
// loaded in `p`), scans both phases and writes the pair's outputs.
template <int kVec>
__device__ __forceinline__ void analyze_pair(
    const uint8_t* __restrict__ seq1, const uint8_t* __restrict__ seq2,
    const PairLoad& p, int row, int B, int L1, int L2, int diff_limit,
    int require, const uint8_t* code1, const uint8_t* rcode2,
    const Staging& sm, bool* __restrict__ out_overlapped,
    int32_t* __restrict__ out, int lane) {
  const int wl1 = (L1 + 3) >> 2, wl2 = (L2 + 3) >> 2;
  const int cw1 = (L1 + kBasesPerWord - 1) / kBasesPerWord;
  const int cw2 = (L2 + kBasesPerWord - 1) / kBasesPerWord;
  constexpr int per = kChunkWords<kVec>;
  const int chunks = (max(wl1, wl2) + 2 + per - 1) / per;
  // lengths are clamped to the row widths for memory safety only: the
  // pipeline never hands out a length outside [0, L]
  const int n1 = min(max(p.r1, 0), L1);
  const int n2 = min(max(p.r2, 0), L2);
  if (lane < kLeadWords) sm.raw2[lane] = 0u;
  store_chunk<kVec>(sm.raw1, p.a, lane, n1, wl1 + 2);
  store_chunk<kVec>(sm.raw2 + kLeadWords, p.b, lane, n2, wl2 + 2);
  for (int c = lane + 32; c < chunks; c += 32) {  // rows over 32 chunks
    store_chunk<kVec>(sm.raw1, load_chunk<kVec>(seq1 + (size_t)row * L1, L1, c),
                      c, n1, wl1 + 2);
    store_chunk<kVec>(sm.raw2 + kLeadWords,
                      load_chunk<kVec>(seq2 + (size_t)row * L2, L2, c), c, n2,
                      wl2 + 2);
  }
  __syncwarp();
  // code word w of read1: bytes 8w .. 8w+7
  for (int w = lane; w < cw1 + kPadWords; w += 32) {
    const int i = min(2 * w, wl1);
    const uint32_t lo = sm.raw1[i], hi = sm.raw1[i + 1];
    uint32_t c = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c |= (uint32_t)code1[(lo >> (8 * j)) & 0xffu] << (4 * j);
      c |= (uint32_t)code1[(hi >> (8 * j)) & 0xffu] << (4 * j + 16);
    }
    sm.c1[w] = c & code_mask(n1 - kBasesPerWord * w);
  }
  // code word w of revcomp(read2): codes 8w .. 8w+7 are the complements of
  // read2[n2-1-8w] down to read2[n2-8-8w], the 8 raw bytes from byte s
  for (int w = lane; w < cw2 + kPadWords; w += 32) {
    const int s = max(n2 - 8 - 8 * w, -4 * kLeadWords) + 4 * kLeadWords;
    const uint32_t x0 = bytes_at(sm.raw2, s), x1 = bytes_at(sm.raw2, s + 4);
    uint32_t c = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c |= (uint32_t)rcode2[(x1 >> (24 - 8 * j)) & 0xffu] << (4 * j);
      c |= (uint32_t)rcode2[(x0 >> (24 - 8 * j)) & 0xffu] << (4 * j + 16);
    }
    sm.c2[w] = c & code_mask(n2 - kBasesPerWord * w);
  }
  __syncwarp();

  // phase 1: offsets o with o < rlen1 - require (overlapanalysis.cpp:18-42),
  // read1 moving under revcomp(read2); phase 2 re-tests o = 0 under its own
  // validity j < rlen2 - require, revcomp(read2) moving under read1
  int offset = 0;
  bool found = false;
  int k = scan_phase(sm.c2, sm.c1, n2, n1, max(n1 - require, 0), cw1,
                     diff_limit, lane);
  if (k >= 0) {
    offset = k;
    found = true;
  } else {
    k = scan_phase(sm.c1, sm.c2, n1, n2, max(n2 - require, 0), cw2,
                   diff_limit, lane);
    if (k >= 0) {
      offset = -k;
      found = true;
    }
  }

  int ol = 0, diff = 0;
  if (found) {
    const int o1 = max(offset, 0), o2 = max(-offset, 0);
    ol = offset >= 0 ? min(n1 - o1, n2) : min(n1, n2 - o2);
    int bits = 0;  // one per mismatch
    for (int w = lane; kBasesPerWord * w < ol; w += 32) {
      const uint32_t x = codes_at(sm.c1, o1 + kBasesPerWord * w);
      const uint32_t y = codes_at(sm.c2, o2 + kBasesPerWord * w);
      bits += __popc(mismatch_bits(x, y) & code_mask(ol - kBasesPerWord * w));
    }
    diff = __reduce_add_sync(0xffffffffu, bits);
  }
  if (lane == 0) {
    out_overlapped[row] = found;
    out[row] = found ? offset : 0;
    out[(size_t)B + row] = ol;
    out[2 * (size_t)B + row] = diff;
  }
}

// Each warp takes pairs row, row + (warps in the grid), ... until B, and
// loads the next pair while it works on one: a warp whose pair ends early
// takes the next one, and the grid is sized to the blocks the card holds at
// once.
template <int kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
overlap_kernel(const uint8_t* __restrict__ seq1,
               const uint8_t* __restrict__ seq2,
               const int32_t* __restrict__ rlen1,
               const int32_t* __restrict__ rlen2, int B, int L1, int L2,
               int diff_limit, int require, bool* __restrict__ out_overlapped,
               int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ uint8_t tables[kTableBytes];
  uint8_t* code1 = tables;
  uint8_t* rcode2 = tables + 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    code1[i] = code_of(i);
    rcode2[i] = complement_code(i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int wl1 = (L1 + 3) >> 2, wl2 = (L2 + 3) >> 2;
  const int cw1 = (L1 + kBasesPerWord - 1) / kBasesPerWord;
  Staging sm;
  sm.raw1 = smem + (size_t)warp * staging_words(L1, L2);
  sm.raw2 = sm.raw1 + wl1 + 2;
  sm.c1 = sm.raw2 + kLeadWords + wl2 + 2;
  sm.c2 = sm.c1 + cw1 + kPadWords;
  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  if (row >= B) return;
  PairLoad cur = load_pair<kVec>(seq1, seq2, rlen1, rlen2, row, L1, L2, lane);
  for (; row < B; row += stride) {
    PairLoad next = cur;
    if (row + stride < B) {
      next = load_pair<kVec>(seq1, seq2, rlen1, rlen2, row + stride, L1, L2,
                             lane);
    }
    analyze_pair<kVec>(seq1, seq2, cur, row, B, L1, L2, diff_limit, require,
                       code1, rcode2, sm, out_overlapped, out, lane);
    __syncwarp();  // the next pair overwrites the staging
    cur = next;
  }
}

// Dynamic shared memory, blocks and threads of one launch.
struct LaunchShape {
  size_t smem;
  int blocks, threads;
};

template <int kVec>
cudaError_t launch(const LaunchShape& s, cudaStream_t stream,
                   const void* seq1, const void* seq2, const void* rlen1,
                   const void* rlen2, int B, int L1, int L2, int diff_limit,
                   int require, void* overlapped, void* out) {
  overlap_kernel<kVec><<<s.blocks, s.threads, s.smem, stream>>>(
      (const uint8_t*)seq1, (const uint8_t*)seq2, (const int32_t*)rlen1,
      (const int32_t*)rlen2, B, L1, L2, diff_limit, require,
      (bool*)overlapped, (int32_t*)out);
  return cudaGetLastError();
}

// Per device and load width, filled at first need: SM count, opt-in
// shared-memory limit, the dynamic shared memory the kernel is allowed, and
// the blocks an SM holds at the last launch's block shape.
struct KernelState {
  int sms = 0;
  int max_optin = 0;
  size_t smem_allowed = 0;
  size_t occ_smem = 0;
  int occ_warps = 0;
  int occ_blocks = 0;
};
KernelState g_state[kMaxDevices][2];  // kVec 1, 8

// The launch shape for B pairs on `device`, setting the kernel's shared
// memory opt-in where it needs one; reads the device once per state.
template <int kVec>
cudaError_t shape_for(KernelState& st, int device, int B, int L1, int L2,
                      LaunchShape* s) {
  const size_t per_warp_bytes = (size_t)staging_words(L1, L2) * 4;
  const size_t budget = 48 * 1024 - kTableBytes;
  int warps = (int)(budget / per_warp_bytes);
  if (warps > kWarpsPerBlock) warps = kWarpsPerBlock;
  if (warps < 1) warps = 1;
  s->smem = per_warp_bytes * warps;
  s->threads = warps * 32;
  cudaError_t e;
  if (st.sms == 0) {
    e = cudaDeviceGetAttribute(&st.max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  if (s->smem > budget && s->smem > st.smem_allowed) {
    if (s->smem + kTableBytes > (size_t)st.max_optin) {
      return cudaErrorInvalidValue;
    }
    e = cudaFuncSetAttribute(overlap_kernel<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s->smem);
    if (e != cudaSuccess) return e;
    st.smem_allowed = s->smem;
  }
  if (st.occ_smem != s->smem || st.occ_warps != warps) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &st.occ_blocks, overlap_kernel<kVec>, s->threads, s->smem);
    if (e != cudaSuccess) return e;
    if (st.occ_blocks < 1) st.occ_blocks = 1;
    st.occ_smem = s->smem;
    st.occ_warps = warps;
  }
  const int want = (B + warps - 1) / warps, fit = st.sms * st.occ_blocks;
  s->blocks = want < fit ? want : fit;
  return cudaSuccess;
}

template <int kVec>
cudaError_t shape_and_launch(int slot, int device, cudaStream_t stream,
                             const void* seq1, const void* seq2,
                             const void* rlen1, const void* rlen2, int B,
                             int L1, int L2, int diff_limit, int require,
                             void* overlapped, void* out) {
  LaunchShape s;
  const cudaError_t e = shape_for<kVec>(g_state[device][slot], device, B, L1,
                                        L2, &s);
  if (e != cudaSuccess) return e;
  return launch<kVec>(s, stream, seq1, seq2, rlen1, rlen2, B, L1, L2,
                      diff_limit, require, overlapped, out);
}

}  // namespace

// Launches the kernel on `stream` (of CUDA device `device`) over B pairs of
// uint8 rows (row-major, contiguous, widths L1 and L2) and int32 lengths;
// `vec1`/`vec2` are the load widths (8 or 1 bytes) that each plane's
// address and row width allow; both reads load at the narrower one.  Writes
// `overlapped` (bool [B]) and `out` (int32 [3, B]: offset, overlap_len,
// diff).  Returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue when even one warp's staging does not fit in shared
// memory.
extern "C" int fq_overlap_launch(const void* seq1, const void* seq2,
                                 const void* rlen1, const void* rlen2,
                                 int B, int L1, int L2, int vec1, int vec2,
                                 int diff_limit, int require,
                                 void* overlapped, void* out, int device,
                                 void* stream) {
  if (B <= 0) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  // one load width for both reads: the narrower of the two
  const int vec = vec1 < vec2 ? vec1 : vec2;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 8) {
    return shape_and_launch<8>(1, device, s, seq1, seq2, rlen1, rlen2, B, L1,
                               L2, diff_limit, require, overlapped, out);
  }
  return shape_and_launch<1>(0, device, s, seq1, seq2, rlen1, rlen2, B, L1, L2,
                             diff_limit, require, overlapped, out);
}

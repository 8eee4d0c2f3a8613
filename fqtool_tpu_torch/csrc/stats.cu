// Per-cycle statistics of a batch of reads for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces no TPU kernel: fqtool_tpu/ops/stats.py::stat_batch is jnp code.
// Its plain PyTorch port (fqtool_tpu_torch/ops/stats.py) stacks four int64
// [B, L] planes into [B, L, 4], masks them and scatter-adds them into an
// int64 [8L, 4] histogram: ~250 bytes of temporaries per base and ~25
// launches a call, about half of the card's time on the paired-end merge
// path.  This kernel computes the same outputs in one launch.
//
// What it computes (reference: src/stats.cpp:237-295): a base at cycle c of
// row r counts when c < rlen[r] and the row is selected, in the bin
// (seq & 7, c): content += 1, q20 += qual > '5', q30 += qual > '?',
// quality += qual - 33.  Per cycle the bin sums (total, total_qual); the
// selected rows (reads) and the sum of their rlen (length_sum).  Every
// output is int32 and every sum wraps mod 2^32, as the plain op's int64
// sums cast to int32 do; integer atomics in any order give the same bits.
// Output: one int32 buffer of 34 L + 2 words, the planes q20, q30,
// content and quality [8, L], then total and total_qual [L], reads and
// length_sum; the launcher zeroes it on the stream before the kernel.
//
// What bounds it: bytes.  A 16,384 x 152 call reads 2 x 2.5 MB, ~1.5 us at
// 3.35 TB/s; the output is a few tens of KB.
//
// Design:
// - A block covers a tile of up to kTileCols cycles of a stripe of rows:
//   grid.x the stripes, grid.y the tiles (one for L <= kTileCols).  About
//   kBlocksPerSm blocks an SM, but at least kMinRows and at most kMaxRows
//   rows a stripe.
// - Loads: consecutive threads take consecutive V-byte vectors of a row's
//   tile, V = 16, 8 or 1, the widest that the row width and both planes'
//   addresses allow (one instantiation each), so a warp reads contiguous
//   bytes; each byte of seq and qual is read once.  The port's planes are a
//   multiple of 8 wide, and a merged plane (two of them) often of 16: at
//   16,384 x 304, 16-byte loads take 10.8 us and 8-byte ones 11.9.
// - Counts stay on chip: the block's histogram is in shared memory, two
//   words a bin, content | q20 << 10 | q30 << 20 (no field overflows: a
//   stripe has at most 1023 rows) and the raw quality sum; shared atomics,
//   since threads on other rows can hit the same bin.  The bin of cycle c
//   sits at word c + c / V of its row, so the 32 threads of a warp, at
//   cycles V t + j, hit 32 banks.
// - The stripe's counted lengths (rlen where selected, else 0) are staged in
//   shared memory; the blocks of the first tile add the stripe's reads and
//   length sum to the output.
// - Flush: one thread a cycle adds its non-empty bins' four counters and the
//   cycle's two totals to the output with global atomics, once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileCols = 384;   // keeps the block's shared memory < 48 KB
constexpr int kMaxRows = 1023;   // the 10-bit fields of a bin's counts
constexpr int kMinRows = 64;
constexpr int kBlocksPerSm = 1;
constexpr int kBins = 8;         // seq & 7
constexpr int kFieldBits = 10;
constexpr uint32_t kFieldMask = (1u << kFieldBits) - 1;
constexpr uint32_t kQ20Char = '5';  // stats.cpp:250, strict >
constexpr uint32_t kQ30Char = '?';  // stats.cpp:251, strict >
constexpr int kMaxDevices = 64;

template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<1> { using T = uint8_t; };

template <int V>
union Bytes {
  typename Vec<V>::T v;
  uint8_t b[V];
};

// Shared-memory word of tile cycle c in a bin row: a pad word every V cycles.
template <int V>
__device__ __forceinline__ int word_of(int c) {
  return V > 1 ? c + c / V : c;
}

// Words of one bin row for a tile of w cycles, rounded up to 32 banks.
__host__ __device__ inline int row_words(int w, int v) {
  const int words = v > 1 ? w + (w - 1) / v : w;
  return (words + 31) / 32 * 32;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
stat_batch_kernel(const uint8_t* __restrict__ seq,
                  const uint8_t* __restrict__ qual,
                  const int32_t* __restrict__ rlen,
                  const uint8_t* __restrict__ select, int B, int L, int rows,
                  uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int c0 = blockIdx.y * kTileCols;
  const int w = min(kTileCols, L - c0);
  const int stride = row_words(w, V);
  uint32_t* counts = smem;                  // [kBins][stride]
  uint32_t* qsums = smem + kBins * stride;  // [kBins][stride]
  int32_t* lens = reinterpret_cast<int32_t*>(qsums + kBins * stride);
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);
  const int tid = threadIdx.x;

  for (int i = tid; i < kBins * stride; i += kThreads) {
    counts[i] = 0;
    qsums[i] = 0;
  }
  uint32_t nsel = 0, lsum = 0;
  for (int r = tid; r < nr; r += kThreads) {
    const int32_t len = rlen[r0 + r];
    const bool on = select == nullptr || select[r0 + r];
    lens[r] = on && len > 0 ? len : 0;
    nsel += on;
    lsum += on ? (uint32_t)len : 0u;
  }
  if (blockIdx.y == 0) {
    nsel = __reduce_add_sync(0xffffffffu, nsel);
    lsum = __reduce_add_sync(0xffffffffu, lsum);
    if ((tid & 31) == 0 && nsel != 0) {
      atomicAdd(out + 34 * (size_t)L, nsel);
      atomicAdd(out + 34 * (size_t)L + 1, lsum);
    }
  }
  __syncthreads();

  // vector v of row r, then the thread kThreads vectors further on
  const int nvec = w / V;  // L and kTileCols are multiples of V
  const int dr = kThreads / nvec, dv = kThreads % nvec;
  int r = tid / nvec, v = tid % nvec;
  const uint8_t* seq0 = seq + (size_t)r0 * L + c0;
  const uint8_t* qual0 = qual + (size_t)r0 * L + c0;
  while (r < nr) {
    const size_t off = (size_t)r * L + (size_t)v * V;
    Bytes<V> s, q;
    s.v = __ldg(reinterpret_cast<const typename Vec<V>::T*>(seq0 + off));
    q.v = __ldg(reinterpret_cast<const typename Vec<V>::T*>(qual0 + off));
    const int left = lens[r] - c0 - v * V;  // bases j < left count
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < left) {
        const uint32_t qj = q.b[j];
        const int k = (s.b[j] & 7) * stride + word_of<V>(v * V + j);
        atomicAdd(counts + k, 1u | (uint32_t)(qj > kQ20Char) << kFieldBits
                                  | (uint32_t)(qj > kQ30Char) << (2 * kFieldBits));
        atomicAdd(qsums + k, qj);
      }
    }
    r += dr;
    v += dv;
    if (v >= nvec) {
      v -= nvec;
      ++r;
    }
  }
  __syncthreads();

  uint32_t* q20 = out;
  uint32_t* q30 = out + kBins * (size_t)L;
  uint32_t* content = out + 2 * kBins * (size_t)L;
  uint32_t* quality = out + 3 * kBins * (size_t)L;
  uint32_t* total = out + 4 * kBins * (size_t)L;
  uint32_t* total_qual = total + L;
  for (int c = tid; c < w; c += kThreads) {
    uint32_t tot = 0, tot_qual = 0;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const int k = b * stride + word_of<V>(c);
      const uint32_t n = counts[k];
      if (n == 0) continue;  // no base: all four counters are 0
      const uint32_t cnt = n & kFieldMask;
      const uint32_t qsum = qsums[k] - 33u * cnt;
      const size_t at = (size_t)b * L + c0 + c;
      atomicAdd(content + at, cnt);
      atomicAdd(q20 + at, (n >> kFieldBits) & kFieldMask);
      atomicAdd(q30 + at, n >> (2 * kFieldBits));
      atomicAdd(quality + at, qsum);
      tot += cnt;
      tot_qual += qsum;
    }
    if (tot != 0) {
      atomicAdd(total + c0 + c, tot);
      atomicAdd(total_qual + c0 + c, tot_qual);
    }
  }
}

int g_sms[kMaxDevices];  // SM count per device, read at first need

template <int V>
cudaError_t launch(int device, cudaStream_t stream, const void* seq,
                   const void* qual, const void* rlen, const void* select,
                   int B, int L, void* out) {
  const int tiles = (L + kTileCols - 1) / kTileCols;
  if (tiles > 65535) return cudaErrorInvalidValue;
  if (g_sms[device] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const int want = (kBlocksPerSm * g_sms[device] + tiles - 1) / tiles;
  int rows = (B + want - 1) / want;
  rows = rows < kMinRows ? kMinRows : rows > kMaxRows ? kMaxRows : rows;
  const int stripes = (B + rows - 1) / rows;
  const int w = L < kTileCols ? L : kTileCols;
  const size_t smem = (2 * kBins * (size_t)row_words(w, V) + rows) * 4;
  stat_batch_kernel<V><<<dim3(stripes, tiles), kThreads, smem, stream>>>(
      (const uint8_t*)seq, (const uint8_t*)qual, (const int32_t*)rlen,
      (const uint8_t*)select, B, L, rows, (uint32_t*)out);
  return cudaGetLastError();
}

}  // namespace

// Zeroes `out` (int32, 34 L + 2 words) and launches the kernel on `stream`
// (of CUDA device `device`, made current for the call if it is not) over B
// rows of uint8 seq and qual (row-major, contiguous, width L >= 1), int32
// rlen [B] and bool select [B] (null: every row); `vec` is the load width
// in bytes (16, 8 or 1) that L and both planes' addresses allow.
// Returns the first CUDA error of the memset and the launch (0 = success).
extern "C" int fq_stat_batch_launch(const void* seq, const void* qual,
                                    const void* rlen, const void* select,
                                    int B, int L, int vec, void* out,
                                    int device, void* stream) {
  if (B <= 0 || L <= 0) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(out, 0, (34 * (size_t)L + 2) * 4, s);
  if (e == cudaSuccess) {
    switch (vec) {
      case 16: e = launch<16>(device, s, seq, qual, rlen, select, B, L, out); break;
      case 8: e = launch<8>(device, s, seq, qual, rlen, select, B, L, out); break;
      case 1: e = launch<1>(device, s, seq, qual, rlen, select, B, L, out); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (current != device) cudaSetDevice(current);
  return e;
}

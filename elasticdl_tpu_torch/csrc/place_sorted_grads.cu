// Dense embedding-gradient placement from an id-sorted stream.
//
// Replaces elasticdl_tpu/ops/pallas_scatter.py:place_sorted_grads, the
// Pallas TPU kernel behind the backward of every embedding lookup.
//
// Contract: out[r, :] = sum of rows[j, :] over every j with
// sorted_ids[j] == r, for r in [0, num_rows), in f32, summed in a fixed
// order that does not change between runs. Ids outside [0, num_rows)
// (negative padding, the int32max/2 out-of-range sentinel) match no output
// row and contribute nothing. The kernels set every output value — rows
// with no ids get 0, so the caller needs no memset — and use no float
// atomics, so a result is the same from run to run. Any d >= 1 and n = 0
// are allowed.
//
// What bounds it: bytes. At the DeepFM shape (n = 8192 x 26 = 212,992
// stream rows, d = 17, num_rows = 2,605,056) it reads 212,992 x (17+1) x 4
// B = 15.3 MB and writes 2,605,056 x 17 x 4 B = 177 MB: about 192 MB, or
// 57 us at the H100's 3.35 TB/s. The dense write dominates, and ~92% of
// the rows have no id. The TPU kernel's one-hot MXU matmul, transposed
// output, depth padding and bf16 hi+lo split were Mosaic workarounds and
// have no counterpart here.
//
// Design: two launches on the stream, and the reads of the stream kept
// apart from the dense write. A block that must read the stream before it
// writes (a search, then its ids, then its rows) waits on loads that queue
// behind the whole card's stores; on the H100 a single-pass layout (a
// block's span staged in shared memory and written with 16-byte stores)
// took about twice the time of the bare dense write (PERF.md).
// - The zero pass (`place_zero_kernel`) writes 0 over the whole table with
//   16-byte stores, reading nothing, as fast as a memset. Its first
//   n / kChunk blocks also own kChunk consecutive stream rows each; where
//   all of them carry one id in range (a chunk inside a hot segment) the
//   block sums them into chunk_sums[c].
// - The placement pass (`place_sorted_grads_kernel`) runs after it. A
//   block owns kStreamRows stream positions and writes the sum of every
//   segment (the run of one in-range id) that starts there, once, into
//   that id's row; a row with no id keeps its 0. A segment shorter than
//   kSplit is summed serially by one lane a column, the lanes' first loads
//   kBatch at a time; a longer one by the whole block: its rows before
//   its first full chunk, the zero pass's chunk sums, and its rows after
//   its last full chunk, split over the lanes and added in a fixed order.
//   Its end is found by one binary search; no other search runs. A row of
//   d = 17 floats (68 bytes) covers its first and last 32-byte sectors in
//   part, and the cache reads such a sector back from memory before it
//   writes it; where the neighbour row has no id (~92% of rows), the
//   row's writer writes the neighbour's part of the sector with 0 too, so
//   the sector goes out whole.
// The order of summation depends only on the ids, d and these constants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;       // stream rows a chunk sum covers
constexpr int kStreamRows = 64;   // stream positions a placement block owns
constexpr int kSplit = 32;        // a segment this long is summed by a block
constexpr int kZeroBlocks = 1024; // the zero pass's blocks, at least
constexpr int kBatch = 4;         // short segments a lane loads together
constexpr int kSectorFloats = 8;  // floats of a 32-byte memory sector

// The sum over items k in [0, n_items) of the d floats at item(k), lanes
// (ph, col) of the block summing the items ph, ph + P, ... of column col,
// then the P partial sums of each column added in phase order; calls
// put(col, sum) once for each column. P = kThreads / d (1 where d >
// kThreads: then each thread takes columns t, t + kThreads, ...). Every
// thread of the block must call it.
template <typename Item, typename Put>
__device__ __forceinline__ void block_sum(Item item, int n_items, int d,
                                          float* part, Put put) {
  const int P = max(1, kThreads / d);
  for (int e = threadIdx.x; e < P * d; e += kThreads) {
    const int ph = e / d;
    const int col = e - ph * d;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = ph; k < n_items; k += P) acc += __ldg(item(k) + col);
    if (P == 1) {
      put(col, acc);
    } else {
      part[e] = acc;
    }
  }
  if (P > 1) {
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += kThreads) {
      float acc = part[col];
      for (int ph = 1; ph < P; ++ph) acc += part[ph * d + col];
      put(col, acc);
    }
    __syncthreads();
  }
}

// First position in [lo, hi) whose id is above `key` (hi when none is).
__device__ int first_above(const int32_t* __restrict__ ids, int lo, int hi,
                           int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
place_zero_kernel(const int32_t* __restrict__ ids,
                  const float* __restrict__ rows,
                  float* __restrict__ chunk_sums, float* __restrict__ out,
                  long long out_floats, int n, int num_rows, int d) {
  __shared__ float part[kThreads];
  const long long n4 = out_floats / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    out4[i] = zero;
  }
  if (blockIdx.x == 0) {
    for (long long i = 4 * n4 + threadIdx.x; i < out_floats; i += kThreads) {
      out[i] = 0.0f;
    }
  }

  const int c = blockIdx.x;
  if ((c + 1) * static_cast<long long>(kChunk) > n) return;
  const int id = ids[c * kChunk];
  if (id != ids[c * kChunk + kChunk - 1] || id < 0 || id >= num_rows) return;
  const float* base = rows + static_cast<long long>(c) * kChunk * d;
  float* dst = chunk_sums + static_cast<long long>(c) * d;
  block_sum([&](int k) { return base + static_cast<long long>(k) * d; },
            kChunk, d, part, [&](int col, float v) { dst[col] = v; });
}

__global__ void __launch_bounds__(kThreads)
place_sorted_grads_kernel(const int32_t* __restrict__ ids,
                          const float* __restrict__ rows,
                          const float* __restrict__ chunk_sums,
                          float* __restrict__ out, int n, int num_rows,
                          int d) {
  // sid[i] = ids[j0 - 1 + i], -1 outside the stream (never in range)
  __shared__ int sid[kStreamRows + kSplit + 1];
  __shared__ float part[kThreads];
  __shared__ int seg_end;
  const int j0 = blockIdx.x * kStreamRows;
  const int m = min(kStreamRows, n - j0);
  for (int i = threadIdx.x; i < kStreamRows + kSplit + 1; i += kThreads) {
    const long long j = static_cast<long long>(j0) - 1 + i;
    sid[i] = (j >= 0 && j < n) ? ids[j] : -1;
  }
  __syncthreads();

  // the short segments starting at positions p of this block: one lane a
  // (segment, column), summed in stream order. A segment of kSplit or more
  // positions has its id kSplit - 1 positions on, inside sid.
  auto starts = [&](int p) {
    const int id = sid[p + 1];
    return id != sid[p] && id >= 0 && id < num_rows;
  };
  // A lane takes its positions kBatch at a time and loads their first rows
  // together, so that those loads are in flight at once.
  const int P = max(1, kThreads / d);
  for (int e = threadIdx.x; e < P * d; e += kThreads) {
    const int ph = e / d;
    const int col = e - ph * d;
    for (int p0 = ph; p0 < m; p0 += kBatch * P) {
      float acc[kBatch];
      int len[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * P;
        len[u] = 0;
        if (p < m && starts(p) && sid[p + kSplit] != sid[p + 1]) {
          len[u] = 1;
          while (sid[p + 1 + len[u]] == sid[p + 1]) ++len[u];
        }
        acc[u] = len[u] ? __ldg(rows + static_cast<long long>(j0 + p) * d + col)
                        : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (len[u] == 0) continue;
        const int p = p0 + u * P;
        const float* x = rows + static_cast<long long>(j0 + p) * d + col;
        for (int k = 1; k < len[u]; ++k) {
          acc[u] += __ldg(x + static_cast<long long>(k) * d);
        }
        const int id = sid[p + 1];
        const long long at = static_cast<long long>(id) * d;
        out[at + col] = acc[u];
        // Zeros again over the parts of the row's first and last 32-byte
        // sectors that belong to empty neighbour rows (id - 1 and id + 1
        // have no segment), so that the sectors are written whole and the
        // cache need not read them back from memory. Only where rows end
        // inside sectors, with d >= 8, so such a part lies in the neighbour.
        if (d > kSectorFloats && d % kSectorFloats && col < kSectorFloats) {
          const long long before = at - 1 - col;
          if (sid[p] != id - 1 && before >= (at & ~(kSectorFloats - 1LL))) {
            out[before] = 0.0f;
          }
          const long long after = at + d + col;
          if (sid[p + 1 + len[u]] != id + 1 && id + 1 < num_rows &&
              after < ((at + d + kSectorFloats - 1) & ~(kSectorFloats - 1LL))) {
            out[after] = 0.0f;
          }
        }
      }
    }
  }

  // the long segments starting here, each summed by the whole block: head
  // rows, the zero pass's sums of the full chunks inside the segment, tail
  // rows. Every warp finds the same segments, 32 positions at a time.
  const int lane = threadIdx.x % 32;
  for (int base = 0; base < m; base += 32) {
    const int mine = base + lane;
    unsigned found = __ballot_sync(
        0xffffffffu,
        mine < m && starts(mine) && sid[mine + kSplit] == sid[mine + 1]);
    for (; found; found &= found - 1) {
      const int p = base + __ffs(found) - 1;
      const int id = sid[p + 1];
      const int s = j0 + p;
      if (threadIdx.x == 0) seg_end = first_above(ids, s + kSplit, n, id);
      __syncthreads();
      const int e = seg_end;
      const int c0 = (s + kChunk - 1) / kChunk;
      const int c1 = e / kChunk;
      const int chunks = c0 < c1 ? c1 - c0 : 0;
      const int head = chunks ? c0 * kChunk - s : e - s;
      const int tail0 = c1 * kChunk;
      const int n_items = head + chunks + (chunks ? e - tail0 : 0);
      float* dst = out + static_cast<long long>(id) * d;
      block_sum(
          [&](int k) -> const float* {
            if (k < head) return rows + static_cast<long long>(s + k) * d;
            if (k < head + chunks) {
              return chunk_sums + static_cast<long long>(c0 + k - head) * d;
            }
            return rows + static_cast<long long>(tail0 + k - head - chunks) * d;
          },
          n_items, d, part, [&](int col, float v) { dst[col] = v; });
      __syncthreads();  // seg_end is read before the next segment sets it
    }
  }
}

}  // namespace

extern "C" {

// Floats of scratch a call needs: the kChunk-row chunk sums.
long long place_sorted_grads_scratch(int n, int d) {
  return static_cast<long long>(n / kChunk) * d;
}

// Launches the zero pass and the placement pass on `stream` and returns
// cudaGetLastError() (0 on success). sorted_ids: int32 (n,) ascending;
// rows: f32 (n, d) row-major in the same order; out: f32 (num_rows, d)
// row-major, 16-byte aligned, fully written by the kernels; scratch:
// place_sorted_grads_scratch(n, d) floats, any contents.
int place_sorted_grads(const void* sorted_ids, const void* rows, void* out,
                       void* scratch, int n, int num_rows, int d,
                       void* stream) {
  if (num_rows > 0 && d > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* ids = static_cast<const int32_t*>(sorted_ids);
    const float* x = static_cast<const float*>(rows);
    float* chunk_sums = static_cast<float*>(scratch);
    float* dst = static_cast<float*>(out);
    const int zero_blocks = n / kChunk > kZeroBlocks ? n / kChunk : kZeroBlocks;
    place_zero_kernel<<<zero_blocks, kThreads, 0, s>>>(
        ids, x, chunk_sums, dst, static_cast<long long>(num_rows) * d, n,
        num_rows, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = n > 0 ? (n - 1) / kStreamRows + 1 : 1;
    place_sorted_grads_kernel<<<blocks, kThreads, 0, s>>>(
        ids, x, chunk_sums, dst, n, num_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

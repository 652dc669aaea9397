// Dense embedding-gradient placement from an id-sorted stream.
//
// Replaces elasticdl_tpu/ops/pallas_scatter.py:place_sorted_grads, the
// Pallas TPU kernel behind the backward of every embedding lookup.
//
// Contract: out[r, :] = sum of rows[j, :] over every j with
// sorted_ids[j] == r, for r in [0, num_rows), in f32, summed in stream
// order. Ids outside [0, num_rows) (negative padding, the int32max/2
// out-of-range sentinel) match no output row and contribute nothing. Every
// output row is written exactly once — rows with no ids get 0, so the
// caller needs no memset — and there are no float atomics, so a result is
// the same from run to run. Any d >= 1 and n = 0 are allowed.
//
// What bounds it: bytes. At the DeepFM shape (n = 8192 x 26 = 212,992
// stream rows, d = 17, num_rows = 2,605,056) it reads 212,992 x (17+1) x 4
// B = 15.3 MB and writes 2,605,056 x 17 x 4 B = 177 MB: about 192 MB, or
// 57 us at the H100's 3.35 TB/s. The dense write dominates. The design
// makes that write one coalesced pass: a block owns kRowsPerBlock
// consecutive output rows, which are one contiguous span of
// kRowsPerBlock x d floats, and its threads walk that span with
// consecutive threads on consecutive addresses. The TPU kernel's one-hot
// MXU matmul, transposed output, depth padding and bf16 hi+lo split were
// Mosaic workarounds and have no counterpart here.
//
// Each block finds its rows' segments in the sorted stream with binary
// searches: two over the whole stream for the block's bounds, then one per
// row inside those bounds. A single hot id is summed by d threads alone,
// serially — correct, but the first thing a faster version should split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 256;
constexpr int kThreads = 256;

// First position in [lo, hi) whose id is >= key (hi when none is).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ ids,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
place_sorted_grads_kernel(const int32_t* __restrict__ sorted_ids,
                          const float* __restrict__ rows,
                          float* __restrict__ out, int n, int num_rows,
                          int d) {
  __shared__ int seg[kRowsPerBlock + 1];
  __shared__ int bounds[2];
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int nr = min(kRowsPerBlock, num_rows - r0);

  // the stream positions of this block's first row and of the row after
  // its last: every id of the block lies between them
  if (threadIdx.x < 2) {
    bounds[threadIdx.x] =
        lower_bound(sorted_ids, 0, n, r0 + static_cast<int>(threadIdx.x) * nr);
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];
  for (int t = threadIdx.x; t <= nr; t += blockDim.x) {
    seg[t] = lower_bound(sorted_ids, lo, hi, r0 + t);
  }
  __syncthreads();

  // element e of the block's contiguous output span is row e / d,
  // column e % d
  const int64_t base = static_cast<int64_t>(r0) * d;
  const int count = nr * d;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int i = e / d;
    const int c = e - i * d;
    float acc = 0.0f;
    const int end = seg[i + 1];
    for (int j = seg[i]; j < end; ++j) {
      acc += __ldg(rows + static_cast<int64_t>(j) * d + c);
    }
    out[base + e] = acc;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// sorted_ids: int32 (n,) ascending; rows: f32 (n, d) row-major in the same
// order; out: f32 (num_rows, d) row-major, fully written by the kernel.
int place_sorted_grads(const void* sorted_ids, const void* rows, void* out,
                       int n, int num_rows, int d, void* stream) {
  if (num_rows > 0 && d > 0) {
    const int blocks = (num_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    place_sorted_grads_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sorted_ids),
        static_cast<const float*>(rows), static_cast<float*>(out), n,
        num_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

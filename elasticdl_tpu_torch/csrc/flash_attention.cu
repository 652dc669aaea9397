// Flash attention on Hopper: forward (K2) and the two backward kernels (K3
// dQ, K4 dK/dV).
//
// Replaces elasticdl_tpu/ops/pallas_attention.py: `_fwd_kernel` (launched
// by `_flash_fwd`), `_bwd_dq_kernel` and `_bwd_dkv_kernel` (launched by
// `_flash_bwd`), the Pallas TPU kernels behind every attention of the
// transformer LM, for the inputs the tensor-core kernels of
// csrc/flash_attention_sm90.cu do not take: float32 and bfloat16 at head
// dims other than 16, 32, 64 and 128, and dQ (K3) for float32 at D 128.
// bfloat16 at those four runs K2', K3' and K4' there, float32 K2-tf32,
// K3-tf32 and K4-tf32 (at D 128 K2-tf32 and K4-tf32, beside K3 here).
//
// Contract (see ops/flash_attention.py): q (B, Tq, H, D), k and v
// (B, Tk, H, D), out and dout like q, all float32 or all bfloat16, read in
// place through (b, t, h) element strides with a contiguous head dim. lse
// and g_lse are contiguous (B, H, Tq) float32. Scores are
// s = (q . k) * D^-0.5 summed in float32; the causal mask compares GLOBAL
// positions, kv_offset + j <= q_offset + i. A masked score gives p = 0
// even while its row's running max is still NEG_BIG, so a fully masked row
// returns 0 with lse = NEG_BIG + log(1e-30) under any tiling. p stays
// float32 and multiplies v cast to float32; in the backward dp, dq, dk and
// dv are float32 too, as in the Pallas kernels, and each output is rounded
// to its dtype once.
//
// What bounds them. Causal K2 does 4·B·H·T²·D/2 flops (K3 6, K4 8) on
// ~4·B·T·H·D elements. At the LM's shape (B8 T1024 H8 D64, bf16) the card's
// own least time is ~10 us, set about equally by bytes at 3.35 TB/s and by
// flops at the bf16 tensor-core peak. These kernels do all arithmetic as
// float32 FMAs on the CUDA cores, which matches the reference's precision
// best (a tensor-core product would round p to bf16 first), so they are
// bound by operations at the float32 peak (~130 us for K2 there).
//
// Design. Scores never leave registers: only q, k, v, out, dout, lse and
// the outputs touch device memory.
// - 128 threads a block. A row of q (or of k in K4) belongs to G = Dpad/32
//   neighbouring lanes; each lane holds 32 of the row's dims (eight float4
//   quads, interleaved so that the lanes of a row read neighbouring quads
//   of a shared-memory row and no two of them share a bank). A dot product
//   is 32 FMAs a lane and log2(G) shuffles.
// - The streamed operand (K and V in K2 and K3, Q and dO in K4) is staged
//   in shared memory as float32, 32 rows a tile, padded with zeros to
//   Dpad and past the sequence's end; every lane of a warp that reads a
//   tile row reads it by broadcast.
// - K2 keeps a running max, sum and a float32 accumulator per row and
//   rescales once a tile. K3 loops over KV tiles for one q tile and K4 over
//   q tiles for one KV tile, so each output has one writer: no atomics,
//   and a run is bit-reproducible. Both recompute p = exp(s - lse) and
//   delta = rowsum(dO . O) - g_lse in the kernel.
// - Causal tiles wholly above the diagonal are not visited: the loop
//   bounds come from the offsets at run time.
// The Hopper kernels (wgmma, TMA, a pipelined tile ring) are in
// csrc/flash_attention_sm90.cu.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the streamed operand per stage
constexpr float kNegBig = -1e30f;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the G lanes of a row; every one of them gets the same total.
template <int G>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Dim of this lane's element c (0..31): quad i = c / 4 is the row's quad
// i * G + g.
template <int G>
__device__ __forceinline__ int dim_of(int g, int c) {
  return ((c >> 2) * G + g) * 4 + (c & 3);
}

// Load this lane's 32 elements of row t of x (zeros past D, or where the
// row does not exist).
template <typename T, int G>
__device__ __forceinline__ void load_row(float (&r)[32], const T* x,
                                         Strides s, int b, int h, int t,
                                         bool exists, int D, int g) {
  const T* base = x + b * s.b + static_cast<long long>(t) * s.t + h * s.h;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int d = dim_of<G>(g, c);
    r[c] = (exists && d < D) ? to_float(base[d]) : 0.0f;
  }
}

template <typename T, int G>
__device__ __forceinline__ void store_row(const float (&r)[32], float mul,
                                          T* x, Strides s, int b, int h,
                                          int t, int D, int g) {
  T* base = x + b * s.b + static_cast<long long>(t) * s.t + h * s.h;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int d = dim_of<G>(g, c);
    if (d < D) base[d] = from_float<T>(r[c] * mul);
  }
}

// Stage rows t0 .. t0 + kTile - 1 of x into tile[kTile][32 * G] as float32,
// zero-padded.
template <typename T, int G>
__device__ __forceinline__ void load_tile(float* tile, const T* x, Strides s,
                                          int b, int h, int t0, int T_len,
                                          int D) {
  constexpr int kDp = 32 * G;
  const T* base = x + b * s.b + h * s.h;
  for (int e = threadIdx.x; e < kTile * kDp; e += kThreads) {
    const int r = e / kDp;
    const int d = e - r * kDp;
    const int t = t0 + r;
    tile[e] = (t < T_len && d < D)
                  ? to_float(base[static_cast<long long>(t) * s.t + d])
                  : 0.0f;
  }
}

// This lane's partial dot of its 32 elements with row j of a tile.
template <int G>
__device__ __forceinline__ float dot_part(const float (&r)[32],
                                          const float* tile, int j, int g) {
  const float4* row = reinterpret_cast<const float4*>(tile + j * 32 * G);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = row[i * G + g];
    acc = fmaf(r[4 * i + 0], x.x, acc);
    acc = fmaf(r[4 * i + 1], x.y, acc);
    acc = fmaf(r[4 * i + 2], x.z, acc);
    acc = fmaf(r[4 * i + 3], x.w, acc);
  }
  return acc;
}

// acc += w * (this lane's 32 elements of row j of a tile)
template <int G>
__device__ __forceinline__ void axpy(float (&acc)[32], float w,
                                     const float* tile, int j, int g) {
  const float4* row = reinterpret_cast<const float4*>(tile + j * 32 * G);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = row[i * G + g];
    acc[4 * i + 0] = fmaf(w, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

// Number of kv rows [0, n) that a block of q rows [q_lo, q_hi) can see.
__device__ __forceinline__ int kv_rows_seen(int q_hi, int Tk, int q_off,
                                            int kv_off, bool causal) {
  if (!causal) return Tk;
  const long long last = static_cast<long long>(q_off) + q_hi - 1 - kv_off;
  return static_cast<int>(max(0LL, min(static_cast<long long>(Tk), last + 1)));
}

// ------------------------------------------------------------------ K2

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int Tq, int Tk, int D, int q_off,
                 int kv_off, bool causal, float scale) {
  constexpr int kRows = kThreads / G;
  constexpr int kDp = 32 * G;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * kDp;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + threadIdx.x / G;
  const bool live_row = i < Tq;
  const long long q_pos = static_cast<long long>(q_off) + i;

  float qr[32], acc[32];
  load_row<T, G>(qr, q, sq, b, h, i, live_row, D, g);
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.0f;
  float m = kNegBig, l = 0.0f;

  const int n_kv = kv_rows_seen(min(Tq, row0 + kRows), Tk, q_off, kv_off,
                                causal);
  for (int j0 = 0; j0 < n_kv; j0 += kTile) {
    __syncthreads();
    load_tile<T, G>(ks, k, sk, b, h, j0, Tk, D);
    load_tile<T, G>(vs, v, sv, b, h, j0, Tk, D);
    __syncthreads();

    float p[kTile];
    unsigned valid = 0u;
    float m_tile = kNegBig;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float s = row_sum<G>(dot_part<G>(qr, ks, j, g)) * scale;
      const int kj = j0 + j;
      const bool ok =
          kj < Tk && (!causal || static_cast<long long>(kv_off) + kj <= q_pos);
      valid |= static_cast<unsigned>(ok) << j;
      p[j] = s;
      if (ok) m_tile = fmaxf(m_tile, s);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float l_tile = 0.0f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      p[j] = ((valid >> j) & 1u) ? expf(p[j] - m_new) : 0.0f;
      l_tile += p[j];
    }
    l = l * alpha + l_tile;
    m = m_new;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) axpy<G>(acc, p[j], vs, j, g);
  }

  if (live_row) {
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] /= l_safe;
    store_row<T, G>(acc, 1.0f, out, so, b, h, i, D, g);
    if (g == 0) {
      lse[static_cast<long long>(blockIdx.y) * Tq + i] = m + logf(l_safe);
    }
  }
}

// ------------------------------------------------------------------ K3

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ glse, T* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    Strides sdo, Strides sdq, int H, int Tq, int Tk, int D,
                    int q_off, int kv_off, bool causal, float scale) {
  constexpr int kRows = kThreads / G;
  constexpr int kDp = 32 * G;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * kDp;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + threadIdx.x / G;
  const bool live_row = i < Tq;
  const long long q_pos = static_cast<long long>(q_off) + i;
  const long long lse_at = static_cast<long long>(blockIdx.y) * Tq + i;

  float qr[32], dor[32], acc[32];
  load_row<T, G>(qr, q, sq, b, h, i, live_row, D, g);
  load_row<T, G>(dor, dout, sdo, b, h, i, live_row, D, g);
  // delta = rowsum(dO . O) - g_lse, with O as stored
  load_row<T, G>(acc, o, so, b, h, i, live_row, D, g);
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < 32; ++c) part = fmaf(dor[c], acc[c], part);
  float delta = row_sum<G>(part);
  float row_lse = 0.0f;
  if (live_row) {
    row_lse = lse[lse_at];
    if (glse != nullptr) delta -= glse[lse_at];
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.0f;

  const int n_kv = kv_rows_seen(min(Tq, row0 + kRows), Tk, q_off, kv_off,
                                causal);
  for (int j0 = 0; j0 < n_kv; j0 += kTile) {
    __syncthreads();
    load_tile<T, G>(ks, k, sk, b, h, j0, Tk, D);
    load_tile<T, G>(vs, v, sv, b, h, j0, Tk, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = row_sum<G>(dot_part<G>(qr, ks, j, g)) * scale;
      const float dp = row_sum<G>(dot_part<G>(dor, vs, j, g));
      const int kj = j0 + j;
      const bool ok = live_row && kj < Tk &&
                      (!causal || static_cast<long long>(kv_off) + kj <= q_pos);
      const float p = ok ? expf(s - row_lse) : 0.0f;
      axpy<G>(acc, p * (dp - delta), ks, j, g);
    }
  }
  if (live_row) store_row<T, G>(acc, scale, dq, sdq, b, h, i, D, g);
}

// ------------------------------------------------------------------ K4

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ glse, T* __restrict__ dk,
                     T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides so, Strides sdo, Strides sdk, Strides sdv, int H,
                     int Tq, int Tk, int D, int q_off, int kv_off, bool causal,
                     float scale) {
  constexpr int kRows = kThreads / G;
  constexpr int kDp = 32 * G;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * kDp;
  float* lse_s = dos + kTile * kDp;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * kRows;
  const int j = row0 + threadIdx.x / G;
  const bool live_row = j < Tk;
  const long long kv_pos = static_cast<long long>(kv_off) + j;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float kr[32], vr[32], dk_acc[32], dv_acc[32];
  load_row<T, G>(kr, k, sk, b, h, j, live_row, D, g);
  load_row<T, G>(vr, v, sv, b, h, j, live_row, D, g);
#pragma unroll
  for (int c = 0; c < 32; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

  // the first q row that sees this block's first kv row, down to a tile
  int i_start = 0;
  if (causal) {
    const long long first =
        static_cast<long long>(kv_off) + row0 - q_off;  // local q index
    i_start = static_cast<int>(
        max(0LL, min(static_cast<long long>(Tq), first)));
    i_start -= i_start % kTile;
  }
  const T* o_base = o + b * so.b + h * so.h;
  for (int i0 = i_start; i0 < Tq; i0 += kTile) {
    __syncthreads();
    load_tile<T, G>(qs, q, sq, b, h, i0, Tq, D);
    load_tile<T, G>(dos, dout, sdo, b, h, i0, Tq, D);
    __syncthreads();
    // lse and delta = rowsum(dO . O) - g_lse of the tile's rows, a warp
    // a row
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const int i = i0 + r;
      float part = 0.0f;
      if (i < Tq) {
        const T* orow = o_base + static_cast<long long>(i) * so.t;
        for (int d = lane; d < D; d += 32) {
          part = fmaf(dos[r * kDp + d], to_float(orow[d]), part);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0) {
        const long long at = static_cast<long long>(blockIdx.y) * Tq + i;
        lse_s[r] = i < Tq ? lse[at] : 0.0f;
        delta_s[r] = part - ((i < Tq && glse != nullptr) ? glse[at] : 0.0f);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const int i = i0 + r;
      const float s = row_sum<G>(dot_part<G>(kr, qs, r, g)) * scale;
      const float dp = row_sum<G>(dot_part<G>(vr, dos, r, g));
      const bool ok = live_row && i < Tq &&
                      (!causal || kv_pos <= static_cast<long long>(q_off) + i);
      const float p = ok ? expf(s - lse_s[r]) : 0.0f;
      axpy<G>(dv_acc, p, dos, r, g);
      axpy<G>(dk_acc, p * (dp - delta_s[r]), qs, r, g);
    }
  }
  if (live_row) {
    store_row<T, G>(dk_acc, scale, dk, sdk, b, h, j, D, g);
    store_row<T, G>(dv_acc, 1.0f, dv, sdv, b, h, j, D, g);
  }
}

// ------------------------------------------------------------------ launch

// Everything a launch needs; pointers a kernel does not take stay null.
struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *glse;
  void *out0, *out1;  // K2: out, lse; K3: dq; K4: dk, dv
  const long long* strides;  // (b, t, h) of each tensor, in argument order
  int B, H, Tq, Tk, D, q_off, kv_off;
  bool causal;
  float scale;
  cudaStream_t stream;

  Strides at(int n) const {
    return Strides{strides[3 * n], strides[3 * n + 1], strides[3 * n + 2]};
  }
  dim3 grid(int rows_per_block, int rows) const {
    return dim3((rows + rows_per_block - 1) / rows_per_block, B * H);
  }
};

// Shared memory of a block: two kTile x Dpad float32 tiles, and for K4 the
// tile's lse and delta.
template <int G>
constexpr size_t smem_bytes() {
  return (2 * kTile * 32 * G + 2 * kTile) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

struct Fwd {
  template <typename T, int G>
  static cudaError_t run(const Args& a) {
    auto kernel = flash_fwd_kernel<T, G>;
    const size_t smem = smem_bytes<G>();
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.grid(kThreads / G, a.Tq), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out0),
        static_cast<float*>(a.out1), a.at(0), a.at(1), a.at(2), a.at(3), a.H,
        a.Tq, a.Tk, a.D, a.q_off, a.kv_off, a.causal, a.scale);
    return cudaGetLastError();
  }
};

struct BwdDq {
  template <typename T, int G>
  static cudaError_t run(const Args& a) {
    auto kernel = flash_bwd_dq_kernel<T, G>;
    const size_t smem = smem_bytes<G>();
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.grid(kThreads / G, a.Tq), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.glse), static_cast<T*>(a.out0), a.at(0),
        a.at(1), a.at(2), a.at(3), a.at(4), a.at(5), a.H, a.Tq, a.Tk, a.D,
        a.q_off, a.kv_off, a.causal, a.scale);
    return cudaGetLastError();
  }
};

struct BwdDkv {
  template <typename T, int G>
  static cudaError_t run(const Args& a) {
    auto kernel = flash_bwd_dkv_kernel<T, G>;
    const size_t smem = smem_bytes<G>();
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.grid(kThreads / G, a.Tk), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.glse), static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.at(0), a.at(1), a.at(2), a.at(3), a.at(4),
        a.at(5), a.at(6), a.H, a.Tq, a.Tk, a.D, a.q_off, a.kv_off, a.causal,
        a.scale);
    return cudaGetLastError();
  }
};

// Op::run<T, G> for the dtype code (0 float32, 1 bfloat16) and the lanes a
// row needs (Dpad = 32 * G >= D).
template <typename Op>
int dispatch(int dtype, const Args& a) {
  if (a.D < 1 || a.D > 256 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = a.D <= 32 ? 1 : a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
  cudaError_t err;
  if (dtype == 0) {
    err = G == 1   ? Op::template run<float, 1>(a)
          : G == 2 ? Op::template run<float, 2>(a)
          : G == 4 ? Op::template run<float, 4>(a)
                   : Op::template run<float, 8>(a);
  } else {
    err = G == 1   ? Op::template run<__nv_bfloat16, 1>(a)
          : G == 2 ? Op::template run<__nv_bfloat16, 2>(a)
          : G == 4 ? Op::template run<__nv_bfloat16, 4>(a)
                   : Op::template run<__nv_bfloat16, 8>(a);
  }
  return static_cast<int>(err);
}

// D^-0.5 as the reference computes it: in double, then rounded to float32
float scale_of(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns its
// cudaError_t (0 on success). `strides` holds the (b, t, h) element
// strides of the tensors in argument order. glse may be null (g_lse = 0).

int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              void* out, void* lse, const long long* strides, int B, int H,
              int Tq, int Tk, int D, int q_off, int kv_off, int causal,
              void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, out, lse,
               strides, B, H, Tq, Tk, D, q_off, kv_off, causal != 0,
               scale_of(D), static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(dtype, a);
}

int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse,
                 const void* glse, void* dq, const long long* strides, int B,
                 int H, int Tq, int Tk, int D, int q_off, int kv_off,
                 int causal, void* stream) {
  const Args a{q, k, v, o, dout, lse, glse, dq, nullptr,
               strides, B, H, Tq, Tk, D, q_off, kv_off, causal != 0,
               scale_of(D), static_cast<cudaStream_t>(stream)};
  return dispatch<BwdDq>(dtype, a);
}

int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const void* lse,
                  const void* glse, void* dk, void* dv,
                  const long long* strides, int B, int H, int Tq, int Tk,
                  int D, int q_off, int kv_off, int causal, void* stream) {
  const Args a{q, k, v, o, dout, lse, glse, dk, dv,
               strides, B, H, Tq, Tk, D, q_off, kv_off, causal != 0,
               scale_of(D), static_cast<cudaStream_t>(stream)};
  return dispatch<BwdDkv>(dtype, a);
}

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash attention on Hopper's tensor cores: the forward (K2') and dQ (K3')
// for bfloat16 with D = 64 or 128, dK/dV (K4') for bfloat16 with D = 64,
// and the pass that writes the delta K3' and K4' read.
//
// Replaces, for those inputs, elasticdl_tpu/ops/pallas_attention.py
// `_fwd_kernel` (`pallas_call` at 256), `_bwd_dq_kernel` (`pallas_call` at
// 404) and `_bwd_dkv_kernel` (`pallas_call` at 433). csrc/flash_attention.cu
// keeps every other case (float32, other head dims).
//
// Contract: that of ops/flash_attention.py, unchanged. q (B, Tq, H, D),
// k and v (B, Tk, H, D), dout like q, read in place through (b, t, h)
// strides with a contiguous head dim; lse, g_lse and delta contiguous
// (B, H, Tq) float32. s = (q . k) * D^-0.5 summed in float32, causal mask
// in GLOBAL positions (kv_offset + j <= q_offset + i), a masked score gives
// p = 0 even while the running max is still NEG_BIG, so a fully masked row
// is 0 with lse = NEG_BIG + log(1e-30) under any tiling. p and ds stay
// float32 as the reference keeps them.
//
// What bounds them. Causal K2 does 4·B·H·T²·D/2 FLOPs, K3 6· and K4 8·, on
// ~4 to ~6 B·T·H·D elements. At the LM's shape (B8 T1024 H8 D64) the card's
// least time is set by bytes at 3.35 TB/s for K2 (10.1 us against 8.7 us of
// FLOPs at the bf16 tensor-core peak) and by FLOPs for K3' and K4', which
// read delta (1 MB) where K3 and K4 read O (16.8 MB): K3' 13.0 us of FLOPs
// against 12.7 us of bytes. The kernels of csrc/flash_attention.cu run
// every product as float32 FMAs on the CUDA cores, 50-70x under that
// bound; here every product runs on `wgmma`.
//
// Design.
// - Precision. A bf16 x bf16 product is exact in float32. Q.K^T
//   (q, k) and dO.V^T (dout, v) have bf16 operands and run on `wgmma` as
//   they are. The float32 operand of P.V, P^T.dO, dS^T.Q and dS.K is split
//   into hi = bf16(x) and lo = bf16(x - hi), which carry x to ~2^-17, and
//   two `wgmma`s accumulate hi.B and lo.B into one float32 accumulator: the
//   float32 product the reference forms, at twice the tensor work of those
//   four products.
// - Blocks. Two consumer warpgroups of 64 rows each (q rows in K2' and
//   K3', kv rows in K4') and one producer warp, which brings the streamed
//   tiles (K, V in K2' and K3'; Q, dO in K4') in by TMA, 64 rows a tile,
//   into a ring of kStages stages guarded by full/empty mbarriers. Tiles
//   land with the 128-byte swizzle the wgmma descriptors read; D = 64 bf16
//   is one 128-byte row, D = 128 two such column blocks. Tails past T come
//   as zeros from TMA's out-of-bounds fill and are masked.
// - Registers. ptxas gives 168 a thread to a block of this size. K2'
//   needs ~2 x 32 (D 64) or 32 + 64 (D 128) floats of accumulators, K3'
//   3 x 32 (D 64) or 2 x 32 + 64 (D 128), K4' at D 64 4 x 32; all of these
//   fit. K4' at D 128 would need 2 x 64 + 2 x 32 beside the split
//   fragments and spills, so it is not built: bfloat16 at D 128 takes K4
//   for dK/dV.
// - K2'. S = Q.K^T (shared-memory A and B, both K-major) into registers;
//   the online softmax runs on the accumulator's own layout (a thread holds
//   two rows, quad shuffles reduce them); p goes straight into register A
//   fragments as hi and lo; O += P.V reads V MN-major through the transpose
//   bit. O / l is rounded to bf16 once.
// - K3'. K2''s loop with one product more: a block owns 128 q rows (Q and
//   dO loaded once), lse and delta of its rows sit in registers, and the
//   K and V tiles stream through the ring. S = Q.K^T and dP = dO.V^T on
//   wgmma (all K-major); p = exp(s - lse), ds = p (dp - delta) on the
//   accumulator layout; dQ += dS.K with dS as split register A fragments
//   and K MN-major through the transpose bit, as V in K2''s P.V. dQ times
//   the scale is rounded to bf16 once; each row has one writer.
// - K4'. A block owns 128 kv rows (K, V loaded once) and walks the q tiles
//   from the first one the causal mask lets through. S^T = K.Q^T and
//   dP^T = V.dO^T on wgmma; p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta);
//   dV += P^T.dO and dK += dS^T.Q with split A operands; dK and dV stay in
//   registers and each output row has one writer: no atomics, runs are
//   bit-reproducible.
// - delta = rowsum(dO . O) - g_lse is computed once a row by
//   flash_bwd_delta_sm90, once a backward, and read by both K3' and K4'
//   (K3 and K4 recompute it from O in every block).
// - Causal tiles wholly above the diagonal are not visited: the bounds come
//   from the runtime offsets. K2' and K3' start the blocks with the most
//   tiles first.
// Tensor maps are built on the host over each tensor's strides; the
// encoder comes from the CUDA runtime's entry-point lookup (no -lcuda).

#include <cmath>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBlockRows = 64 * kConsumers;
constexpr int kTileRows = 64;                    // streamed rows a stage
constexpr int kStages = 2;
constexpr float kNegBig = -1e30f;
// A wait longer than this many clocks (~2 s) is a fault: trap, so that the
// launch fails instead of hanging the card.
constexpr long long kWaitLimit = 1LL << 32;

struct Strides {
  long long b, t, h;
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitLimit) __trap();
  }
}

// TMA: the box at (d, t, h, b) of a (B, T, H, D) tensor into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(t), "r"(h), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of an operand in 128-byte-swizzled rows (the TMA
// layout): start address, leading and stride byte offsets (in 16 bytes),
// layout type 1 = 128-byte swizzle. The stride byte offset is 1024 bytes,
// from one group of 8 rows to the next. K-major operands ignore the leading
// offset; MN-major ones (N = D) take the distance between the two 64-column
// blocks of a D = 128 tile.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lead_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lead_bytes >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// Step kk (16 dims) of a K-major tile of `rows` rows stored as D / 64
// column blocks of [rows][64]: column block kk / 4, byte 32 (kk % 4) of
// each 128-byte row (the swizzle is applied to the address, so a step
// inside the row moves the start address only).
__device__ __forceinline__ const uint8_t* kstep(const uint8_t* tile, int rows,
                                                int kk) {
  return tile + (kk / 4) * rows * 128 + (kk % 4) * 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes between its launch and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// d (64 x 64) = A (64 x 16) . B (16 x 64) (+ d if `accumulate`): A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16) . B (16 x 64): A from registers, B from
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16) . B (16 x 128): A from registers, B from
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int kD>
__device__ __forceinline__ void wgmma_rs(float (&d)[kD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kD == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n128(d, a, b);
  }
}

// Accumulator layout of a 64 x N wgmma tile: thread t of the warpgroup
// holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8; its element i is
// at column 8 (i / 4) + 2 (t % 4) + (i & 1) of row r0 (bit 1 of i clear) or
// r0 + 8 (set).
__device__ __forceinline__ int acc_col(int i, int c0) {
  return 8 * (i / 4) + c0 + (i & 1);
}
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }

// The 64 x 64 float32 tile x, in the accumulator layout, as the register
// A fragments of four k16 steps, split into hi = bf16(x) and
// lo = bf16(x - hi). The accumulator layout of columns 16 kk .. 16 kk + 15
// is the A fragment of step kk.
__device__ __forceinline__ void split(const float (&x)[32],
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const __nv_bfloat162 l = __floats2bfloat162_rn(
          a - __low2float(h), b - __high2float(h));
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Number of kv rows [0, n) that q rows [.., q_hi) can see.
__device__ __forceinline__ int kv_rows_seen(int q_hi, int Tk, int q_off,
                                            int kv_off, bool causal) {
  if (!causal) return Tk;
  const long long last = static_cast<long long>(q_off) + q_hi - 1 - kv_off;
  return static_cast<int>(max(0LL, min(static_cast<long long>(Tk), last + 1)));
}

__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  // bars[0]: the block's resident tiles; then kStages full, kStages empty
  mbar_init(&bars[0], 1);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&bars[1 + s], 1);
    mbar_init(&bars[1 + kStages + s], 4 * kConsumers);  // a warp each
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ------------------------------------------------------------------ K2'

template <int kD>
struct FwdLayout {
  static constexpr int kQBytes = kBlockRows * kD * 2;
  static constexpr int kTileBytes = kTileRows * kD * 2;
  static constexpr int kBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, Strides so, int H, int Tq,
                      int Tk, int q_off, int kv_off, bool causal,
                      float scale) {
  using L = FwdLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);             // kD/64 blocks [128][64]
  uint8_t* ks = qs + L::kQBytes;                  // [stage] kD/64 [64][64]
  uint8_t* vs = ks + kStages * L::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * L::kTileBytes);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int n_tiles =
      (kv_rows_seen(min(Tq, q0 + kBlockRows), Tk, q_off, kv_off, causal) +
       kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // the producer warp: one thread starts the loads
    if (lane != 0 || n_tiles == 0) return;
    mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
    for (int a = 0; a < kD / 64; ++a) {
      tma_load(qs + a * kBlockRows * 128, &tq, q_bar, 64 * a, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
      mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
      for (int a = 0; a < kD / 64; ++a) {
        const int at = s * L::kTileBytes + a * kTileRows * 128;
        tma_load(ks + at, &tk, &full[s], 64 * a, j * kTileRows, h, b);
        tma_load(vs + at, &tv, &full[s], 64 * a, j * kTileRows, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows row0 .. row0 + 63
  const int tw = threadIdx.x % 128;
  const int r0 = (tw / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int row0 = q0 + wg * 64;
  const long long qpos = static_cast<long long>(q_off) + row0 + r0;
  const int n_mine =
      row0 < Tq ? (kv_rows_seen(min(Tq, row0 + 64), Tk, q_off, kv_off,
                                causal) + kTileRows - 1) / kTileRows
                : 0;

  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.0f, 0.0f};
  if (n_tiles > 0) mbar_wait(q_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (j < n_mine) {
      const uint8_t* kt = ks + s * L::kTileBytes;
      const uint8_t* vt = vs + s * L::kTileBytes;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      pin(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(sc, desc(kstep(qs, kBlockRows, kk) + wg * 64 * 128, 16),
                     desc(kstep(kt, kTileRows, kk), 16), 1);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      const int j0 = j * kTileRows;
      const bool edge =
          j0 + kTileRows > Tk ||
          (causal && static_cast<long long>(kv_off) + j0 + kTileRows - 1 >
                         static_cast<long long>(q_off) + row0);
      unsigned valid = 0xffffffffu;
      float mt[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= scale;
        if (edge) {
          const int kv = j0 + acc_col(i, c0);
          const bool ok =
              kv < Tk && (!causal || static_cast<long long>(kv_off) + kv <=
                                         qpos + 8 * acc_half(i));
          if (!ok) valid &= ~(1u << i);
        }
        if ((valid >> i) & 1u) mt[acc_half(i)] = fmaxf(mt[acc_half(i)], sc[i]);
      }
      // exp on the special-function unit (ex2 of x log2 e), a fraction of
      // expf's instructions: at arguments <= 0 it errs by ~|x| 2^-24
      // relatively, far under a bf16 ulp of out and 2e-5 of lse.
      float alpha[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mt[r]));
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = ((valid >> i) & 1u) ? __expf(sc[i] - m[acc_half(i)]) : 0.0f;
        ls[acc_half(i)] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(ls[r]);
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[acc_half(i)];

      uint32_t hi[4][4], lo[4][4];
      split(sc, hi, lo);
      pin(o);
      pin(hi);
      pin(lo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bv = desc(vt + kk * 16 * 128, kTileRows * 128);
        wgmma_rs<kD>(o, hi[kk], bv);
        wgmma_rs<kD>(o, lo[kk], bv);
      }
      wg_commit();
      wg_wait_all();
      pin(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long lse_row = static_cast<long long>(blockIdx.y) * Tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + b * so.b + static_cast<long long>(row) * so.t + h * so.h + c0;
#pragma unroll
    for (int g = 0; g < kD / 8; ++g) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) = __floats2bfloat162_rn(
          o[4 * g + 2 * r] / l_safe, o[4 * g + 2 * r + 1] / l_safe);
    }
    if (lane % 4 == 0) lse[lse_row + row] = m[r] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ delta

// delta = rowsum(dO . O) - g_lse of every (b, i, h) row, kD / 8 threads a
// row, 16 bytes each; rows in (b, i, h) order, as contiguous tensors lie.
template <int kD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_sm90_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ glse,
                            float* __restrict__ delta, Strides so,
                            Strides sdo, int H, int Tq, long long rows) {
  constexpr int kLanes = kD / 8;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = g / kLanes;
  const int part = static_cast<int>(g % kLanes);
  float acc = 0.0f;
  int b = 0, i = 0, h = 0;
  if (row < rows) {
    b = static_cast<int>(row / (static_cast<long long>(Tq) * H));
    const int rest = static_cast<int>(row - static_cast<long long>(b) * Tq * H);
    i = rest / H;
    h = rest - i * H;
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + b * so.b + static_cast<long long>(i) * so.t + h * so.h + 8 * part);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + static_cast<long long>(i) * sdo.t + h * sdo.h +
        8 * part);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(xs[e]);
      const float2 c = __bfloat1622float2(ys[e]);
      acc = fmaf(c.x, a.x, acc);
      acc = fmaf(c.y, a.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < rows && part == 0) {
    const long long at = (static_cast<long long>(b) * H + h) * Tq + i;
    delta[at] = acc - (glse != nullptr ? glse[at] : 0.0f);
  }
}

// ------------------------------------------------------------------ K4'

template <int kD>
struct DkvLayout {
  static constexpr int kKVBytes = kBlockRows * kD * 2;
  static constexpr int kTileBytes = kTileRows * kD * 2;
  static constexpr int kBytes = 1024 + 2 * kKVBytes +
                                2 * kStages * kTileBytes +
                                2 * kStages * kTileRows * 4 +
                                8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Strides sdk,
                          Strides sdv, int H, int Tq, int Tk, int q_off,
                          int kv_off, bool causal, float scale) {
  using L = DkvLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ksm = align_1024(smem_raw);            // kD/64 blocks [128][64]
  uint8_t* vsm = ksm + L::kKVBytes;
  uint8_t* qs = vsm + L::kKVBytes;                // [stage] kD/64 [64][64]
  uint8_t* dos = qs + kStages * L::kTileBytes;
  float* lse_s = reinterpret_cast<float*>(dos + kStages * L::kTileBytes);
  float* delta_s = lse_s + kStages * kTileRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + kStages * kTileRows);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kv0 = blockIdx.x * kBlockRows;
  // the first q tile that sees this block's first kv row
  int i_start = 0;
  if (causal) {
    const long long first = static_cast<long long>(kv_off) + kv0 - q_off;
    i_start = static_cast<int>(max(0LL, min(static_cast<long long>(Tq), first)));
    i_start -= i_start % kTileRows;
  }
  const int n_tiles = (Tq - i_start + kTileRows - 1) / kTileRows;
  const long long lse_row = static_cast<long long>(blockIdx.y) * Tq;

  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // the producer warp, all 32 lanes
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * L::kKVBytes);
#pragma unroll
      for (int a = 0; a < kD / 64; ++a) {
        const int at = a * kBlockRows * 128;
        tma_load(ksm + at, &tk, kv_bar, 64 * a, kv0, h, b);
        tma_load(vsm + at, &tv, kv_bar, 64 * a, kv0, h, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
      const int i0 = i_start + j * kTileRows;
      for (int c = lane; c < kTileRows; c += 32) {
        const bool in = i0 + c < Tq;
        lse_s[s * kTileRows + c] = in ? lse[lse_row + i0 + c] : 0.0f;
        delta_s[s * kTileRows + c] = in ? delta[lse_row + i0 + c] : 0.0f;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
        for (int a = 0; a < kD / 64; ++a) {
          const int at = s * L::kTileBytes + a * kTileRows * 128;
          tma_load(qs + at, &tq, &full[s], 64 * a, i0, h, b);
          tma_load(dos + at, &tdo, &full[s], 64 * a, i0, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: kv rows kv_row0 .. kv_row0 + 63
  const int tw = threadIdx.x % 128;
  const int r0 = (tw / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int kv_row0 = kv0 + wg * 64;
  const long long kvpos = static_cast<long long>(kv_off) + kv_row0 + r0;

  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  if (n_tiles > 0) mbar_wait(kv_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const int i0 = i_start + j * kTileRows;
    const bool live =
        kv_row0 < Tk &&
        (!causal || static_cast<long long>(q_off) + i0 + kTileRows - 1 >=
                        static_cast<long long>(kv_off) + kv_row0);
    if (live) {
      const uint8_t* qt = qs + s * L::kTileBytes;
      const uint8_t* dot = dos + s * L::kTileBytes;
      float st[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
      pin(st);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(st, desc(kstep(ksm, kBlockRows, kk) + wg * 64 * 128, 16),
                     desc(kstep(qt, kTileRows, kk), 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(dp, desc(kstep(vsm, kBlockRows, kk) + wg * 64 * 128, 16),
                     desc(kstep(dot, kTileRows, kk), 16), 1);
      }
      wg_commit();
      wg_wait_all();
      pin(st);
      pin(dp);

      const bool edge =
          i0 + kTileRows > Tq || kv_row0 + 64 > Tk ||
          (causal && static_cast<long long>(kv_off) + kv_row0 + 63 >
                         static_cast<long long>(q_off) + i0);
      const float* ls = lse_s + s * kTileRows;
      const float* ds = delta_s + s * kTileRows;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = acc_col(i, c0);
        bool ok = true;
        if (edge) {
          ok = i0 + c < Tq && kv_row0 + r0 + 8 * acc_half(i) < Tk &&
               (!causal || kvpos + 8 * acc_half(i) <=
                               static_cast<long long>(q_off) + i0 + c);
        }
        const float p = ok ? expf(st[i] * scale - ls[c]) : 0.0f;
        st[i] = p;
        dp[i] = p * (dp[i] - ds[c]);
      }

      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      split(st, p_hi, p_lo);
      split(dp, ds_hi, ds_lo);
      pin(dk_acc);
      pin(dv_acc);
      pin(p_hi);
      pin(p_lo);
      pin(ds_hi);
      pin(ds_lo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bdo = desc(dot + kk * 16 * 128, kTileRows * 128);
        wgmma_rs<kD>(dv_acc, p_hi[kk], bdo);
        wgmma_rs<kD>(dv_acc, p_lo[kk], bdo);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bq = desc(qt + kk * 16 * 128, kTileRows * 128);
        wgmma_rs<kD>(dk_acc, ds_hi[kk], bq);
        wgmma_rs<kD>(dk_acc, ds_lo[kk], bq);
      }
      wg_commit();
      wg_wait_all();
      pin(dk_acc);
      pin(dv_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = kv_row0 + r0 + 8 * r;
    if (row >= Tk) continue;
    __nv_bfloat16* k_dst = dk + b * sdk.b + row * sdk.t + h * sdk.h + c0;
    __nv_bfloat16* v_dst = dv + b * sdv.b + row * sdv.t + h * sdv.h + c0;
#pragma unroll
    for (int g = 0; g < kD / 8; ++g) {
      const int i = 4 * g + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(k_dst + 8 * g) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(v_dst + 8 * g) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ------------------------------------------------------------------ K3'

template <int kD>
struct DqLayout {
  static constexpr int kQBytes = kBlockRows * kD * 2;
  static constexpr int kTileBytes = kTileRows * kD * 2;
  static constexpr int kBytes =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Strides sdq, int H,
                         int Tq, int Tk, int q_off, int kv_off, bool causal,
                         float scale) {
  using L = DqLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);             // kD/64 blocks [128][64]
  uint8_t* dos = qs + L::kQBytes;
  uint8_t* ks = dos + L::kQBytes;                 // [stage] kD/64 [64][64]
  uint8_t* vs = ks + kStages * L::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * L::kTileBytes);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int n_tiles =
      (kv_rows_seen(min(Tq, q0 + kBlockRows), Tk, q_off, kv_off, causal) +
       kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // the producer warp: one thread starts the loads
    if (lane != 0 || n_tiles == 0) return;
    mbar_expect_tx(q_bar, 2 * L::kQBytes);
#pragma unroll
    for (int a = 0; a < kD / 64; ++a) {
      tma_load(qs + a * kBlockRows * 128, &tq, q_bar, 64 * a, q0, h, b);
      tma_load(dos + a * kBlockRows * 128, &tdo, q_bar, 64 * a, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
      mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
      for (int a = 0; a < kD / 64; ++a) {
        const int at = s * L::kTileBytes + a * kTileRows * 128;
        tma_load(ks + at, &tk, &full[s], 64 * a, j * kTileRows, h, b);
        tma_load(vs + at, &tv, &full[s], 64 * a, j * kTileRows, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows row0 .. row0 + 63
  const int tw = threadIdx.x % 128;
  const int r0 = (tw / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int row0 = q0 + wg * 64;
  const long long qpos = static_cast<long long>(q_off) + row0 + r0;
  const int n_mine =
      row0 < Tq ? (kv_rows_seen(min(Tq, row0 + 64), Tk, q_off, kv_off,
                                causal) + kTileRows - 1) / kTileRows
                : 0;
  // lse and delta of this thread's two rows; rows past Tq are never stored
  const long long lse_row = static_cast<long long>(blockIdx.y) * Tq;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    row_lse[r] = row < Tq ? lse[lse_row + row] : 0.0f;
    row_delta[r] = row < Tq ? delta[lse_row + row] : 0.0f;
  }

  float dq_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq_acc[i] = 0.0f;
  if (n_tiles > 0) mbar_wait(q_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (j < n_mine) {
      const uint8_t* kt = ks + s * L::kTileBytes;
      const uint8_t* vt = vs + s * L::kTileBytes;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
      pin(sc);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(sc, desc(kstep(qs, kBlockRows, kk) + wg * 64 * 128, 16),
                     desc(kstep(kt, kTileRows, kk), 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(dp, desc(kstep(dos, kBlockRows, kk) + wg * 64 * 128, 16),
                     desc(kstep(vt, kTileRows, kk), 16), 1);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);

      const int j0 = j * kTileRows;
      const bool edge =
          j0 + kTileRows > Tk ||
          (causal && static_cast<long long>(kv_off) + j0 + kTileRows - 1 >
                         static_cast<long long>(q_off) + row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        bool ok = true;
        if (edge) {
          const int kv = j0 + acc_col(i, c0);
          ok = kv < Tk && (!causal || static_cast<long long>(kv_off) + kv <=
                                          qpos + 8 * acc_half(i));
        }
        const float p =
            ok ? expf(sc[i] * scale - row_lse[acc_half(i)]) : 0.0f;
        dp[i] = p * (dp[i] - row_delta[acc_half(i)]);
      }

      uint32_t hi[4][4], lo[4][4];
      split(dp, hi, lo);
      pin(dq_acc);
      pin(hi);
      pin(lo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bk = desc(kt + kk * 16 * 128, kTileRows * 128);
        wgmma_rs<kD>(dq_acc, hi[kk], bk);
        wgmma_rs<kD>(dq_acc, lo[kk], bk);
      }
      wg_commit();
      wg_wait_all();
      pin(dq_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + r0 + 8 * r;
    if (row >= Tq) continue;
    __nv_bfloat16* dst = dq + b * sdq.b + row * sdq.t + h * sdq.h + c0;
#pragma unroll
    for (int g = 0; g < kD / 8; ++g) {
      const int i = 4 * g + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) =
          __floats2bfloat162_rn(dq_acc[i] * scale, dq_acc[i + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ launch

// Everything a launch needs; pointers a kernel does not take stay null.
struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *glse, *delta;
  void *out0, *out1;  // K2': out, lse; K3': dq; K4': dk, dv; delta: delta
  const long long* strides;  // (b, t, h) of each tensor, in argument order
  int B, H, Tq, Tk, D, q_off, kv_off;
  bool causal;
  float scale;
  cudaStream_t stream;

  Strides at(int n) const {
    return Strides{strides[3 * n], strides[3 * n + 1], strides[3 * n + 2]};
  }
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map over a (B, T, H, D) bfloat16 tensor at `p` with (b, t, h)
// element strides, in boxes of 64 dims x `rows` rows, 128-byte swizzle,
// zeros past T. A dim of extent 1 may carry any stride in PyTorch; it gets
// the contiguous one. TMA takes strides that are multiples of 16 bytes and
// a 16-byte-aligned address (the wrapper checks both).
bool make_map(CUtensorMap* map, const void* p, Strides s, int B, int T,
              int H, int D, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long st = T == 1 ? static_cast<long long>(H) * D : s.t;
  const long long sh = H == 1 ? D : s.h;
  const long long sb = B == 1 ? static_cast<long long>(T) * H * D : s.b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kD>
cudaError_t run_fwd(const Args& a) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kD, kBlockRows) ||
      !make_map(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kD, kTileRows) ||
      !make_map(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kD, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_sm90_kernel<kD>;
  constexpr int smem = FwdLayout<kD>::kBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBlockRows - 1) / kBlockRows, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.out0),
      static_cast<float*>(a.out1), a.at(3), a.H, a.Tq, a.Tk, a.q_off,
      a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_dkv(const Args& a) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kD, kTileRows) ||
      !make_map(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kD, kBlockRows) ||
      !make_map(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kD, kBlockRows) ||
      !make_map(&mdo, a.dout, a.at(3), a.B, a.Tq, a.H, kD, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dkv_sm90_kernel<kD>;
  constexpr int smem = DkvLayout<kD>::kBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kBlockRows - 1) / kBlockRows, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.at(4), a.at(5), a.H, a.Tq, a.Tk,
      a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_dq(const Args& a) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kD, kBlockRows) ||
      !make_map(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kD, kTileRows) ||
      !make_map(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kD, kTileRows) ||
      !make_map(&mdo, a.dout, a.at(3), a.B, a.Tq, a.H, kD, kBlockRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dq_sm90_kernel<kD>;
  constexpr int smem = DqLayout<kD>::kBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBlockRows - 1) / kBlockRows, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      a.at(4), a.H, a.Tq, a.Tk, a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.Tq * a.H;
  const long long threads = rows * (kD / 8);
  const int per_block = 256;
  flash_bwd_delta_sm90_kernel<kD>
      <<<static_cast<unsigned>((threads + per_block - 1) / per_block),
         per_block, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.o),
          static_cast<const __nv_bfloat16*>(a.dout),
          static_cast<const float*>(a.glse), static_cast<float*>(a.out0),
          a.at(0), a.at(1), a.H, a.Tq, rows);
  return cudaGetLastError();
}

typedef cudaError_t (*Run)(const Args&);

// `d64` for bfloat16 (dtype code 1) at D 64, `d128` at D 128 where there is
// one; anything else is refused.
int dispatch(int dtype, const Args& a, Run d64, Run d128) {
  Run run = nullptr;
  if (dtype == 1 && a.D == 64) run = d64;
  if (dtype == 1 && a.D == 128) run = d128;
  return static_cast<int>(run != nullptr ? run(a) : cudaErrorInvalidValue);
}

// D^-0.5 as the reference computes it: in double, then rounded to float32
float scale_of(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns its
// cudaError_t (0 on success). `strides` holds the (b, t, h) element
// strides of the tensors in argument order. dtype must be 1 (bfloat16) and
// D 64 (or 128, for all but K4').

int flash_fwd_sm90(int dtype, const void* q, const void* k, const void* v,
                   void* out, void* lse, const long long* strides, int B,
                   int H, int Tq, int Tk, int D, int q_off, int kv_off,
                   int causal, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr,
               out, lse, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, a, run_fwd<64>, run_fwd<128>);
}

// delta (B, H, Tq) = rowsum(dout . out) - g_lse; glse may be null (0).
// Strides: out, dout.
int flash_bwd_delta_sm90(int dtype, const void* out, const void* dout,
                         const void* glse, void* delta,
                         const long long* strides, int B, int H, int Tq,
                         int D, void* stream) {
  const Args a{nullptr, nullptr, nullptr, out, dout, nullptr, glse, nullptr,
               delta, nullptr, strides, B, H, Tq, 0, D, 0, 0,
               false, 0.0f, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, a, run_delta<64>, run_delta<128>);
}

// dK, dV from q, k, v, dout, lse and the delta pass's output. Strides: q,
// k, v, dout, dk, dv.
int flash_bwd_dkv_sm90(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int H, int Tq, int Tk, int D, int q_off, int kv_off,
                       int causal, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, nullptr, delta,
               dk, dv, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, a, run_dkv<64>, nullptr);
}

// dQ from q, k, v, dout, lse and the delta pass's output. Strides: q, k, v,
// dout, dq.
int flash_bwd_dq_sm90(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const long long* strides, int B, int H,
                      int Tq, int Tk, int D, int q_off, int kv_off,
                      int causal, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, nullptr, delta,
               dq, nullptr, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, a, run_dq<64>, run_dq<128>);
}

// Dynamic shared memory a launch of K2' (kernel 0), K4' (kernel 1) or K3'
// (kernel 2) asks for at head dim D, or -1 where that kernel is not built.
// ptxas does not report dynamic shared memory; chip_smoke.py prints this
// beside it.
int flash_sm90_shared_bytes(int kernel, int D) {
  if (kernel == 0 && D == 64) return FwdLayout<64>::kBytes;
  if (kernel == 0 && D == 128) return FwdLayout<128>::kBytes;
  if (kernel == 1 && D == 64) return DkvLayout<64>::kBytes;
  if (kernel == 2 && D == 64) return DqLayout<64>::kBytes;
  if (kernel == 2 && D == 128) return DqLayout<128>::kBytes;
  return -1;
}

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash attention on Hopper's tensor cores: the forward (K2'), dQ (K3') and
// dK/dV (K4') for bfloat16 with D = 16, 32, 64 or 128, the pass that
// writes the delta K3' and K4' read (bfloat16 and float32), and for
// float32 with D = 16, 32 or 64 the forward (K2-tf32), dQ (K3-tf32) and
// dK/dV (K4-tf32) in 3xTF32 products.
//
// Replaces, for those inputs, elasticdl_tpu/ops/pallas_attention.py
// `_fwd_kernel` (`pallas_call` at 256), `_bwd_dq_kernel` (`pallas_call` at
// 404) and `_bwd_dkv_kernel` (`pallas_call` at 433). csrc/flash_attention.cu
// keeps every other case (float32 at D 128 and other head dims, bfloat16
// at other head dims).
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
//   K3', kv rows in K4'; K4' at D 16 and 128 and K3' at D 16 and 32 have
//   one) and one producer warp,
//   which brings the streamed tiles (K, V in K2' and K3'; Q, dO in K4') in
//   by TMA, 64 rows a tile, into a ring of kStages stages guarded by
//   full/empty mbarriers. Tiles land in the swizzle the wgmma descriptors
//   read (`Cols`): D = 64 bf16 is one 128-byte row in the 128-byte
//   swizzle, D = 128 two such column blocks, D = 32 one 64-byte row in the
//   64-byte swizzle and D = 16 one 32-byte row in the 32-byte swizzle (TMA
//   takes no box wider than its swizzle). Tails past T come as zeros from
//   TMA's out-of-bounds fill and are masked.
// - Narrow heads (D 16, 32). S = Q.K^T, dP = dO.V^T and their transposes
//   keep N = 64 and take one or two k16 steps; P.V, P^T.dO, dS^T.Q and
//   dS.K are m64n16k16 or m64n32k16 products into 8 or 16 accumulator
//   floats a thread. The tensor work per score is a quarter (D 16) or a
//   half (D 32) of D 64's while the exp, max, rescale and hi/lo split per
//   score stay, so these bind on the softmax's CUDA-core work and on
//   latency, not on the tensor cores. Registers set their blocks
//   (`FwdLayout`, `DkvShape`, `DqShape`): K2' fits two blocks a SM in 96
//   registers a thread, K4' at D 16 three one-warpgroup blocks in 128,
//   K3' at D 16 and 32 the same in 106 and 115; K4' at D 32 keeps D 64's
//   two warpgroups, one block.
// - Registers. ptxas gives 168 a thread to a block of 288 threads. K2'
//   needs ~2 x 32 (D 64) or 32 + 64 (D 128) floats of accumulators, K3'
//   3 x 32 (D 64) or 2 x 32 + 64 (D 128), K4' at D 64 4 x 32; all of these
//   fit (K4' at D 64 with 4 bytes of spill). K4' at D 128 holds 2 x 64
//   (dK, dV) + 2 x 32 (S^T, dP^T, then their split fragments), which
//   spills at 168, also in a 384-thread block whose producer warpgroup
//   gives registers to the consumers with setmaxnreg: ptxas still
//   allocates 168. So K4' at D 128 runs one
//   consumer warpgroup of 64 kv rows and the producer warp, 160 threads,
//   for which ptxas allows 255 a thread (it takes 253, no spill), over
//   twice the blocks.
// - K2'. S = Q.K^T (shared-memory A and B, both K-major) into registers;
//   the online softmax runs on the accumulator's own layout (a thread holds
//   two rows, quad shuffles reduce them); p goes straight into register A
//   fragments as hi and lo; O += P.V reads V MN-major through the transpose
//   bit. O / l is rounded to bf16 once.
// - K3'. K2''s loop with one product more: a block owns 128 q rows (64 at
//   D 16 and 32; Q and dO loaded once), lse and delta of its rows sit in
//   registers, and the K and V tiles stream through the ring. S = Q.K^T
//   and dP = dO.V^T on wgmma (all K-major); p = exp(s - lse),
//   ds = p (dp - delta) on the accumulator layout; dQ += dS.K with dS as
//   split register A fragments and K MN-major through the transpose bit,
//   as V in K2''s P.V. dQ times the scale is rounded to bf16 once; each
//   row has one writer.
// - K4'. A block owns 128 kv rows (64 at D 128; K, V loaded once) and
//   walks the q tiles from the first one the causal mask lets through.
//   S^T = K.Q^T and dP^T = V.dO^T on wgmma; p^T = exp(s^T - lse),
//   ds^T = p^T (dp^T - delta); dV += P^T.dO and dK += dS^T.Q with split A
//   operands; dK and dV stay in registers and each output row has one
//   writer: no atomics, runs are bit-reproducible.
// - delta = rowsum(dO . O) - g_lse is computed once a row by
//   flash_bwd_delta_sm90, once a backward, and read by both K3' and K4'
//   (bf16 O and dO) or K3-tf32 and K4-tf32 (float32); K3 and K4
//   recompute it from O in every block.
// - Causal tiles wholly above the diagonal are not visited: the bounds come
//   from the runtime offsets. K2' and K3' start the blocks with the most
//   tiles first.
// - K2-tf32, K2 for float32. In float32 every product of the reference
//   has float32 operands (q.k and p.v), which no bf16 wgmma holds, and a
//   single TF32 product errs by ~2^-11, 25x the 2e-5 that out and lse are
//   held to. So each float32 operand x is split into hi = tf32(x)
//   (cvt.rna, low 13 bits cleared) and lo = tf32(x - hi), and a.b is
//   summed as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on `wgmma ... k8.tf32`,
//   accumulated in float32: the dropped lo_a.lo_b and the rounding of the
//   two lo are <= 3 2^-22 |a b| (~7e-7 relative a product). A score of
//   D terms errs by at most ~7e-7 x the sum of its |q_i k_i| D^-0.5,
//   which moves p by that relative part and lse by that absolute amount.
//   Emulated on the CPU at this kernel's tile (64 x 64, D 64, unit-normal
//   inputs; tests/test_torch_flash_attention.py), the split's q.k^T and
//   p.v spend 0.8% and 0.3% of the 2e-5 bound (rtol and atol of the
//   largest entry); one TF32 product spends 13x and 8.5x it.
//   Layouts: a float32 row of D dims has the bytes of a bf16 row of 2D,
//   so Cols<2D> gives Q's, K's and V's TMA swizzles and descriptors, and a
//   k8 TF32 step is 32 bytes, as a k16 bf16 step is. TF32 wgmma reads
//   shared-memory operands K-major only: Q and K are K-major as they lie,
//   V is not, so each V tile is written transposed (V^T, kv contiguous).
//   The accumulator of S gives thread t of a quad kv columns 2t and
//   2t + 1 of each k8 step where a TF32 A fragment wants t and t + 4; the
//   fragment is taken as it lies and V^T's kv columns are written in the
//   matching order (`pv_slot`), so p needs no shuffle. A block is two
//   consumer warpgroups of 64 q rows and a producer warpgroup (384
//   threads, 168 registers each): its warp 0 lands Q once and K and V a
//   stage at a time by TMA; its warps 1-3 split Q once (hi in place, lo
//   beside it) and each stage (K hi in place, K lo, V^T hi and lo in
//   Cols<128>'s swizzle), while the consumers run the previous stage's
//   products. The consumers wait on barriers, run 3 D/8 k8 products for S
//   and 24 for O a tile, K2''s online softmax, and split p into hi and lo
//   register fragments (at D 64 half of them at a time, two commit groups
//   of 12 products: all of them beside O spilled 64 bytes at 168
//   registers). Every operand's descriptor is its tile's base descriptor
//   plus a constant. Shared memory at D 64: Q hi + lo 64 KB, a stage
//   5 x 16 KB, two stages: 224 KB of 227 (D 128 would need 5 x 32 KB a
//   stage and stays on K2).
// - K4-tf32 and K3-tf32, K4' and K3' for float32, with K2-tf32's split
//   and producer warpgroup. K4-tf32: S^T = K.Q^T and dP^T = V.dO^T with K
//   and V as A and the streamed Q and dO as B, all K-major as TMA lands
//   them (hi in place, lo beside); dV += P^T.dO and dK += dS^T.Q with P^T
//   and dS^T as register A fragments taken as the accumulator lies, and
//   dO^T and Q^T written transposed and split, q in `pv_slot` order
//   (`split_and_transpose`). K3-tf32: S = Q.K^T and dP = dO.V^T the same
//   way, dQ += dS.K with K^T written as dO^T is. Every product is 3xTF32,
//   13 a k8 step pair where K4' runs 4 bf16 ones. Shared memory binds:
//   at D 64 a 64-row float32 tile is 16 KB, and a 64-row stage of K4-tf32
//   (Q, dO, their lo, Q^T and dO^T hi and lo) would be 128 KB beside 64 KB
//   of resident K and V. So both stream 32-row tiles (64 KB a K4-tf32
//   stage, 48 KB a K3-tf32 one, two stages) past consumer warpgroups of
//   64 resident rows and the producer warpgroup. K4-tf32 has one consumer
//   (256 threads, for which ptxas allows 255 registers at D 32 and 64: dK
//   and dV take 2 x 32 floats at D 64, the split fragments 64 words), in
//   two blocks a SM at D 16; K3-tf32 two, which share each K/V stage's
//   split and overlap each other's softmax (`DkvTf32Shape`,
//   `DqTf32Shape`). They read the float32 delta pass's delta.
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

// How a tile of kD bf16 columns lies in shared memory: kBlocks column
// blocks of [rows][kCols], each row kRowBytes long, in the TMA swizzle of
// that width (32, 64 or 128 bytes), which the wgmma descriptors name by
// their layout type (3, 2 or 1: cute's GMMA::LayoutType B32, B64, B128).
template <int kD>
struct Cols {
  static_assert(kD == 16 || kD == 32 || kD == 64 || kD == 128,
                "the Hopper kernels are built at D 16, 32, 64 and 128");
  static constexpr int kCols = kD < 64 ? kD : 64;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kBlocks = kD / kCols;
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128   ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B;
};

// wgmma descriptor of an operand in Cols<kD>'s swizzled rows (the TMA
// layout): start address, leading and stride byte offsets (in 16 bytes),
// layout type. The stride byte offset is 8 rows (1024, 512 or 256 bytes),
// from one group of 8 rows to the next: along M or N of a K-major
// operand, along K of an MN-major one. K-major operands ignore the leading
// offset; MN-major ones (N = D) take the distance between the two 64-column
// blocks of a D = 128 tile (cute's make_gmma_desc: Major::MN swizzled
// layouts ((T,w,m),(8,k)) : ((1,T,LBO),(wT,SBO))).
template <int kD>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lead_bytes) {
  using C = Cols<kD>;
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lead_bytes >> 4) << 16 |
         static_cast<uint64_t>(8 * C::kRowBytes >> 4) << 32 |
         C::kLayout << 62;
}

// Byte offset of step kk (16 dims, 32 bytes) of a K-major tile of `rows`
// rows in Cols<kD>'s layout: its column block and its 32 bytes inside each
// row (the swizzle is applied to the address, so a step inside the row
// moves the start address only). A 32-byte row (D 16) is one step.
template <int kD>
__device__ __forceinline__ int kstep_bytes(int rows, int kk) {
  using C = Cols<kD>;
  constexpr int kSteps = C::kCols / 16;  // k16 steps a row
  return (kk / kSteps) * rows * C::kRowBytes + (kk % kSteps) * 32;
}

template <int kD>
__device__ __forceinline__ const uint8_t* kstep(const uint8_t* tile, int rows,
                                                int kk) {
  return tile + kstep_bytes<kD>(rows, kk);
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
template <int M>
__device__ __forceinline__ void pin(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
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

// d (64 x 16) += A (64 x 16) . B (16 x 16): A from registers, B from
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 16) . B (16 x 32): A from registers, B from
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// d (64 x kD) += A . B with N = kD, the products into O, dQ, dK and dV.
template <int kD>
__device__ __forceinline__ void wgmma_rs(float (&d)[kD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(kD == 16 || kD == 32 || kD == 64 || kD == 128,
                "wgmma_rs is written for N = 16, 32, 64 and 128");
  if constexpr (kD == 16) {
    wgmma_rs_n16(d, a, b);
  } else if constexpr (kD == 32) {
    wgmma_rs_n32(d, a, b);
  } else if constexpr (kD == 64) {
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

__device__ __forceinline__ void init_barriers(uint64_t* bars,
                                              int consumers = kConsumers) {
  // bars[0]: the block's resident tiles; then kStages full, kStages empty
  mbar_init(&bars[0], 1);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&bars[1 + s], 1);
    mbar_init(&bars[1 + kStages + s], 4 * consumers);  // a warp each
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ------------------------------------------------------------------ K2'

template <int kD>
struct FwdLayout {
  // Blocks a SM that ptxas must fit: two at D 16 and 32 (96 registers a
  // thread, no spill; the second block's warpgroups run their softmax
  // while the first's wait on their products), one at D 64 and 128.
  static constexpr int kMinBlocks = kD < 64 ? 2 : 1;
  static constexpr int kQBytes = kBlockRows * kD * 2;
  static constexpr int kTileBytes = kTileRows * kD * 2;
  static constexpr int kBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, FwdLayout<kD>::kMinBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, Strides so, int H, int Tq,
                      int Tk, int q_off, int kv_off, bool causal,
                      float scale) {
  using L = FwdLayout<kD>;
  using C = Cols<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);  // kBlocks x [128][kCols]
  uint8_t* ks = qs + L::kQBytes;  // [stage] kBlocks x [64][kCols]
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
    for (int a = 0; a < C::kBlocks; ++a) {
      tma_load(qs + a * kBlockRows * C::kRowBytes, &tq, q_bar, C::kCols * a,
               q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
      mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a) {
        const int at = s * L::kTileBytes + a * kTileRows * C::kRowBytes;
        tma_load(ks + at, &tk, &full[s], C::kCols * a, j * kTileRows, h, b);
        tma_load(vs + at, &tv, &full[s], C::kCols * a, j * kTileRows, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows row0 .. row0 + 63, at byte `mine` of each
  // column block of the resident tiles
  const int tw = threadIdx.x % 128;
  const int mine = wg * 64 * C::kRowBytes;
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
        wgmma_ss_n64(sc, desc<kD>(kstep<kD>(qs + mine, kBlockRows, kk), 16),
                     desc<kD>(kstep<kD>(kt, kTileRows, kk), 16), 1);
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
        const uint64_t bv = desc<kD>(vt + kk * 16 * C::kRowBytes,
                                      kTileRows * C::kRowBytes);
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

// ------------------------------------------------------------- K2-tf32

// A float32 x as tf32 in a float32 word: cvt.rna.tf32.f32 (round to
// nearest, ties away from zero, to 10 mantissa bits), with the low 13 bits
// cleared explicitly, so that what the tensor core reads does not depend
// on how it treats them.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi); x - hi is
// exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads) once a barrier orders them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte offset `o` of a row-major tile of kRowBytes-long rows, in the TMA
// swizzle of that width (cute's Swizzle<3,4,3>, <2,4,3>: the 16-byte chunk
// index XOR the row group bits 7-9 or 7-8), from a 1024-aligned base.
template <int kRowBytes>
__device__ __forceinline__ uint32_t swizzled(uint32_t o) {
  static_assert(kRowBytes == 64 || kRowBytes == 128,
                "K2-tf32 reads 64- and 128-byte rows");
  constexpr uint32_t kMask = kRowBytes == 128 ? 7u : 3u;
  return o ^ (((o >> 7) & kMask) << 4);
}

// d (64 x 64) = A (64 x 8) . B (8 x 64) + d in TF32: A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 32) = A (64 x 8) . B (8 x 32) + d in TF32: A and B from shared
// memory, both K-major (K3-tf32's S and dP, K4-tf32's S^T and dP^T over a
// 32-row tile).
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 16) += A (64 x 8) . B (8 x 16) in TF32: A from registers (a
// k8 fragment), B from shared memory, K-major (TF32 has no transpose bit).
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 8) . B (8 x 32) in TF32, as wgmma_tf32_rs_n16.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 8) . B (8 x 64) in TF32, as wgmma_tf32_rs_n16.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// d (64 x kD) += A . B in TF32 with N = kD: the products into O.
template <int kD>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[kD / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  static_assert(kD == 16 || kD == 32 || kD == 64,
                "the TF32 kernels are built at D 16, 32 and 64");
  if constexpr (kD == 16) {
    wgmma_tf32_rs_n16(d, a, b);
  } else if constexpr (kD == 32) {
    wgmma_tf32_rs_n32(d, a, b);
  } else {
    wgmma_tf32_rs_n64(d, a, b);
  }
}

// `kstep_bytes` in a descriptor's start-address units (16 bytes): every
// K2-tf32 operand's descriptor is its tile's base descriptor plus one.
template <int kD>
__device__ __forceinline__ uint64_t kstep_desc(int rows, int kk) {
  return static_cast<uint64_t>(kstep_bytes<kD>(rows, kk) >> 4);
}

// The slot of kv row `kv` inside its k8 step of P.V. A TF32 A fragment
// puts columns t and t + 4 of a k8 step in thread t % 4 of a quad; the
// accumulator of S holds columns 2t and 2t + 1 there. So the accumulator
// is used as the A fragment as it lies (logical column t <- kv 2t, t + 4
// <- kv 2t + 1), and V^T's columns are written in that order: kv 2c sits
// in slot c and kv 2c + 1 in slot c + 4.
__device__ __forceinline__ int pv_slot(int kv) {
  return (kv & ~7) | ((kv & 1) << 2) | ((kv & 7) >> 1);
}

constexpr int kTf32Threads = 128 * (kConsumers + 1);  // + a producer wg
constexpr int kSplitThreads = 96;  // the producer wg's warps 1-3

// K2-tf32's shared memory at head dim kD. A float32 row of kD dims has the
// bytes of a bf16 row of 2 kD, so Cols<2 kD> lays out Q, K and V as TMA
// lands them (D 16: one 64-byte row in the 64-byte swizzle; D 32 one
// 128-byte row; D 64 two 128-byte column blocks), and one k8 TF32 step is
// 32 bytes, as one k16 bf16 step is. V^T (kD rows of 64 kv floats) is
// Cols<128>: two 128-byte column blocks of 32 kv.
template <int kD>
struct Tf32Layout {
  using C = Cols<2 * kD>;
  // k8 steps of P.V a commit group: all eight at D 16 and 32; at D 64 four
  // twice, so that p's hi and lo fragments of one group (32 registers, not
  // 64) beside O's 32 fit 168 registers without a spill
  static constexpr int kPvSteps = kD == 64 ? 4 : 8;
  // its ring depth, pinned at two: two stages fill 230,464 of the 232,448
  // bytes a block may take at D 64, which leaves no room for a third
  // (another 81,920 bytes)
  static constexpr int kRing = 2;
  static constexpr int kQBytes = kBlockRows * kD * 4;     // each of hi, lo
  static constexpr int kTileBytes = kTileRows * kD * 4;   // each of five
  // a stage: K (split to hi in place), K lo, V as loaded, V^T hi, V^T lo
  static constexpr int kStageBytes = 5 * kTileBytes;
  static constexpr int kBars = 2 + 3 * kRing;
  static constexpr int kBytes =
      1024 + 2 * kQBytes + kRing * kStageBytes + 8 * kBars;
};
static_assert(Tf32Layout<64>::kBytes <= 232448,
              "K2-tf32 at D 64 must fit a block's 227 KB");

// Split the `chunks` 16-byte chunks at `hi` into tf32 hi (in place) and lo
// (at the same offsets of `lo`): an elementwise map, so the TMA swizzle
// of the tile carries over.
__device__ __forceinline__ void split_in_place(uint8_t* hi, uint8_t* lo,
                                               int chunks, int t) {
  for (int c = t; c < chunks; c += kSplitThreads) {
    uint4 x = *reinterpret_cast<const uint4*>(hi + 16 * c);
    uint4 h, l;
    split_tf32(__uint_as_float(x.x), h.x, l.x);
    split_tf32(__uint_as_float(x.y), h.y, l.y);
    split_tf32(__uint_as_float(x.z), h.z, l.z);
    split_tf32(__uint_as_float(x.w), h.w, l.w);
    *reinterpret_cast<uint4*>(hi + 16 * c) = h;
    *reinterpret_cast<uint4*>(lo + 16 * c) = l;
  }
}

// V (64 kv rows of kD floats, as TMA landed it) into V^T hi and lo: kD
// rows of 64 kv, K-major for the TF32 B operand, kv in `pv_slot` order, in
// Cols<128>'s swizzle. A warp takes 32 neighbouring kv rows of one 16-byte
// chunk: its reads hit 8 swizzled chunks a quarter-warp and its 4-byte
// writes 32 words of one row, so neither conflicts on a bank.
template <int kD>
__device__ __forceinline__ void split_transposed(const uint8_t* v,
                                                 uint8_t* th, uint8_t* tl,
                                                 int t) {
  using C = Cols<2 * kD>;
  constexpr int kChunks = kTileRows * kD / 4;
  for (int c = t; c < kChunks; c += kSplitThreads) {
    const int kv = c % kTileRows;
    const int col = 16 * (c / kTileRows);  // byte of the row: dims col / 4..
    const uint4 x = *reinterpret_cast<const uint4*>(
        v + (col / C::kRowBytes) * kTileRows * C::kRowBytes +
        swizzled<C::kRowBytes>(kv * C::kRowBytes + col % C::kRowBytes));
    const int slot = pv_slot(kv);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // V^T row col / 4 + e, column `slot`
      const uint32_t o = (slot / 32) * kD * 128 +
                         swizzled<128>((col / 4 + e) * 128 + 4 * (slot % 32));
      uint32_t h, l;
      split_tf32(__uint_as_float(xs[e]), h, l);
      *reinterpret_cast<uint32_t*>(th + o) = h;
      *reinterpret_cast<uint32_t*>(tl + o) = l;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_fwd_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ out, float* __restrict__ lse,
                           Strides so, int H, int Tq, int Tk, int q_off,
                           int kv_off, bool causal, float scale) {
  using L = Tf32Layout<kD>;
  using C = typename L::C;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);  // Q, then its hi: kBlocks x [128][..]
  uint8_t* q_lo = qs + L::kQBytes;
  uint8_t* stages = q_lo + L::kQBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + L::kRing * L::kStageBytes);
  uint64_t* q_bar = bars;        // Q landed
  uint64_t* q_split = bars + 1;  // Q split into hi and lo
  uint64_t* loaded = bars + 2;   // a stage's K and V landed
  uint64_t* full = bars + 2 + L::kRing;  // ... and split
  uint64_t* empty = bars + 2 + 2 * L::kRing;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int n_tiles =
      (kv_rows_seen(min(Tq, q0 + kBlockRows), Tk, q_off, kv_off, causal) +
       kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    mbar_init(q_split, kSplitThreads / 32);
#pragma unroll
    for (int s = 0; s < L::kRing; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], kSplitThreads / 32);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // the producer warpgroup
    if (n_tiles == 0) return;
    const int t = threadIdx.x % 128 - 32;
    if (t < 0) {  // warp 0: one thread starts the loads
      if (lane != 0) return;
      mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a) {
        tma_load(qs + a * kBlockRows * C::kRowBytes, &tq, q_bar,
                 C::kRowBytes / 4 * a, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::kRing;
        uint8_t* st = stages + s * L::kStageBytes;
        if (j >= L::kRing) {
          mbar_wait(&empty[s], (j / L::kRing - 1) & 1);
        }
        mbar_expect_tx(&loaded[s], 2 * L::kTileBytes);
#pragma unroll
        for (int a = 0; a < C::kBlocks; ++a) {
          const int at = a * kTileRows * C::kRowBytes;
          tma_load(st + at, &tk, &loaded[s], C::kRowBytes / 4 * a,
                   j * kTileRows, h, b);
          tma_load(st + 2 * L::kTileBytes + at, &tv, &loaded[s],
                   C::kRowBytes / 4 * a, j * kTileRows, h, b);
        }
      }
      return;
    }
    // warps 1-3 split what landed: Q once, then K and V a stage at a time
    mbar_wait(q_bar, 0);
    split_in_place(qs, q_lo, L::kQBytes / 16, t);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_split);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kRing;
      uint8_t* st = stages + s * L::kStageBytes;
      mbar_wait(&loaded[s], (j / L::kRing) & 1);
      split_in_place(st, st + L::kTileBytes, L::kTileBytes / 16, t);
      split_transposed<kD>(st + 2 * L::kTileBytes, st + 3 * L::kTileBytes,
                           st + 4 * L::kTileBytes, t);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // a consumer warpgroup: q rows row0 .. row0 + 63, at byte `mine` of each
  // column block of Q's hi and lo
  const int tw = threadIdx.x % 128;
  const int mine = wg * 64 * C::kRowBytes;
  const int r0 = (tw / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int row0 = q0 + wg * 64;
  const long long qpos = static_cast<long long>(q_off) + row0 + r0;
  const int n_mine =
      row0 < Tq ? (kv_rows_seen(min(Tq, row0 + 64), Tk, q_off, kv_off,
                                causal) + kTileRows - 1) / kTileRows
                : 0;

  const uint64_t q_hi = desc<2 * kD>(qs + mine, 16);
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.0f, 0.0f};
  if (n_tiles > 0) mbar_wait(q_split, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kRing;
    mbar_wait(&full[s], (j / L::kRing) & 1);
    if (j < n_mine) {
      const uint8_t* st = stages + s * L::kStageBytes;
      // descriptors of K hi and V^T hi; K lo and V^T lo lie one and two
      // tiles past them, Q lo one Q past Q hi
      const uint64_t k_hi = desc<2 * kD>(st, 16);
      const uint64_t vt_hi = desc<128>(st + 3 * L::kTileBytes, 16);
      constexpr uint64_t kLo = L::kTileBytes >> 4, kQLo = L::kQBytes >> 4;
      // S = Q.K^T as Q_lo.K_hi + Q_hi.K_lo + Q_hi.K_hi, k8 steps
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      pin(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        const uint64_t qh = q_hi + kstep_desc<2 * kD>(kBlockRows, kk);
        const uint64_t kh = k_hi + kstep_desc<2 * kD>(kTileRows, kk);
        wgmma_tf32_ss_n64(sc, qh + kQLo, kh);
        wgmma_tf32_ss_n64(sc, qh, kh + kLo);
        wgmma_tf32_ss_n64(sc, qh, kh);
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

      // O += P.V as P_lo.V_hi + P_hi.V_lo + P_hi.V_hi, kPvSteps k8 steps
      // a commit group. p goes into A fragments (`pv_slot`), hi and lo:
      // step kk's are accumulator elements 4 kk, 4 kk + 2, 4 kk + 1 and
      // 4 kk + 3 (rows r0, r0 + 8 at kv 2t; rows r0, r0 + 8 at kv 2t + 1)
      constexpr int kPv = L::kPvSteps;
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += kPv) {
        uint32_t hi[kPv][4], lo[kPv][4];
#pragma unroll
        for (int kk = 0; kk < kPv; ++kk) {
          const int i = 4 * (k0 + kk);
          split_tf32(sc[i], hi[kk][0], lo[kk][0]);
          split_tf32(sc[i + 2], hi[kk][1], lo[kk][1]);
          split_tf32(sc[i + 1], hi[kk][2], lo[kk][2]);
          split_tf32(sc[i + 3], hi[kk][3], lo[kk][3]);
        }
        pin(o);
        pin(hi);
        pin(lo);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kPv; ++kk) {
          const uint64_t vh = vt_hi + kstep_desc<128>(kD, k0 + kk);
          wgmma_tf32_rs<kD>(o, lo[kk], vh);
          wgmma_tf32_rs<kD>(o, hi[kk], vh + kLo);
          wgmma_tf32_rs<kD>(o, hi[kk], vh);
        }
        wg_commit();
        wg_wait_all();
        pin(o);
      }
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
    float* dst =
        out + b * so.b + static_cast<long long>(row) * so.t + h * so.h + c0;
#pragma unroll
    for (int g = 0; g < kD / 8; ++g) {
      *reinterpret_cast<float2*>(dst + 8 * g) =
          make_float2(o[4 * g + 2 * r] / l_safe, o[4 * g + 2 * r + 1] / l_safe);
    }
    if (lane % 4 == 0) lse[lse_row + row] = m[r] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ delta

// delta = rowsum(dO . O) - g_lse of every (b, i, h) row of bfloat16 or
// float32 `T`, 16 bytes a thread (8 bf16 or 4 floats), so kD / 8 or kD / 4
// threads a row; rows in (b, i, h) order, as contiguous tensors lie.
template <int kD, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_sm90_kernel(const T* __restrict__ o,
                            const T* __restrict__ dout,
                            const float* __restrict__ glse,
                            float* __restrict__ delta, Strides so,
                            Strides sdo, int H, int Tq, long long rows) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kLanes = kD / kPer;
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
        o + b * so.b + static_cast<long long>(i) * so.t + h * so.h +
        kPer * part);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + static_cast<long long>(i) * sdo.t + h * sdo.h +
        kPer * part);
    if constexpr (kPer == 8) {
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xs[e]);
        const float2 c = __bfloat1622float2(ys[e]);
        acc = fmaf(c.x, a.x, acc);
        acc = fmaf(c.y, a.y, acc);
      }
    } else {
      acc = fmaf(__uint_as_float(y.x), __uint_as_float(x.x), acc);
      acc = fmaf(__uint_as_float(y.y), __uint_as_float(x.y), acc);
      acc = fmaf(__uint_as_float(y.z), __uint_as_float(x.z), acc);
      acc = fmaf(__uint_as_float(y.w), __uint_as_float(x.w), acc);
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

// A block of `consumers` warpgroups of 64 rows each and one producer
// warp, of which ptxas must fit `blocks` a SM in registers.
template <int consumers, int blocks>
struct BlockShape {
  static constexpr int kConsumers = consumers;
  static constexpr int kMinBlocks = blocks;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kRows = 64 * kConsumers;
};

// K4''s consumer warpgroups of 64 kv rows each, and the blocks a SM that
// ptxas must fit in registers. One producer warp either way.
// - D 32 and 64: two warpgroups, as in K2', one block a SM (168
//   registers a thread).
// - D 128: one warpgroup, where the block's 160 threads may take 255
//   registers a thread (see Registers above).
// - D 16: one warpgroup and three blocks a SM, 128 registers a thread
//   with no spill: three warpgroups share a SM where D 32's layout gives
//   two, so one's products overlap another's softmax (0.135 against
//   0.171 ms at B8 T1024 H8 on an H100). D 32 spills in that layout.
template <int kD>
using DkvShape =
    BlockShape<(kD == 32 || kD == 64 ? 2 : 1), (kD == 16 ? 3 : 1)>;

template <int kD>
struct DkvLayout {
  static constexpr int kKVBytes = DkvShape<kD>::kRows * kD * 2;
  static constexpr int kTileBytes = kTileRows * kD * 2;
  static constexpr int kBytes = 1024 + 2 * kKVBytes +
                                2 * kStages * kTileBytes +
                                2 * kStages * kTileRows * 4 +
                                8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(DkvShape<kD>::kThreads,
                                  DkvShape<kD>::kMinBlocks)
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
  using C = Cols<kD>;
  using S = DkvShape<kD>;
  constexpr int kBlockRows = S::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ksm = align_1024(smem_raw);  // kBlocks x [rows][kCols]
  uint8_t* vsm = ksm + L::kKVBytes;
  uint8_t* qs = vsm + L::kKVBytes;  // [stage] kBlocks x [64][kCols]
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

  if (threadIdx.x == 0) init_barriers(bars, S::kConsumers);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == S::kConsumers) {  // the producer warp, all 32 lanes
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * L::kKVBytes);
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a) {
        const int at = a * kBlockRows * C::kRowBytes;
        tma_load(ksm + at, &tk, kv_bar, C::kCols * a, kv0, h, b);
        tma_load(vsm + at, &tv, kv_bar, C::kCols * a, kv0, h, b);
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
        for (int a = 0; a < C::kBlocks; ++a) {
          const int at = s * L::kTileBytes + a * kTileRows * C::kRowBytes;
          tma_load(qs + at, &tq, &full[s], C::kCols * a, i0, h, b);
          tma_load(dos + at, &tdo, &full[s], C::kCols * a, i0, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: kv rows kv_row0 .. kv_row0 + 63, at byte `mine`
  // of each column block of the resident tiles
  const int tw = threadIdx.x % 128;
  const int mine = wg * 64 * C::kRowBytes;
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
        wgmma_ss_n64(st, desc<kD>(kstep<kD>(ksm + mine, kBlockRows, kk), 16),
                     desc<kD>(kstep<kD>(qt, kTileRows, kk), 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(dp, desc<kD>(kstep<kD>(vsm + mine, kBlockRows, kk), 16),
                     desc<kD>(kstep<kD>(dot, kTileRows, kk), 16), 1);
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
        const uint64_t bdo = desc<kD>(dot + kk * 16 * C::kRowBytes,
                                      kTileRows * C::kRowBytes);
        wgmma_rs<kD>(dv_acc, p_hi[kk], bdo);
        wgmma_rs<kD>(dv_acc, p_lo[kk], bdo);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bq = desc<kD>(qt + kk * 16 * C::kRowBytes,
                                      kTileRows * C::kRowBytes);
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

// K3''s consumer warpgroups of 64 q rows each, and the blocks a SM that
// ptxas must fit in registers. One producer warp either way.
// - D 64 and 128: two warpgroups, one block a SM (168 registers a thread).
// - D 16 and 32: one warpgroup and three blocks a SM, for which ptxas
//   allows 128 registers a thread (K3' takes 106 at D 16 and 115 at D 32,
//   no spill: 32 floats of S, 32 of dP, 32 words of their hi/lo split and
//   kD / 2 of dQ). Three warpgroups share a SM, so one's products overlap
//   another's exp and split: D 64's shape (two warpgroups, one block) ran
//   24% slower on an H100 at B8 T1024 H8, and two warpgroups in two
//   blocks or one in four spill at ptxas's 96 (sm90_layouts.py).
template <int kD>
using DqShape = BlockShape<(kD < 64 ? 1 : 2), (kD < 64 ? 3 : 1)>;

template <int kD>
struct DqLayout {
  static constexpr int kQBytes = DqShape<kD>::kRows * kD * 2;
  static constexpr int kTileBytes = kTileRows * kD * 2;
  static constexpr int kBytes =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(DqShape<kD>::kThreads,
                                  DqShape<kD>::kMinBlocks)
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
  using C = Cols<kD>;
  using S = DqShape<kD>;
  constexpr int kBlockRows = S::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);  // kBlocks x [rows][kCols]
  uint8_t* dos = qs + L::kQBytes;
  uint8_t* ks = dos + L::kQBytes;  // [stage] kBlocks x [64][kCols]
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

  if (threadIdx.x == 0) init_barriers(bars, S::kConsumers);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == S::kConsumers) {  // the producer warp: one thread starts the loads
    if (lane != 0 || n_tiles == 0) return;
    mbar_expect_tx(q_bar, 2 * L::kQBytes);
#pragma unroll
    for (int a = 0; a < C::kBlocks; ++a) {
      tma_load(qs + a * kBlockRows * C::kRowBytes, &tq, q_bar, C::kCols * a,
               q0, h, b);
      tma_load(dos + a * kBlockRows * C::kRowBytes, &tdo, q_bar,
               C::kCols * a, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
      mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a) {
        const int at = s * L::kTileBytes + a * kTileRows * C::kRowBytes;
        tma_load(ks + at, &tk, &full[s], C::kCols * a, j * kTileRows, h, b);
        tma_load(vs + at, &tv, &full[s], C::kCols * a, j * kTileRows, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows row0 .. row0 + 63, at byte `mine` of each
  // column block of the resident tiles
  const int tw = threadIdx.x % 128;
  const int mine = wg * 64 * C::kRowBytes;
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
        wgmma_ss_n64(sc, desc<kD>(kstep<kD>(qs + mine, kBlockRows, kk), 16),
                     desc<kD>(kstep<kD>(kt, kTileRows, kk), 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss_n64(dp, desc<kD>(kstep<kD>(dos + mine, kBlockRows, kk), 16),
                     desc<kD>(kstep<kD>(vt, kTileRows, kk), 16), 1);
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
        const uint64_t bk = desc<kD>(kt + kk * 16 * C::kRowBytes,
                                      kTileRows * C::kRowBytes);
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

// ------------------------------------------------------- K4-tf32, K3-tf32

// The float32 backward's block: `consumers` warpgroups of 64 resident rows
// each (kv rows in K4-tf32, q rows in K3-tf32) and a producer warpgroup
// (warp 0 loads by TMA, warps 1-3 split) over streamed tiles of
// kStreamRows, and the blocks a SM that ptxas must fit in registers.
template <int consumers, int blocks>
struct Tf32Shape {
  static constexpr int kConsumers = consumers;
  static constexpr int kMinBlocks = blocks;
  static constexpr int kThreads = 128 * (consumers + 1);
  static constexpr int kRows = 64 * consumers;
};
constexpr int kStreamRows = 32;

// K4-tf32: one consumer warpgroup of 64 kv rows, in two blocks a SM at D
// 16 (116 registers) and one at D 32 and 64, where 256 threads may take
// 255 (dK and dV take 2 x 32 floats at D 64, the split fragments 64
// words). At D 32 two blocks ran 0.306 against one's 0.404 device ms (B8
// T1024 H8 on an H100) but spilled 184 bytes at ptxas's 128 registers
// (none before `cw` was folded at compile time), and two warpgroups ran
// 0.297 with 24 bytes of spill at a 384-thread block's 168; at D 16 two
// warpgroups ran 9% slower; at D 64 they would hold 128 kv rows of K and
// V, hi and lo (128 KB), beside two 64 KB stages, past a block's 227 KB
// (sm90_layouts.py).
template <int kD>
using DkvTf32Shape = Tf32Shape<1, (kD == 16 ? 2 : 1)>;
// K3-tf32: two consumer warpgroups of 64 q rows share each K/V stage and
// its split, and overlap each other's softmax: 0.290 against one
// warpgroup's 0.374 device ms at D 64, within 6% of one warpgroup in two
// blocks a SM at D 16 and 32. 230,464 bytes of shared memory at D 64, as
// K2-tf32.
template <int kD>
using DqTf32Shape = Tf32Shape<2, 1>;

// K4-tf32's and K3-tf32's shared memory at head dim kD with kRows resident
// rows (tiles laid out as K2-tf32's, `Tf32Layout`): the resident rows of
// two tensors, each as hi (split in place) and lo, then a ring of kRing
// stages of the streamed tiles, each 32 rows of kD floats or, transposed,
// kD rows of 32 floats (128-byte rows, Cols<64>).
template <int kD, int kRows>
struct BwdTf32Layout {
  using C = Cols<2 * kD>;
  // two stages: a third would take K4-tf32 at D 64 past the block's
  // 232,448 bytes (198,208 with two)
  static constexpr int kRing = 2;
  static constexpr int kResBytes = kRows * kD * 4;        // each of four
  static constexpr int kTileBytes = kStreamRows * kD * 4;
  static constexpr int kBars = 2 + 3 * kRing;
  // K4-tf32's stage: Q and dO (split to hi in place), Q lo, dO lo, Q^T hi
  // and lo, dO^T hi and lo; lse and delta of each stage's q rows after the
  // ring
  static constexpr int kDkvStage = 8 * kTileBytes;
  static constexpr int kDkvBytes = 1024 + 4 * kResBytes +
                                   kRing * (kDkvStage + 2 * kStreamRows * 4) +
                                   8 * kBars;
  // K3-tf32's stage: K and V (split to hi in place), K lo, V lo, K^T hi
  // and lo
  static constexpr int kDqStage = 6 * kTileBytes;
  static constexpr int kDqBytes =
      1024 + 4 * kResBytes + kRing * kDqStage + 8 * kBars;
};
static_assert(BwdTf32Layout<64, DkvTf32Shape<64>::kRows>::kDkvBytes <=
                  232448,
              "K4-tf32 at D 64 must fit a block's 227 KB");
static_assert(BwdTf32Layout<64, DqTf32Shape<64>::kRows>::kDqBytes <= 232448,
              "K3-tf32 at D 64 must fit a block's 227 KB");

// A streamed tile (32 rows of kD floats as TMA landed it, Cols<2 kD>) split
// as split_in_place splits it (hi in place, lo at the same offsets of
// `lo`), and written transposed and split into `th` and `tl`: kD rows of
// the tile's 32 values, 128 bytes each in the 128-byte swizzle, K-major
// for a TF32 B operand whose K is the tile's rows, which sit in `pv_slot`
// order. A warp takes the 32 rows of one 16-byte chunk, as
// split_transposed does, so neither its reads nor its writes conflict on a
// bank.
template <int kD>
__device__ __forceinline__ void split_and_transpose(uint8_t* x, uint8_t* lo,
                                                    uint8_t* th, uint8_t* tl,
                                                    int t) {
  using C = Cols<2 * kD>;
  constexpr int kChunks = kStreamRows * kD / 4;
  for (int c = t; c < kChunks; c += kSplitThreads) {
    const int row = c % kStreamRows;
    const int col = 16 * (c / kStreamRows);  // byte of the row: dims col / 4..
    const uint32_t at =
        (col / C::kRowBytes) * kStreamRows * C::kRowBytes +
        swizzled<C::kRowBytes>(row * C::kRowBytes + col % C::kRowBytes);
    const uint4 v = *reinterpret_cast<const uint4*>(x + at);
    const uint32_t xs[4] = {v.x, v.y, v.z, v.w};
    uint32_t hs[4], ls[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // row col / 4 + e of the transpose
      split_tf32(__uint_as_float(xs[e]), hs[e], ls[e]);
      const uint32_t o = swizzled<128>((col / 4 + e) * 128 + 4 * pv_slot(row));
      *reinterpret_cast<uint32_t*>(th + o) = hs[e];
      *reinterpret_cast<uint32_t*>(tl + o) = ls[e];
    }
    *reinterpret_cast<uint4*>(x + at) = make_uint4(hs[0], hs[1], hs[2], hs[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(ls[0], ls[1], ls[2], ls[3]);
  }
}

// The 64 x 32 float32 tile x, in the accumulator layout, as the register A
// fragments of four k8 TF32 steps, split into hi and lo: step kk's are
// elements 4 kk, 4 kk + 2, 4 kk + 1 and 4 kk + 3 (rows r0, r0 + 8 at
// column 2t; rows r0, r0 + 8 at 2t + 1), so the B operand's K sits in
// `pv_slot` order.
__device__ __forceinline__ void split_tf32_fragments(const float (&x)[16],
                                                     uint32_t (&hi)[4][4],
                                                     uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_tf32(x[4 * kk], hi[kk][0], lo[kk][0]);
    split_tf32(x[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split_tf32(x[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split_tf32(x[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// d (64 x kD) += A (64 x 32) . B (32 x kD) in 3xTF32: A as split register
// fragments, B transposed and split at descriptor `b_hi`, its lo `b_lo`
// descriptor units past it; four k8 steps.
template <int kD>
__device__ __forceinline__ void wgmma_tf32_rs_3x(float (&d)[kD / 2],
                                                 const uint32_t (&hi)[4][4],
                                                 const uint32_t (&lo)[4][4],
                                                 uint64_t b_hi,
                                                 uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = b_hi + kstep_desc<64>(kD, kk);
    wgmma_tf32_rs<kD>(d, lo[kk], bh);
    wgmma_tf32_rs<kD>(d, hi[kk], bh + b_lo);
    wgmma_tf32_rs<kD>(d, hi[kk], bh);
  }
}

// d (64 x 32) += A (64 x kD) . B (kD x 32) in 3xTF32: A (64 of a tile's
// kARows rows) and B (32 rows) K-major in Cols<2 kD> at descriptors a_hi
// and b_hi, their lo a_lo and b_lo descriptor units past them; kD / 8 k8
// steps.
template <int kD, int kARows>
__device__ __forceinline__ void wgmma_tf32_ss_3x(float (&d)[16],
                                                 uint64_t a_hi, uint64_t a_lo,
                                                 uint64_t b_hi,
                                                 uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint64_t a = a_hi + kstep_desc<2 * kD>(kARows, kk);
    const uint64_t b = b_hi + kstep_desc<2 * kD>(kStreamRows, kk);
    wgmma_tf32_ss_n32(d, a + a_lo, b);
    wgmma_tf32_ss_n32(d, a, b + b_lo);
    wgmma_tf32_ss_n32(d, a, b);
  }
}

template <int kD>
__global__ void __launch_bounds__(DkvTf32Shape<kD>::kThreads,
                                  DkvTf32Shape<kD>::kMinBlocks)
flash_bwd_dkv_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
                               Strides sdk, Strides sdv, int H, int Tq,
                               int Tk, int q_off, int kv_off, bool causal,
                               float scale) {
  using S = DkvTf32Shape<kD>;
  using L = BwdTf32Layout<kD, S::kRows>;
  using C = typename L::C;
  constexpr int kT = L::kTileBytes;
  constexpr int kBlockRows = S::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ksm = align_1024(smem_raw);  // K, then its hi; K lo; V; V lo
  uint8_t* vsm = ksm + 2 * L::kResBytes;
  uint8_t* stages = vsm + 2 * L::kResBytes;
  float* lse_s = reinterpret_cast<float*>(stages + L::kRing * L::kDkvStage);
  float* delta_s = lse_s + L::kRing * kStreamRows;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(delta_s + L::kRing * kStreamRows);
  uint64_t* kv_bar = bars;        // K and V landed
  uint64_t* kv_split = bars + 1;  // ... and split
  uint64_t* loaded = bars + 2;    // a stage's Q and dO landed
  uint64_t* full = bars + 2 + L::kRing;  // ... split, lse and delta beside
  uint64_t* empty = bars + 2 + 2 * L::kRing;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kv0 = blockIdx.x * kBlockRows;
  // the first q tile that sees this block's first kv row
  int i_start = 0;
  if (causal) {
    const long long first = static_cast<long long>(kv_off) + kv0 - q_off;
    i_start = static_cast<int>(max(0LL, min(static_cast<long long>(Tq), first)));
    i_start -= i_start % kStreamRows;
  }
  const int n_tiles = (Tq - i_start + kStreamRows - 1) / kStreamRows;
  const long long lse_row = static_cast<long long>(blockIdx.y) * Tq;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    mbar_init(kv_split, kSplitThreads / 32);
#pragma unroll
    for (int s = 0; s < L::kRing; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], kSplitThreads / 32);
      mbar_init(&empty[s], 4 * S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == S::kConsumers) {  // the producer warpgroup
    if (n_tiles == 0) return;
    const int t = static_cast<int>(threadIdx.x % 128) - 32;  // warps 1-3
    if (t < 0) {  // warp 0: one thread starts the loads
      if (lane != 0) return;
      mbar_expect_tx(kv_bar, 2 * L::kResBytes);
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a) {
        const int at = a * kBlockRows * C::kRowBytes;
        tma_load(ksm + at, &tk, kv_bar, C::kRowBytes / 4 * a, kv0, h, b);
        tma_load(vsm + at, &tv, kv_bar, C::kRowBytes / 4 * a, kv0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::kRing;
        uint8_t* st = stages + s * L::kDkvStage;
        if (j >= L::kRing) mbar_wait(&empty[s], (j / L::kRing - 1) & 1);
        const int i0 = i_start + j * kStreamRows;
        mbar_expect_tx(&loaded[s], 2 * kT);
#pragma unroll
        for (int a = 0; a < C::kBlocks; ++a) {
          const int at = a * kStreamRows * C::kRowBytes;
          tma_load(st + at, &tq, &loaded[s], C::kRowBytes / 4 * a, i0, h, b);
          tma_load(st + 2 * kT + at, &tdo, &loaded[s], C::kRowBytes / 4 * a,
                   i0, h, b);
        }
      }
      return;
    }
    // warps 1-3 split what landed: K and V once, then Q and dO a stage at
    // a time, with the stage's lse and delta
    mbar_wait(kv_bar, 0);
    split_in_place(ksm, ksm + L::kResBytes, L::kResBytes / 16, t);
    split_in_place(vsm, vsm + L::kResBytes, L::kResBytes / 16, t);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_split);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kRing;
      uint8_t* st = stages + s * L::kDkvStage;
      mbar_wait(&loaded[s], (j / L::kRing) & 1);
      split_and_transpose<kD>(st, st + kT, st + 4 * kT, st + 5 * kT, t);
      split_and_transpose<kD>(st + 2 * kT, st + 3 * kT, st + 6 * kT,
                              st + 7 * kT, t);
      const int i0 = i_start + j * kStreamRows;
      for (int c = t; c < kStreamRows; c += kSplitThreads) {
        const bool in = i0 + c < Tq;
        lse_s[s * kStreamRows + c] = in ? lse[lse_row + i0 + c] : 0.0f;
        delta_s[s * kStreamRows + c] = in ? delta[lse_row + i0 + c] : 0.0f;
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // a consumer warpgroup: kv rows kv_row0 .. kv_row0 + 63, at byte `mine`
  // of each column block of K's and V's hi and lo
  const int r0 = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int cw = S::kConsumers == 1 ? 0 : wg;  // 0 at compile time for one
  const int mine = cw * 64 * C::kRowBytes;
  const int kv_row0 = kv0 + cw * 64;
  const long long kvpos = static_cast<long long>(kv_off) + kv_row0 + r0;
  const uint64_t k_hi = desc<2 * kD>(ksm + mine, 16);
  const uint64_t v_hi = desc<2 * kD>(vsm + mine, 16);
  constexpr uint64_t kResLo = L::kResBytes >> 4, kLo = kT >> 4;

  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  if (n_tiles > 0) mbar_wait(kv_split, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kRing;
    mbar_wait(&full[s], (j / L::kRing) & 1);
    const uint8_t* st = stages + s * L::kDkvStage;
    const int i0 = i_start + j * kStreamRows;
    // a block's first q tile sees its first kv row (`i_start`), so one
    // warpgroup's every tile is live
    const bool live =
        S::kConsumers == 1 ||
        (kv_row0 < Tk &&
         (!causal || static_cast<long long>(q_off) + i0 + kStreamRows - 1 >=
                         static_cast<long long>(kv_off) + kv_row0));
    if (live) {
      // S^T = K.Q^T and dP^T = V.dO^T, each lo.hi + hi.lo + hi.hi
      float sc[16], dp[16];
  #pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.0f;
      pin(sc);
      pin(dp);
      wg_fence();
      wgmma_tf32_ss_3x<kD, kBlockRows>(sc, k_hi, kResLo, desc<2 * kD>(st, 16),
                                       kLo);
      wgmma_tf32_ss_3x<kD, kBlockRows>(dp, v_hi, kResLo,
                                       desc<2 * kD>(st + 2 * kT, 16), kLo);
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);

      const bool edge =
          i0 + kStreamRows > Tq || kv_row0 + 64 > Tk ||
          (causal && static_cast<long long>(kv_off) + kv_row0 + 63 >
                         static_cast<long long>(q_off) + i0);
      const float* ls = lse_s + s * kStreamRows;
      const float* ds = delta_s + s * kStreamRows;
  #pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = acc_col(i, c0);
        bool ok = true;
        if (edge) {
          ok = i0 + c < Tq && kv_row0 + r0 + 8 * acc_half(i) < Tk &&
               (!causal || kvpos + 8 * acc_half(i) <=
                               static_cast<long long>(q_off) + i0 + c);
        }
        const float p = ok ? expf(sc[i] * scale - ls[c]) : 0.0f;
        sc[i] = p;
        dp[i] = p * (dp[i] - ds[c]);
      }

      // dV += P^T.dO and dK += dS^T.Q, each lo.hi + hi.lo + hi.hi, over
      // dO^T and Q^T
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      split_tf32_fragments(sc, p_hi, p_lo);
      split_tf32_fragments(dp, ds_hi, ds_lo);
      pin(dk_acc);
      pin(dv_acc);
      pin(p_hi);
      pin(p_lo);
      pin(ds_hi);
      pin(ds_lo);
      wg_fence();
      wgmma_tf32_rs_3x<kD>(dv_acc, p_hi, p_lo, desc<64>(st + 6 * kT, 16), kLo);
      wgmma_tf32_rs_3x<kD>(dk_acc, ds_hi, ds_lo, desc<64>(st + 4 * kT, 16),
                           kLo);
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
    float* k_dst = dk + b * sdk.b + row * sdk.t + h * sdk.h + c0;
    float* v_dst = dv + b * sdv.b + row * sdv.t + h * sdv.h + c0;
#pragma unroll
    for (int g = 0; g < kD / 8; ++g) {
      const int i = 4 * g + 2 * r;
      *reinterpret_cast<float2*>(k_dst + 8 * g) =
          make_float2(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<float2*>(v_dst + 8 * g) =
          make_float2(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(DqTf32Shape<kD>::kThreads,
                                  DqTf32Shape<kD>::kMinBlocks)
flash_bwd_dq_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, Strides sdq, int H,
                              int Tq, int Tk, int q_off, int kv_off,
                              bool causal, float scale) {
  using S = DqTf32Shape<kD>;
  using L = BwdTf32Layout<kD, S::kRows>;
  using C = typename L::C;
  constexpr int kT = L::kTileBytes;
  constexpr int kBlockRows = S::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);  // Q, then its hi; Q lo; dO; dO lo
  uint8_t* dos = qs + 2 * L::kResBytes;
  uint8_t* stages = dos + 2 * L::kResBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + L::kRing * L::kDqStage);
  uint64_t* q_bar = bars;        // Q and dO landed
  uint64_t* q_split = bars + 1;  // ... and split
  uint64_t* loaded = bars + 2;   // a stage's K and V landed
  uint64_t* full = bars + 2 + L::kRing;  // ... and split
  uint64_t* empty = bars + 2 + 2 * L::kRing;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int n_tiles =
      (kv_rows_seen(min(Tq, q0 + kBlockRows), Tk, q_off, kv_off, causal) +
       kStreamRows - 1) / kStreamRows;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    mbar_init(q_split, kSplitThreads / 32);
#pragma unroll
    for (int s = 0; s < L::kRing; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], kSplitThreads / 32);
      mbar_init(&empty[s], 4 * S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == S::kConsumers) {  // the producer warpgroup
    if (n_tiles == 0) return;
    const int t = static_cast<int>(threadIdx.x % 128) - 32;  // warps 1-3
    if (t < 0) {  // warp 0: one thread starts the loads
      if (lane != 0) return;
      mbar_expect_tx(q_bar, 2 * L::kResBytes);
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a) {
        const int at = a * kBlockRows * C::kRowBytes;
        tma_load(qs + at, &tq, q_bar, C::kRowBytes / 4 * a, q0, h, b);
        tma_load(dos + at, &tdo, q_bar, C::kRowBytes / 4 * a, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::kRing;
        uint8_t* st = stages + s * L::kDqStage;
        if (j >= L::kRing) mbar_wait(&empty[s], (j / L::kRing - 1) & 1);
        mbar_expect_tx(&loaded[s], 2 * kT);
#pragma unroll
        for (int a = 0; a < C::kBlocks; ++a) {
          const int at = a * kStreamRows * C::kRowBytes;
          tma_load(st + at, &tk, &loaded[s], C::kRowBytes / 4 * a,
                   j * kStreamRows, h, b);
          tma_load(st + 2 * kT + at, &tv, &loaded[s], C::kRowBytes / 4 * a,
                   j * kStreamRows, h, b);
        }
      }
      return;
    }
    // warps 1-3 split what landed: Q and dO once, then K (with K^T) and V
    // a stage at a time
    mbar_wait(q_bar, 0);
    split_in_place(qs, qs + L::kResBytes, L::kResBytes / 16, t);
    split_in_place(dos, dos + L::kResBytes, L::kResBytes / 16, t);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_split);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kRing;
      uint8_t* st = stages + s * L::kDqStage;
      mbar_wait(&loaded[s], (j / L::kRing) & 1);
      split_and_transpose<kD>(st, st + kT, st + 4 * kT, st + 5 * kT, t);
      split_in_place(st + 2 * kT, st + 3 * kT, kT / 16, t);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // a consumer warpgroup: q rows row0 .. row0 + 63, at byte `mine` of
  // each column block of Q's and dO's hi and lo
  const int r0 = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int mine = wg * 64 * C::kRowBytes;
  const int row0 = q0 + wg * 64;
  const long long qpos = static_cast<long long>(q_off) + row0 + r0;
  const int n_mine =
      row0 < Tq ? (kv_rows_seen(min(Tq, row0 + 64), Tk, q_off, kv_off,
                                causal) + kStreamRows - 1) / kStreamRows
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
  const uint64_t q_hi = desc<2 * kD>(qs + mine, 16);
  const uint64_t do_hi = desc<2 * kD>(dos + mine, 16);
  constexpr uint64_t kResLo = L::kResBytes >> 4, kLo = kT >> 4;

  float dq_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq_acc[i] = 0.0f;
  if (n_tiles > 0) mbar_wait(q_split, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kRing;
    mbar_wait(&full[s], (j / L::kRing) & 1);
    if (S::kConsumers == 1 || j < n_mine) {
      const uint8_t* st = stages + s * L::kDqStage;
      // S = Q.K^T and dP = dO.V^T, each lo.hi + hi.lo + hi.hi
      float sc[16], dp[16];
  #pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.0f;
      pin(sc);
      pin(dp);
      wg_fence();
      wgmma_tf32_ss_3x<kD, kBlockRows>(sc, q_hi, kResLo, desc<2 * kD>(st, 16),
                                       kLo);
      wgmma_tf32_ss_3x<kD, kBlockRows>(dp, do_hi, kResLo,
                                       desc<2 * kD>(st + 2 * kT, 16), kLo);
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);

      const int j0 = j * kStreamRows;
      const bool edge =
          j0 + kStreamRows > Tk ||
          (causal && static_cast<long long>(kv_off) + j0 + kStreamRows - 1 >
                         static_cast<long long>(q_off) + row0);
  #pragma unroll
      for (int i = 0; i < 16; ++i) {
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

      // dQ += dS.K, lo.hi + hi.lo + hi.hi over K^T
      uint32_t ds_hi[4][4], ds_lo[4][4];
      split_tf32_fragments(dp, ds_hi, ds_lo);
      pin(dq_acc);
      pin(ds_hi);
      pin(ds_lo);
      wg_fence();
      wgmma_tf32_rs_3x<kD>(dq_acc, ds_hi, ds_lo, desc<64>(st + 4 * kT, 16),
                           kLo);
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
    float* dst = dq + b * sdq.b + row * sdq.t + h * sdq.h + c0;
#pragma unroll
    for (int g = 0; g < kD / 8; ++g) {
      const int i = 4 * g + 2 * r;
      *reinterpret_cast<float2*>(dst + 8 * g) =
          make_float2(dq_acc[i] * scale, dq_acc[i + 1] * scale);
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

// Tensor map over a (B, T, H, kD) tensor of kElem-byte elements (bfloat16
// or float32) at `p` with (b, t, h) element strides, in boxes of one
// column block of Cols<kD kElem / 2> (the row's bytes as bf16 columns) x
// `rows` rows in that block's swizzle (TMA refuses an inner box wider than
// its swizzle), zeros past T. A dim of extent 1 may carry any stride in
// PyTorch; it gets the contiguous one. TMA takes strides that are multiples
// of 16 bytes and a 16-byte-aligned address (the wrapper checks both).
template <int kD, int kElem = 2>
bool make_map(CUtensorMap* map, const void* p, Strides s, int B, int T,
              int H, int rows) {
  using C = Cols<kD * kElem / 2>;
  constexpr int D = kD;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long st = T == 1 ? static_cast<long long>(H) * D : s.t;
  const long long sh = H == 1 ? D : s.h;
  const long long sb = B == 1 ? static_cast<long long>(T) * H * D : s.b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * kElem,
                                 static_cast<cuuint64_t>(sh) * kElem,
                                 static_cast<cuuint64_t>(sb) * kElem};
  const cuuint32_t box[4] = {C::kRowBytes / kElem,
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map,
                kElem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, C::kSwizzle,
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
  if (!make_map<kD>(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kBlockRows) ||
      !make_map<kD>(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kTileRows) ||
      !make_map<kD>(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kTileRows)) {
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
cudaError_t run_fwd_tf32(const Args& a) {
  CUtensorMap mq, mk, mv;
  if (!make_map<kD, 4>(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kBlockRows) ||
      !make_map<kD, 4>(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kTileRows) ||
      !make_map<kD, 4>(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_tf32_sm90_kernel<kD>;
  constexpr int smem = Tf32Layout<kD>::kBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBlockRows - 1) / kBlockRows, a.B * a.H);
  kernel<<<grid, kTf32Threads, smem, a.stream>>>(
      mq, mk, mv, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
      a.at(3), a.H, a.Tq, a.Tk, a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_dkv(const Args& a) {
  using S = DkvShape<kD>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<kD>(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kTileRows) ||
      !make_map<kD>(&mk, a.k, a.at(1), a.B, a.Tk, a.H, S::kRows) ||
      !make_map<kD>(&mv, a.v, a.at(2), a.B, a.Tk, a.H, S::kRows) ||
      !make_map<kD>(&mdo, a.dout, a.at(3), a.B, a.Tq, a.H, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dkv_sm90_kernel<kD>;
  constexpr int smem = DkvLayout<kD>::kBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + S::kRows - 1) / S::kRows, a.B * a.H);
  kernel<<<grid, S::kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.at(4), a.at(5), a.H, a.Tq, a.Tk,
      a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_dq(const Args& a) {
  using S = DqShape<kD>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<kD>(&mq, a.q, a.at(0), a.B, a.Tq, a.H, S::kRows) ||
      !make_map<kD>(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kTileRows) ||
      !make_map<kD>(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kTileRows) ||
      !make_map<kD>(&mdo, a.dout, a.at(3), a.B, a.Tq, a.H, S::kRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dq_sm90_kernel<kD>;
  constexpr int smem = DqLayout<kD>::kBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + S::kRows - 1) / S::kRows, a.B * a.H);
  kernel<<<grid, S::kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      a.at(4), a.H, a.Tq, a.Tk, a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_dkv_tf32(const Args& a) {
  using S = DkvTf32Shape<kD>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<kD, 4>(&mq, a.q, a.at(0), a.B, a.Tq, a.H, kStreamRows) ||
      !make_map<kD, 4>(&mk, a.k, a.at(1), a.B, a.Tk, a.H, S::kRows) ||
      !make_map<kD, 4>(&mv, a.v, a.at(2), a.B, a.Tk, a.H, S::kRows) ||
      !make_map<kD, 4>(&mdo, a.dout, a.at(3), a.B, a.Tq, a.H, kStreamRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dkv_tf32_sm90_kernel<kD>;
  constexpr int smem = BwdTf32Layout<kD, S::kRows>::kDkvBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + S::kRows - 1) / S::kRows, a.B * a.H);
  kernel<<<grid, S::kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.at(4), a.at(5), a.H, a.Tq, a.Tk,
      a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t run_dq_tf32(const Args& a) {
  using S = DqTf32Shape<kD>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<kD, 4>(&mq, a.q, a.at(0), a.B, a.Tq, a.H, S::kRows) ||
      !make_map<kD, 4>(&mk, a.k, a.at(1), a.B, a.Tk, a.H, kStreamRows) ||
      !make_map<kD, 4>(&mv, a.v, a.at(2), a.B, a.Tk, a.H, kStreamRows) ||
      !make_map<kD, 4>(&mdo, a.dout, a.at(3), a.B, a.Tq, a.H, S::kRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dq_tf32_sm90_kernel<kD>;
  constexpr int smem = BwdTf32Layout<kD, S::kRows>::kDqBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + S::kRows - 1) / S::kRows, a.B * a.H);
  kernel<<<grid, S::kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
      a.at(4), a.H, a.Tq, a.Tk, a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <int kD, typename T>
cudaError_t run_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.Tq * a.H;
  const long long threads = rows * (kD * static_cast<int>(sizeof(T)) / 16);
  const int per_block = 256;
  flash_bwd_delta_sm90_kernel<kD, T>
      <<<static_cast<unsigned>((threads + per_block - 1) / per_block),
         per_block, 0, a.stream>>>(
          static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
          static_cast<const float*>(a.glse), static_cast<float*>(a.out0),
          a.at(0), a.at(1), a.H, a.Tq, rows);
  return cudaGetLastError();
}

typedef cudaError_t (*Run)(const Args&);

// One instantiation of a launch: the head dim it is built for.
struct Built {
  int D;
  Run run;
};

// The launch built for dtype code `want` (0 float32, 1 bfloat16) at the
// head dim a.D; anything else is refused.
template <size_t N>
int dispatch(int dtype, const Args& a, const Built (&built)[N],
             int want = 1) {
  for (const Built& b : built) {
    if (dtype == want && a.D == b.D) return static_cast<int>(b.run(a));
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
// D 16, 32, 64 or 128, or for the *_tf32_sm90 launchers 0 (float32) and D
// 16, 32 or 64 (the delta pass takes either); anything else returns
// cudaErrorInvalidValue.

int flash_fwd_sm90(int dtype, const void* q, const void* k, const void* v,
                   void* out, void* lse, const long long* strides, int B,
                   int H, int Tq, int Tk, int D, int q_off, int kv_off,
                   int causal, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr,
               out, lse, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  static const Built built[] = {{16, run_fwd<16>}, {32, run_fwd<32>},
                                 {64, run_fwd<64>}, {128, run_fwd<128>}};
  return dispatch(dtype, a, built);
}

// K2-tf32: float32 out and lse from float32 q, k, v. Strides: q, k, v,
// out.
int flash_fwd_tf32_sm90(int dtype, const void* q, const void* k,
                        const void* v, void* out, void* lse,
                        const long long* strides, int B, int H, int Tq,
                        int Tk, int D, int q_off, int kv_off, int causal,
                        void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr,
               out, lse, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  static const Built built[] = {
      {16, run_fwd_tf32<16>}, {32, run_fwd_tf32<32>}, {64, run_fwd_tf32<64>}};
  return dispatch(dtype, a, built, 0);
}

// delta (B, H, Tq) = rowsum(dout . out) - g_lse; glse may be null (0).
// dtype 1 (bfloat16) at D 16, 32, 64 and 128, for K3' and K4', or 0
// (float32) at D 16, 32 and 64, for K3-tf32 and K4-tf32. Strides: out,
// dout.
int flash_bwd_delta_sm90(int dtype, const void* out, const void* dout,
                         const void* glse, void* delta,
                         const long long* strides, int B, int H, int Tq,
                         int D, void* stream) {
  const Args a{nullptr, nullptr, nullptr, out, dout, nullptr, glse, nullptr,
               delta, nullptr, strides, B, H, Tq, 0, D, 0, 0,
               false, 0.0f, static_cast<cudaStream_t>(stream)};
  static const Built bf16[] = {{16, run_delta<16, __nv_bfloat16>},
                                {32, run_delta<32, __nv_bfloat16>},
                                {64, run_delta<64, __nv_bfloat16>},
                                {128, run_delta<128, __nv_bfloat16>}};
  static const Built f32[] = {{16, run_delta<16, float>},
                               {32, run_delta<32, float>},
                               {64, run_delta<64, float>}};
  return dtype == 0 ? dispatch(dtype, a, f32, 0) : dispatch(dtype, a, bf16);
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
  static const Built built[] = {{16, run_dkv<16>}, {32, run_dkv<32>},
                                 {64, run_dkv<64>}, {128, run_dkv<128>}};
  return dispatch(dtype, a, built);
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
  static const Built built[] = {{16, run_dq<16>}, {32, run_dq<32>},
                                 {64, run_dq<64>}, {128, run_dq<128>}};
  return dispatch(dtype, a, built);
}

// K4-tf32: float32 dK, dV from float32 q, k, v, dout, lse and the delta
// pass's output. Strides: q, k, v, dout, dk, dv.
int flash_bwd_dkv_tf32_sm90(int dtype, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            const long long* strides, int B, int H, int Tq,
                            int Tk, int D, int q_off, int kv_off, int causal,
                            void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, nullptr, delta,
               dk, dv, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  static const Built built[] = {
      {16, run_dkv_tf32<16>}, {32, run_dkv_tf32<32>}, {64, run_dkv_tf32<64>}};
  return dispatch(dtype, a, built, 0);
}

// K3-tf32: float32 dQ from float32 q, k, v, dout, lse and the delta pass's
// output. Strides: q, k, v, dout, dq.
int flash_bwd_dq_tf32_sm90(int dtype, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, void* dq,
                           const long long* strides, int B, int H, int Tq,
                           int Tk, int D, int q_off, int kv_off, int causal,
                           void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, nullptr, delta,
               dq, nullptr, strides, B, H, Tq, Tk, D, q_off, kv_off,
               causal != 0, scale_of(D), static_cast<cudaStream_t>(stream)};
  static const Built built[] = {
      {16, run_dq_tf32<16>}, {32, run_dq_tf32<32>}, {64, run_dq_tf32<64>}};
  return dispatch(dtype, a, built, 0);
}

// Dynamic shared memory a launch of K2' (kernel 0), K4' (kernel 1), K3'
// (kernel 2), K2-tf32 (kernel 3), K4-tf32 (kernel 4) or K3-tf32 (kernel
// 5) asks for at head dim D, or -1 where that kernel is not built.
// ptxas does not report dynamic shared memory; chip_smoke.py prints this
// beside it.
int flash_sm90_shared_bytes(int kernel, int D) {
  if (kernel == 0 && D == 16) return FwdLayout<16>::kBytes;
  if (kernel == 0 && D == 32) return FwdLayout<32>::kBytes;
  if (kernel == 0 && D == 64) return FwdLayout<64>::kBytes;
  if (kernel == 0 && D == 128) return FwdLayout<128>::kBytes;
  if (kernel == 1 && D == 16) return DkvLayout<16>::kBytes;
  if (kernel == 1 && D == 32) return DkvLayout<32>::kBytes;
  if (kernel == 1 && D == 64) return DkvLayout<64>::kBytes;
  if (kernel == 1 && D == 128) return DkvLayout<128>::kBytes;
  if (kernel == 2 && D == 16) return DqLayout<16>::kBytes;
  if (kernel == 2 && D == 32) return DqLayout<32>::kBytes;
  if (kernel == 2 && D == 64) return DqLayout<64>::kBytes;
  if (kernel == 2 && D == 128) return DqLayout<128>::kBytes;
  if (kernel == 3 && D == 16) return Tf32Layout<16>::kBytes;
  if (kernel == 3 && D == 32) return Tf32Layout<32>::kBytes;
  if (kernel == 3 && D == 64) return Tf32Layout<64>::kBytes;
  if (kernel == 4 && D == 16) {
    return BwdTf32Layout<16, DkvTf32Shape<16>::kRows>::kDkvBytes;
  }
  if (kernel == 4 && D == 32) {
    return BwdTf32Layout<32, DkvTf32Shape<32>::kRows>::kDkvBytes;
  }
  if (kernel == 4 && D == 64) {
    return BwdTf32Layout<64, DkvTf32Shape<64>::kRows>::kDkvBytes;
  }
  if (kernel == 5 && D == 16) {
    return BwdTf32Layout<16, DqTf32Shape<16>::kRows>::kDqBytes;
  }
  if (kernel == 5 && D == 32) {
    return BwdTf32Layout<32, DqTf32Shape<32>::kRows>::kDqBytes;
  }
  if (kernel == 5 && D == 64) {
    return BwdTf32Layout<64, DqTf32Shape<64>::kRows>::kDqBytes;
  }
  return -1;
}

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

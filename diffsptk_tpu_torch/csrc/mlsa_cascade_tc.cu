// The Taylor MLSA cascade at the TPU's reduced precisions, for sm_90a: S
// stages of the DFT-plan form on the tensor cores (bf16 operands, fp32
// accumulators), in two C entries that run one pair of kernels.
//
// Replaces, at precision "HIGH" (bf16x3) and "DEFAULT" (one bf16 pass):
// through mlsa_cascade_tc_chunked_f32 (the tap-chunked geometry, B2)
// diffsptk_tpu/kernels/pallas_mlsa.py:260 _chunked_kernel_b3 and the
// DEFAULT arm of :330 _chunked_kernel (launched at :449); through
// mlsa_cascade_tc_unchunked_f32 (every other geometry, B3) :119
// _cascade_kernel_b3 and the DEFAULT arm of :175 _cascade_kernel (launched
// at :498).  "HIGHEST" and None stay on the fp32 FIR of mlsa_cascade.cu.
//
// Computes stage s of kernels/mlsa_cascade.py:taylor_cascade_chunked (Q
// tap chunks; the unchunked form is Q = 1) on the (B, N, P) frame grid,
// frame m's context the n_blk rows m - r0 .. m - r0 + n_blk - 1:
//   X[m]  = x[(m - r0) P .. (m - r0 + n_blk) P) @ Ffwd     (1 x 2K)
//   Y[n]  = sum_j X[n - j] * C[n, j]       (complex, fp32; C[N] = C[N-1])
//   V[n]  = [Yre[n] | Yim[n]] @ [Gre; Gim]  (1 x 2P: lo (1-lam) | hi lam)
//   out[n] = V[n, :P] + V[n+1, P:],  xout = w_s out,  y += a_s xout.
// The last frame blends with frame N, whose context is frame N-1's shifted
// by P and whose spectrum is C[N-1]: the plan's lo-lam edge block, as the
// TPU's chunked kernel gets it from its first gap row.
// Each plan product is, at HIGH, ah bh + ah bl + al bh with the exact
// splits hi = bf16_rn(v), lo = bf16_rn(v - hi), and at DEFAULT ah bh, all
// summed in fp32.  The plans are split once a geometry, on the host
// (kernels/mlsa.py:tc_plans); the activations (the state, then Y) every
// stage.
//
// Bound on this card: operations.  Per frame row and stage the plans take
// n_blk P x 2K + 2K x 2P multiply-adds: at the flagship (B = 32, N = 240,
// P = 80, M = 199: Q = 3, nfft 254, K = 128, n_blk = 3) 31.5 GFLOP a call
// of S = 20 at one pass, 0.032 ms at 989 TFLOP/s, 0.095 at HIGH; at
// [chain48]'s P = 240, M = 199 (unchunked: nfft 766, K = 384) 283 GFLOP,
// 0.286 and 0.859 ms.  The bytes (x, y, the coefficient spectra and the
// plans once) take less: 0.007 ms at the flagship.
//
// What the design does about it:
// - A stage is two tensor-core GEMMs over every frame of every batch row,
//   flattened into one M dimension, in tiles of 128 rows (two consumer
//   warpgroups, wgmma m64) that share each plan tile.  The state lives
//   split (bf16 hi, and lo at HIGH) in a padded layout: pre = Q - 1 + r0
//   zero frames before each batch row and n_blk - 1 - r0 after it (one more
//   where pre = 0), Np frames a row, each frame P8 = P rounded up to 8 wide
//   (zeros past P).  Row i of a batch row is frame m = i - (Q - 1), whose
//   context is the row at i P8 of length n_blk P8 of one view with a
//   16-byte row stride; the plan's rows match it.  Frame N's context runs
//   one frame into the next row's zero frames.
// - tc_fwd_kernel: X = ctx @ Ffwd (K = n_blk P8 rounded up to 64, columns
//   2 Kp, the real and imaginary part of a bin side by side, four
//   consecutive bins a thread); its epilogue applies C in fp32 and writes
//   Y split to a scratch (M x 2 Kp bf16), 16 bytes a store.  Unchunked
//   (Q = 1), the coefficients load into registers, a float4 of each part a
//   row and four bins, under the main loop.  Chunked, the row tiles overlap
//   by a halo of Q - 1 rows (a tile of 128 rows yields 129 - Q rows of Y):
//   X goes through shared memory (over the ring) and the epilogue sums the
//   Q terms of four rows at a time, the coefficient loads of up to four
//   chunks issued together.
// - tc_inv_kernel: V = Y @ G; a column tile holds the same p range of the
//   lo and hi halves (in groups of 8 columns), a row tile 127 frames and a
//   halo row; its epilogue blends V[n] with V[n+1] through shared memory,
//   weighs, adds a_s out to y (read under the main loop) and writes the
//   next state already split, four p a thread.  Chunked, it first moves
//   the spectra of its frames into L2 (cp.async.bulk.prefetch) for the
//   next stage's forward epilogue: they do not stay there from one stage
//   to the next.
// - Operands: the plans sit on the host in the exact image of a ring stage
//   (K-major, 128-byte swizzle), so one bulk copy (TMA, cp.async.bulk on an
//   mbarrier) moves a tile; the rows of A come by cp.async, 16 bytes a
//   thread with zero fill, since the context rows overlap (row stride P8,
//   length n_blk P8: not a tensor map's box) and the tiles start at any
//   row.  A ring of 3 to 6 stages keeps one to four k-steps of loads ahead
//   of the wgmma, one warpgroup-group in flight.
// - Tiles (Tiles<high, chunked>): unchunked, 128 x 192 forward and
//   128 x 240 inverse at DEFAULT, 128 x 128 both at HIGH; chunked, 128 x
//   128 forward (two column tiles at K = 128) and 128 x 80 inverse (40 p a
//   tile: two at P = 80), so that the flagship's 7,808 rows make 124 CTAs
//   of each kernel on the 132 SMs, with every k-step of the forward's and
//   the inverse's K = 256 in flight at once at DEFAULT (6 ring stages).
// - An unchunked geometry whose plans pass 24 MB is refused (no tile): its
//   tiles re-read them from L2.  Q is at most 64.
// - Launches: a prologue kernel splits x into the padded state once, then
//   two a stage, each the programmatic dependent of the one before (its
//   first plan tiles load before it waits).
// Measured (tools/torch_tc_cascade_ab.py and chip_smoke.py [precision],
// H100 80GB HBM3, 700 W), ms per 20 stages: chunked at the flagship HIGH
// about 0.55 and DEFAULT 0.41-0.46 (the mma.sync kernel it replaced:
// 1.15-1.16 and 0.68-0.72), 6x and 13x the bound; unchunked at P = 240
// HIGH 2.0 and DEFAULT 0.89 (PERF.md's kernel table).  What holds
// the chunked entry back (the build variants MLSA_TC_NO_PDL,
// MLSA_TC_ABLATE_EPILOGUE, MLSA_TC_ABLATE_MMA and MLSA_TC_NO_PREFETCH):
// the forward epilogue, about 8 of a stage's 18 us on the device, bound by
// the 23.6 MB of spectra it reads a stage; the products are as fast
// without the wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Inside an unnamed namespace: a static local of a template function with
// external linkage would be one object across every variant library of
// this source loaded into a process.
namespace {
namespace wg {

constexpr int kBM = 128;       // rows of a tile: two consumer warpgroups
constexpr int kBK = 64;        // K of a ring stage: one 128-byte bf16 row
constexpr int kThreads = 256;
constexpr int kTileA = kBM * 2 * kBK;          // bytes of an A tile
constexpr long long kPlanBudget = 24LL << 20;  // unchunked plans, at most
constexpr int kMaxQ = 64;                      // tap chunks, at most

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Columns of the forward and inverse tiles and ring stages at each arm and
// entry.
template <bool kHigh, bool kChunked>
struct Tiles;
template <>
struct Tiles<false, false> {
  static constexpr int kFwdN = 192, kInvN = 240, kFwdStages = 4,
                       kInvStages = 4;
};
template <>
struct Tiles<true, false> {
  static constexpr int kFwdN = 128, kInvN = 128, kFwdStages = 3,
                       kInvStages = 3;
};
template <>
struct Tiles<false, true> {
  static constexpr int kFwdN = 128, kInvN = 80, kFwdStages = 6,
                       kInvStages = 6;
};
template <>
struct Tiles<true, true> {
  static constexpr int kFwdN = 128, kInvN = 80, kFwdStages = 3,
                       kInvStages = 4;
};

// A ring stage: [A hi | A lo | B hi | B lo] (lo at HIGH only), each part
// 1 KB aligned (the 128-byte swizzle repeats every 8 rows); the block's
// shared memory is 1 KB of alignment slack, the ring, then one mbarrier a
// stage.
template <bool kHigh, int kBN, int kStages>
struct Ring {
  static constexpr int kParts = kHigh ? 2 : 1;
  static constexpr int kB = kBN * 2 * kBK;
  static constexpr int kStage = kParts * (kTileA + kB);
  static constexpr int kBytes = 1024 + kStages * kStage + 8 * kStages;
};

// The layout of one geometry at one arm and entry, fixed on the host
// (kernels/mlsa.py:tc_layout computes the same).
struct Layout {
  int P, P8, n_blk, K, Kp;
  int kf, Kf;        // forward contraction n_blk P8, and rounded up to kBK
  int Nf;            // forward columns: 2 Kp rounded up to the tile
  int bn_f, bn_i;    // the forward and inverse tiles' columns
  int w, n_ctile;    // frame columns a tile of the inverse, and its tiles
  int Ni;            // inverse columns: n_ctile bn_i
  int Q;             // tap chunks (1: unchunked)
  int pre, after;    // zero frames before and after each batch row
};

template <bool kHigh, bool kChunked>
Layout make_layout(int P, int Q, int r0, int n_blk, int K) {
  using T = Tiles<kHigh, kChunked>;
  Layout L;
  L.P = P;
  L.P8 = round_up(P, 8);
  L.n_blk = n_blk;
  L.K = K;
  L.Kp = round_up(K, 32);
  L.kf = n_blk * L.P8;
  L.Kf = round_up(L.kf, kBK);
  L.bn_f = T::kFwdN;
  L.bn_i = T::kInvN;
  L.Nf = round_up(2 * L.Kp, L.bn_f);
  L.w = L.bn_i / 2;
  L.n_ctile = (P + L.w - 1) / L.w;
  L.Ni = L.n_ctile * L.bn_i;
  L.Q = Q;
  L.pre = Q - 1 + r0;
  L.after = n_blk - 1 - r0 + (L.pre == 0 ? 1 : 0);
  return L;
}

Layout layout_of(int P, int Q, int r0, int n_blk, int K, bool high,
                 bool chunked) {
  if (chunked) {
    return high ? make_layout<true, true>(P, Q, r0, n_blk, K)
                : make_layout<false, true>(P, Q, r0, n_blk, K);
  }
  return high ? make_layout<true, false>(P, Q, r0, n_blk, K)
              : make_layout<false, false>(P, Q, r0, n_blk, K);
}

long long plan_bytes(const Layout& L, bool high) {
  return (static_cast<long long>(L.Nf) * L.Kf +
          static_cast<long long>(L.Ni) * 2 * L.Kp) * 2 * (high ? 2 : 1);
}

// The scratch of one call: two padded states (Np rows of P8 a batch row,
// n_blk frames of zeros after the last) and Y, each hi (and lo at HIGH),
// each part 1 KB aligned.
struct Work {
  long long Np;          // frames a batch row in the padded state
  long long state, ys;   // elements of a state part and of a Y part
  long long bytes;
};

Work make_work(int B, int N, const Layout& L, bool high) {
  Work k;
  k.Np = static_cast<long long>(L.pre) + N + L.after;
  k.state = ((B * k.Np + L.n_blk) * L.P8 + 511) / 512 * 512;
  k.ys = (B * k.Np * 2 * L.Kp + 511) / 512 * 512;
  k.bytes = (2 * k.state + k.ys) * 2 * (high ? 2 : 1);
  return k;
}

// v = hi + lo, both bf16, rounded to nearest (lo is v - hi rounded).
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, or zeros where ``ok`` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Four floats from global memory (16-byte aligned) under an L2 cache
// policy, not kept in L1.
__device__ __forceinline__ void ld_stream4(float (&v)[4], const float* p,
                                           uint64_t policy) {
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
      : "l"(p), "l"(policy));
}

// ``bytes`` (a multiple of 16) from global memory (16-byte aligned) into
// L2, with no thread waiting for them.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// The L2 cache policy evict-first, for data read once.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, %1;\n"
               : "=l"(policy)
               : "f"(1.f));
  return policy;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of ``parity`` to complete; traps (an error on the
// stream, not a hang) if a tile has not landed after 2^22 polls.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 22)) __trap();
  }
}

// One bulk copy (the TMA engine, no tensor map) of ``bytes`` contiguous
// bytes, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a K-major operand with the 128-byte swizzle:
// rows of 128 bytes, groups of 8 rows 1 KB apart.
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator accesses across the wgmma
// fences and waits.
template <int kR>
__device__ __forceinline__ void fence_acc(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) += A (64 x 16) B (16 x N), both bf16 K-major in shared
// memory.  Inline assembly names every accumulator register, so each
// width is written out.
__device__ __forceinline__ void wgmma_n80(float (&d)[40], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n240(float (&d)[120], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
      : "l"(a), "l"(b), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma(float (&d)[kBN / 2], uint64_t a,
                                      uint64_t b) {
  static_assert(kBN == 80 || kBN == 128 || kBN == 192 || kBN == 240,
                "tile width");
  if constexpr (kBN == 80) {
    wgmma_n80(d, a, b);
  } else if constexpr (kBN == 128) {
    wgmma_n128(d, a, b);
  } else if constexpr (kBN == 192) {
    wgmma_n192(d, a, b);
  } else {
    wgmma_n240(d, a, b);
  }
}

// The A rows of k-block kb into a ring stage, 16 bytes a thread, with the
// 128-byte swizzle (chunk c of row r at chunk c ^ (r & 7)); rows before 0
// or past ``rows`` and columns past ``kvalid`` read as zeros.
template <bool kHigh>
__device__ __forceinline__ void load_a(uint32_t dst,
                                       const __nv_bfloat16* a_hi,
                                       const __nv_bfloat16* a_lo,
                                       long long lda, int row0, int rows,
                                       int kvalid, int kb, int tid) {
#pragma unroll
  for (int u = 0; u < kBM * 8 / kThreads; ++u) {
    const int q = tid + u * kThreads;
    const int r = q >> 3;
    const int c = q & 7;
    const int row = row0 + r;
    const int k = kb * kBK + c * 8;
    const bool ok = row >= 0 && row < rows && k < kvalid;
    const long long off = ok ? row * lda + k : 0;
    const uint32_t s = dst + r * 128 + ((c ^ (r & 7)) << 4);
    cp_async16(s, a_hi + off, ok);
    if (kHigh) cp_async16(s + kTileA, a_lo + off, ok);
  }
}

// The plan's tile (rows n0 .. n0 + kBN of k-block kb) into a ring stage:
// one bulk copy a half, the image already swizzled on the host.
template <bool kHigh, int kBN>
__device__ __forceinline__ void load_b(uint32_t dst, uint32_t bar,
                                       const __nv_bfloat16* b_hi,
                                       const __nv_bfloat16* b_lo,
                                       int b_rows, int n0, int kb) {
  constexpr uint32_t kBytes = kBN * 2 * kBK;
  mbar_expect(bar, (kHigh ? 2 : 1) * kBytes);
  const long long off = (static_cast<long long>(kb) * b_rows + n0) * kBK;
  bulk_copy(dst, b_hi + off, kBytes, bar);
  if (kHigh) bulk_copy(dst + kBytes, b_lo + off, kBytes, bar);
}

// acc (this warpgroup's 64 x kBN of the tile) = A[row0 .. row0 + 128) @
// the plan's column tile n0, over KT ring stages.  Waits for the previous
// launch after the plan's first tiles are on their way; runs ``early()``
// once the ring's first loads are issued.  Stage kt + S - 2
// loads while stage kt multiplies, with one wgmma group in flight: the
// slot refilled at kt was read at kt - 2, which every warpgroup finished
// (wait_group 1 at kt - 1) before the barrier at kt.
template <bool kHigh, int kBN, int kStages, class Early>
__device__ __forceinline__ void mainloop(
    float (&acc)[kBN / 2], uint32_t ring, const __nv_bfloat16* a_hi,
    const __nv_bfloat16* a_lo, long long lda, int row0, int rows, int kvalid,
    const __nv_bfloat16* b_hi, const __nv_bfloat16* b_lo, int b_rows, int n0,
    int KT, Early early) {
  using R = Ring<kHigh, kBN, kStages>;
  static_assert(kStages >= 3, "the ring keeps a stage ahead");
  const int tid = threadIdx.x;
  const uint32_t bars = ring + kStages * R::kStage;
  const uint32_t b_off = R::kParts * kTileA;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int kb = 0; kb < kStages - 2 && kb < KT; ++kb) {
      load_b<kHigh, kBN>(ring + kb * R::kStage + b_off, bars + 8 * kb, b_hi,
                         b_lo, b_rows, n0, kb);
    }
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int kb = 0; kb < kStages - 2; ++kb) {
    if (kb < KT) {
      load_a<kHigh>(ring + kb * R::kStage, a_hi, a_lo, lda, row0, rows,
                    kvalid, kb, tid);
    }
    cp_async_commit();
  }
  early();
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_wg = (tid >> 7) * (64 * 128);
  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % kStages;
    cp_async_wait<kStages - 3>();
    mbar_wait(bars + 8 * slot, (kt / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int nk = kt + kStages - 2;
    if (nk < KT) {
      const uint32_t st = ring + (nk % kStages) * R::kStage;
      load_a<kHigh>(st, a_hi, a_lo, lda, row0, rows, kvalid, nk, tid);
      if (tid == 0) {
        load_b<kHigh, kBN>(st + b_off, bars + 8 * (nk % kStages), b_hi,
                           b_lo, b_rows, n0, nk);
      }
    }
    cp_async_commit();
    const uint32_t sa = ring + slot * R::kStage + a_wg;
    const uint32_t sb = ring + slot * R::kStage + b_off;
    fence_acc(acc);
    wg_fence();
#ifndef MLSA_TC_ABLATE_MMA
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t ah = sw128(sa + 32 * kk);
      const uint64_t bh = sw128(sb + 32 * kk);
      wgmma<kBN>(acc, ah, bh);
      if (kHigh) {
        wgmma<kBN>(acc, ah, sw128(sb + R::kB + 32 * kk));
        wgmma<kBN>(acc, sw128(sa + kTileA + 32 * kk), bh);
      }
    }
#endif
    wg_commit();
    wg_wait<1>();
    fence_acc(acc);
  }
  wg_wait<0>();
  fence_acc(acc);
}

// Stage s, first GEMM: X = ctx @ Ffwd over one tile of 128 rows (rows of
// the flattened padded grid: row i of a batch row is frame i - (Q - 1)) by
// kFwdN columns (bins' re, im side by side), then Y[i] = sum_j X[i - j] *
// C[b, min(m, N-1), j] for frames 0 <= m <= N (zero otherwise), split,
// into the scratch y (M x 2 Kp, bin k's re and im at 2k, 2k + 1).  The row
// tiles step by 129 - Q rows, the first starting at row 1 - Q: each tile
// writes Y for its rows but the first Q - 1.  Grid: row tiles x column
// tiles, the column tile fastest.
template <bool kHigh, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
tc_fwd_kernel(const __nv_bfloat16* __restrict__ st_hi,
              const __nv_bfloat16* __restrict__ st_lo,
              const __nv_bfloat16* __restrict__ f_hi,
              const __nv_bfloat16* __restrict__ f_lo,
              const float* __restrict__ cre, const float* __restrict__ cim,
              __nv_bfloat16* __restrict__ y_hi,
              __nv_bfloat16* __restrict__ y_lo, Layout L, int N, int Np,
              int M) {
  constexpr int kBN = Tiles<kHigh, kChunked>::kFwdN;
  constexpr int kStages = Tiles<kHigh, kChunked>::kFwdStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = smem_u32(wg_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const int n_tiles = L.Nf / kBN;
  const int tn = blockIdx.x % n_tiles;
  const int qh = L.Q - 1;
  const int row0 = (blockIdx.x / n_tiles) * (kBM - qh) - qh;
  const int n0 = tn * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = 2 * L.Kp;
  const int t4 = 4 * (lane & 3);
  const bool vec = L.K % 4 == 0;
  // The spectra: row (b, n, j) of 2K floats, re at k, im at K + k.
  const size_t crs = 2 * static_cast<size_t>(L.K);
  auto crow = [&](int b, int m) {
    return (static_cast<size_t>(b) * N + (m < N ? m : N - 1)) * L.Q * crs;
  };
  constexpr int kQ = kBN / 32;

  // Unchunked: column c = 32 g + 8 jj + 2 t + e of the plan holds part e
  // (re, im) of bin 16 g + 4 t + jj, so that a thread (t = lane & 3) holds
  // four consecutive bins of each row: it loads their coefficients as one
  // float4 (where K % 4 == 0) and stores their Y as 16 bytes.  The
  // coefficients of its two rows load into registers once the ring's
  // first loads are issued (the spectra are inputs of the call, ready
  // before the first stage): their latency hides under the main loop.
  // They stream through L2 marked evict-first (23.8 MB a stage at
  // [chain48]'s shapes, read once a stage), so that they push less of Y,
  // the state and y out of it.
  constexpr int kRegC = kChunked ? 1 : 2;
  int rows[kRegC];
  bool live[kRegC];
  float c_re[kRegC][kQ][4], c_im[kRegC][kQ][4];
  auto load_c = [&] {
    if constexpr (!kChunked) {
      const uint64_t policy = evict_first();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h] = row0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 +
                  (lane >> 2) + 8 * h;
        const int b = rows[h] < M ? rows[h] / Np : 0;
        const int m = rows[h] - b * Np;
        live[h] = rows[h] < M && m <= N;
        const size_t cr = crow(b, m);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int k0 = n0 / 2 + 16 * q + t4;
          if (vec && live[h] && k0 < L.K) {
            ld_stream4(c_re[h][q], cre + cr + k0, policy);
            ld_stream4(c_im[h][q], cim + cr + k0, policy);
          } else {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const bool ok = live[h] && k0 + jj < L.K;
              c_re[h][q][jj] = ok ? __ldg(cre + cr + k0 + jj) : 0.f;
              c_im[h][q][jj] = ok ? __ldg(cim + cr + k0 + jj) : 0.f;
            }
          }
        }
      }
    }
  };

  float acc[kBN / 2];
  mainloop<kHigh, kBN, kStages>(acc, ring, st_hi, st_lo, L.P8, row0, M, L.kf,
                                f_hi, f_lo, L.Nf, n0, L.Kf / kBK, load_c);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#ifdef MLSA_TC_ABLATE_EPILOGUE
  return;
#endif
  if constexpr (kChunked) {
    // X (fp32) into shared memory over the ring: row r holds the re of
    // the tile's kNb bins, then their im.
    constexpr int kNb = kBN / 2;
    constexpr int kLdx = kBN + 16;
    constexpr int kG = kNb / 4;       // groups of four bins a row
    constexpr int kIt = 4;            // rows' groups a thread takes at once
    constexpr int kJ = 4;             // chunks whose loads issue together
    static_assert(kBM * kLdx * 4 <=
                      kStages * Ring<kHigh, kBN, kStages>::kStage,
                  "X fits over the ring");
    float* xs = reinterpret_cast<float*>(wg_smem + (ring - base));
    __syncthreads();   // every warpgroup's products are done with the ring
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) +
                    8 * h;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int j = 4 * q;
        *reinterpret_cast<float4*>(xs + r * kLdx + 16 * q + t4) =
            make_float4(acc[4 * j + 2 * h], acc[4 * (j + 1) + 2 * h],
                        acc[4 * (j + 2) + 2 * h], acc[4 * (j + 3) + 2 * h]);
        *reinterpret_cast<float4*>(xs + r * kLdx + kNb + 16 * q + t4) =
            make_float4(acc[4 * j + 2 * h + 1], acc[4 * (j + 1) + 2 * h + 1],
                        acc[4 * (j + 2) + 2 * h + 1],
                        acc[4 * (j + 3) + 2 * h + 1]);
      }
    }
    __syncthreads();
    const uint64_t policy = evict_first();
    // Item it: row qh + it / kG of the tile, bins 4 (it % kG) .. + 3.
    const int items = (kBM - qh) * kG;
    for (int it0 = tid; it0 < items; it0 += kIt * kThreads) {
      int r[kIt], k0[kIt];
      size_t cr[kIt];
      bool on[kIt], out[kIt];
#pragma unroll
      for (int v = 0; v < kIt; ++v) {
        const int it = it0 + v * kThreads;
        r[v] = qh + it / kG;
        k0[v] = n0 / 2 + 4 * (it - (r[v] - qh) * kG);
        const int row = row0 + r[v];
        out[v] = it < items && row >= 0 && row < M && 2 * k0[v] < ld;
        const int b = out[v] ? row / Np : 0;
        const int m = row - b * Np - qh;
        on[v] = out[v] && m >= 0 && m <= N && k0[v] < L.K;
        cr[v] = on[v] ? crow(b, m) + k0[v] : 0;
      }
      float yr[kIt][4], yi[kIt][4];
#pragma unroll
      for (int v = 0; v < kIt; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) yr[v][e] = yi[v][e] = 0.f;
      for (int j0 = 0; j0 < L.Q; j0 += kJ) {
        float cr4[kIt][kJ][4], ci4[kIt][kJ][4];
#pragma unroll
        for (int v = 0; v < kIt; ++v)
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            const bool ok = on[v] && j0 + jj < L.Q;
            const float* p = cre + cr[v] + (j0 + jj) * crs;
            if (ok && vec) {
              ld_stream4(cr4[v][jj], p, policy);
              ld_stream4(ci4[v][jj], p + L.K, policy);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool ok_e = ok && k0[v] + e < L.K;
                cr4[v][jj][e] = ok_e ? __ldg(p + e) : 0.f;
                ci4[v][jj][e] = ok_e ? __ldg(p + L.K + e) : 0.f;
              }
            }
          }
#pragma unroll
        for (int v = 0; v < kIt; ++v)
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            if (!on[v] || j0 + jj >= L.Q) continue;
            const float* xr =
                xs + (r[v] - j0 - jj) * kLdx + (k0[v] - n0 / 2);
            const float4 x_re = *reinterpret_cast<const float4*>(xr);
            const float4 x_im = *reinterpret_cast<const float4*>(xr + kNb);
            const float re[4] = {x_re.x, x_re.y, x_re.z, x_re.w};
            const float im[4] = {x_im.x, x_im.y, x_im.z, x_im.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              yr[v][e] += re[e] * cr4[v][jj][e] - im[e] * ci4[v][jj][e];
              yi[v][e] += re[e] * ci4[v][jj][e] + im[e] * cr4[v][jj][e];
            }
          }
      }
#pragma unroll
      for (int v = 0; v < kIt; ++v) {
        if (!out[v]) continue;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat16 h0, l0, h1, l1;
          split(yr[v][e], h0, l0);
          split(yi[v][e], h1, l1);
          const __nv_bfloat162 hh = __halves2bfloat162(h0, h1);
          const __nv_bfloat162 ll = __halves2bfloat162(l0, l1);
          hi[e] = *reinterpret_cast<const uint32_t*>(&hh);
          lo[e] = *reinterpret_cast<const uint32_t*>(&ll);
        }
        const size_t o =
            static_cast<size_t>(row0 + r[v]) * ld + 2 * k0[v];
        *reinterpret_cast<uint4*>(y_hi + o) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        if (kHigh) {
          *reinterpret_cast<uint4*>(y_lo + o) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= M) continue;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int k0 = n0 / 2 + 16 * q + t4;
        if (2 * k0 >= ld) continue;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj;
          const bool ok = live[h] && k0 + jj < L.K;
          const float xr = acc[4 * j + 2 * h];
          const float xi = acc[4 * j + 2 * h + 1];
          const float yr =
              ok ? xr * c_re[h][q][jj] - xi * c_im[h][q][jj] : 0.f;
          const float yi =
              ok ? xr * c_im[h][q][jj] + xi * c_re[h][q][jj] : 0.f;
          __nv_bfloat16 h0, l0, h1, l1;
          split(yr, h0, l0);
          split(yi, h1, l1);
          const __nv_bfloat162 hh = __halves2bfloat162(h0, h1);
          const __nv_bfloat162 ll = __halves2bfloat162(l0, l1);
          hi[jj] = *reinterpret_cast<const uint32_t*>(&hh);
          lo[jj] = *reinterpret_cast<const uint32_t*>(&ll);
        }
        const size_t o = static_cast<size_t>(rows[h]) * ld + 2 * k0;
        *reinterpret_cast<uint4*>(y_hi + o) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        if (kHigh) {
          *reinterpret_cast<uint4*>(y_lo + o) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
    }
  }
}

// Stage s, second GEMM: V = Y @ G over a tile of 128 rows (127 frames and
// a halo row) by kInvN columns (groups of 8: lo (1 - lam) of p0 .. p0 + 7,
// hi lam of the same p, ...).  The epilogue puts V in shared memory (over
// the ring) and, per frame 0 <= m < N (row i = m + Q - 1 of its batch row)
// and p < P: out = (V[i, lo p] + V[i+1, hi p]) w_s, y += a_s out (y = a_0
// x0 + a_1 out at s = 1), the next state (s < S) split into the padded
// layout (zeros past P).
template <bool kHigh, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
tc_inv_kernel(const __nv_bfloat16* __restrict__ y_hi,
              const __nv_bfloat16* __restrict__ y_lo,
              const __nv_bfloat16* __restrict__ g_hi,
              const __nv_bfloat16* __restrict__ g_lo,
              const float* __restrict__ x0, float* __restrict__ y,
              __nv_bfloat16* __restrict__ nx_hi,
              __nv_bfloat16* __restrict__ nx_lo,
              const float* __restrict__ w, const float* __restrict__ a,
              const float* __restrict__ cre, Layout L, int N, int Np, int M,
              int S, int s) {
  constexpr int kBN = Tiles<kHigh, kChunked>::kInvN;
  constexpr int kStages = Tiles<kHigh, kChunked>::kInvStages;
  constexpr int kW = kBN / 2;
  constexpr int kLdv = kBN + 4;
  static_assert(kBM * kLdv * 4 <= kStages * Ring<kHigh, kBN, kStages>::kStage,
                "V fits over the ring");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = smem_u32(wg_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const int tn = blockIdx.x % L.n_ctile;
  const int row0 = (blockIdx.x / L.n_ctile) * (kBM - 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int qh = L.Q - 1;

  if constexpr (kChunked) {
#ifndef MLSA_TC_NO_PREFETCH
    // Chunked, the next stage's forward epilogue reads the spectra of
    // these rows' frames (23.6 MB a stage at the flagship) from device
    // memory; this launch reads little from it, so it moves them into L2
    // first: one bulk prefetch of a frame's Q x 2K floats (contiguous), the
    // tile's rows shared among its column tiles.  They are inputs of the
    // call, ready before the first stage, so this runs before the wait, to
    // give the copies all of this launch's time (issued after the main
    // loop, they gained less).
    const uint32_t bytes = static_cast<uint32_t>(L.Q) * 8 * L.K;
    if (s < S && bytes % 16 == 0) {
      for (int r = tn + L.n_ctile * tid; r < kBM - 1;
           r += L.n_ctile * kThreads) {
        const int row = row0 + r;
        if (row >= M) break;
        const int b = row / Np;
        const int m = row - b * Np - qh;
        if (m < 0 || m > N) continue;
        const size_t frame = static_cast<size_t>(b) * N + (m < N ? m : N - 1);
        prefetch_l2(cre + frame * L.Q * 2 * L.K, bytes);
      }
    }
#endif
  }

  // The outputs in groups of 4 consecutive p, kItems groups a thread.
  // Each group's y (x0 at s = 1) loads into registers once the ring's
  // first loads are issued (after the wait for the previous launch, which
  // wrote y): their latency hides under the main loop.  Where P % 4 == 0
  // a group is one float4 of y and one 8-byte store a state half.
  constexpr int kG = kW / 4;
  constexpr int kItems = ((kBM - 1) * kG + kThreads - 1) / kThreads;
  const bool vec = L.P % 4 == 0;
  float prev[kItems][4];
  auto group = [&](int u, int& r, int& pl, int& b, int& m) {
    const int item = tid + u * kThreads;
    r = item / kG;
    pl = 4 * (item - r * kG);
    const int row = row0 + r;
    b = row / Np;
    m = row - b * Np - qh;
    return item < (kBM - 1) * kG && row < M && m >= 0 && m < N &&
           tn * kW + pl < L.P;
  };
  auto load_prev = [&] {
    const float* src = s == 1 ? x0 : y;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      int r, pl, b, m;
      const bool ok = group(u, r, pl, b, m);
      const int p = tn * kW + pl;
      const size_t at = (static_cast<size_t>(b) * N + m) * L.P + p;
      if (ok && vec) {
        const float4 v = *reinterpret_cast<const float4*>(src + at);
        prev[u][0] = v.x;
        prev[u][1] = v.y;
        prev[u][2] = v.z;
        prev[u][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          prev[u][e] = ok && p + e < L.P ? src[at + e] : 0.f;
        }
      }
    }
  };

  float acc[kBN / 2];
  mainloop<kHigh, kBN, kStages>(acc, ring, y_hi, y_lo, 2 * L.Kp, row0, M,
                                2 * L.Kp, g_hi, g_lo, L.Ni, tn * kBN,
                                2 * L.Kp / kBK, load_prev);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#ifdef MLSA_TC_ABLATE_EPILOGUE
  return;
#endif

  float* vs = reinterpret_cast<float*>(wg_smem + (ring - base));
  __syncthreads();   // every warpgroup's products are done with the ring
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) +
                  8 * h;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      *reinterpret_cast<float2*>(vs + r * kLdv + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  const float w_s = w[s];
  const float a_p = s == 1 ? a[0] : 1.f;
  const float a_s = a[s];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    int r, pl, b, m;
    if (!group(u, r, pl, b, m)) continue;
    const int p = tn * kW + pl;
    const int c = 16 * (pl >> 3) + (pl & 7);
    const float4 lo = *reinterpret_cast<const float4*>(vs + r * kLdv + c);
    const float4 hi =
        *reinterpret_cast<const float4*>(vs + (r + 1) * kLdv + c + 8);
    const float val[4] = {(lo.x + hi.x) * w_s, (lo.y + hi.y) * w_s,
                          (lo.z + hi.z) * w_s, (lo.w + hi.w) * w_s};
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = a_p * prev[u][e] + a_s * val[e];
    const size_t at = (static_cast<size_t>(b) * N + m) * L.P + p;
    if (vec) {
      *reinterpret_cast<float4*>(y + at) =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (p + e < L.P) y[at + e] = out[e];
      }
    }
    if (s < S) {
      const size_t o =
          (static_cast<size_t>(b) * Np + L.pre + m) * L.P8 + p;
      uint32_t h2[2], l2[2];
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        __nv_bfloat16 h0, l0, h1, l1;
        split(p + e < L.P ? val[e] : 0.f, h0, l0);
        split(p + e + 1 < L.P ? val[e + 1] : 0.f, h1, l1);
        const __nv_bfloat162 hh = __halves2bfloat162(h0, h1);
        const __nv_bfloat162 ll = __halves2bfloat162(l0, l1);
        h2[e / 2] = *reinterpret_cast<const uint32_t*>(&hh);
        l2[e / 2] = *reinterpret_cast<const uint32_t*>(&ll);
      }
      *reinterpret_cast<uint2*>(nx_hi + o) = make_uint2(h2[0], h2[1]);
      if (kHigh) {
        *reinterpret_cast<uint2*>(nx_lo + o) = make_uint2(l2[0], l2[1]);
      }
    }
  }
}

// Before stage 1: x split into state 0's padded layout (zeros in the pad
// frames and past P), state 1 zeroed (its pads stay zero: the stages write
// frames m < N, p < P only).
template <bool kHigh>
__global__ void __launch_bounds__(256)
tc_prep_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ s0h,
               __nv_bfloat16* __restrict__ s0l,
               __nv_bfloat16* __restrict__ s1h,
               __nv_bfloat16* __restrict__ s1l, int B, int N, int P, int P8,
               int Np, int pre, long long total) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += 256LL * gridDim.x) {
    const long long frame = i / P8;
    const int p = static_cast<int>(i - frame * P8);
    const long long b = frame / Np;
    const int f = static_cast<int>(frame - b * Np) - pre;
    const float v = b < B && f >= 0 && f < N && p < P
                        ? x[(b * N + f) * P + p]
                        : 0.f;
    __nv_bfloat16 hi, lo;
    split(v, hi, lo);
    s0h[i] = hi;
    s1h[i] = zero;
    if (kHigh) {
      s0l[i] = lo;
      s1l[i] = zero;
    }
  }
}

template <bool kHigh, bool kChunked>
int fwd_smem() {
  using T = Tiles<kHigh, kChunked>;
  return Ring<kHigh, T::kFwdN, T::kFwdStages>::kBytes;
}

template <bool kHigh, bool kChunked>
int inv_smem() {
  using T = Tiles<kHigh, kChunked>;
  return Ring<kHigh, T::kInvN, T::kInvStages>::kBytes;
}

template <bool kHigh, bool kChunked>
int set_attributes() {
  static int err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        tc_fwd_kernel<kHigh, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem<kHigh, kChunked>());
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(tc_inv_kernel<kHigh, kChunked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               inv_smem<kHigh, kChunked>());
    }
    return static_cast<int>(e);
  }();
  return err;
}

// Whether an entry takes a geometry: 1 <= Q <= kMaxQ, r0 zero frames of
// context before a frame at most n_blk - 1 (frame N's context runs one
// frame into the next row's zeros), the unchunked plans within
// kPlanBudget, indices within int.
bool takes(const Layout& L, int B, int N, int r0, bool high, bool chunked) {
  const Work k = make_work(B, N, L, high);
  return L.Q >= 1 && L.Q <= kMaxQ && r0 >= 0 && r0 <= L.n_blk - 1 &&
         (chunked || plan_bytes(L, high) <= kPlanBudget) &&
         (B * k.Np + L.n_blk) * L.P8 < (1LL << 31) &&
         B * k.Np * 2 * L.Kp < (1LL << 31);
}

template <bool kHigh, bool kChunked>
int run(const float* x, const float* cre, const float* cim,
        const __nv_bfloat16* fh, const __nv_bfloat16* fl,
        const __nv_bfloat16* gh, const __nv_bfloat16* gl, const float* w,
        const float* a, unsigned char* work, float* y, int B, int N, int P,
        int Q, int r0, int n_blk, int K, int S, cudaStream_t stream) {
  const Layout L = make_layout<kHigh, kChunked>(P, Q, r0, n_blk, K);
  if (!takes(L, B, N, r0, kHigh, kChunked)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err0 = set_attributes<kHigh, kChunked>();
  if (err0 != 0) return err0;
  const Work k = make_work(B, N, L, kHigh);
  const int Np = static_cast<int>(k.Np);
  const int M = B * Np;
  __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(work);
  __nv_bfloat16* st[2][2];
  for (int i = 0; i < 2; ++i) {
    st[i][0] = p;
    p += k.state;
    st[i][1] = kHigh ? p : nullptr;
    if (kHigh) p += k.state;
  }
  __nv_bfloat16* yh = p;
  __nv_bfloat16* yl = kHigh ? p + k.ys : nullptr;
  const long long total = (static_cast<long long>(M) + n_blk) * L.P8;
  const long long want = (total + 255) / 256;
  tc_prep_kernel<kHigh><<<static_cast<int>(want < 4096 ? want : 4096), 256,
                          0, stream>>>(x, st[0][0], st[0][1], st[1][0],
                                       st[1][1], B, N, P, L.P8, Np, L.pre,
                                       total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  const int step = kBM - (Q - 1);
  cudaLaunchConfig_t fwd = {};
  fwd.gridDim = dim3(((M + step - 1) / step) * (L.Nf / L.bn_f));
  fwd.blockDim = dim3(kThreads);
  fwd.dynamicSmemBytes = fwd_smem<kHigh, kChunked>();
  fwd.stream = stream;
#ifndef MLSA_TC_NO_PDL
  fwd.attrs = &attr;
  fwd.numAttrs = 1;
#endif
  cudaLaunchConfig_t inv = fwd;
  inv.gridDim = dim3(((M + kBM - 2) / (kBM - 1)) * L.n_ctile);
  inv.dynamicSmemBytes = inv_smem<kHigh, kChunked>();
  for (int s = 1; s <= S; ++s) {
    __nv_bfloat16* const* src = st[(s - 1) % 2];
    __nv_bfloat16* const* dst = st[s % 2];
    err = cudaLaunchKernelEx(&fwd, tc_fwd_kernel<kHigh, kChunked>, src[0],
                             src[1], fh, fl, cre, cim, yh, yl, L, N, Np, M);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&inv, tc_inv_kernel<kHigh, kChunked>, yh, yl,
                             gh, gl, x, y, dst[0], dst[1], w, a, cre, L, N,
                             Np, M, S, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kHigh, bool kChunked>
int per_sm(const void* kernel, int bytes) {
  if (set_attributes<kHigh, kChunked>() != 0) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    bytes) != cudaSuccess) {
    return 0;
  }
  return n;
}

template <bool kHigh, bool kChunked>
void occupancy(int* out) {
  out[0] = per_sm<kHigh, kChunked>(
      reinterpret_cast<const void*>(tc_fwd_kernel<kHigh, kChunked>),
      fwd_smem<kHigh, kChunked>());
  out[1] = per_sm<kHigh, kChunked>(
      reinterpret_cast<const void*>(tc_inv_kernel<kHigh, kChunked>),
      inv_smem<kHigh, kChunked>());
}

template <bool kHigh, bool kChunked>
void sizes(int* out) {
  using T = Tiles<kHigh, kChunked>;
  out[0] = fwd_smem<kHigh, kChunked>();
  out[1] = inv_smem<kHigh, kChunked>();
  out[2] = T::kFwdStages;
  out[3] = T::kInvStages;
}

int launch(const void* x, const void* cre, const void* cim, const void* f_hi,
           const void* f_lo, const void* g_hi, const void* g_lo,
           const void* w, const void* a, void* work, void* y, int B, int N,
           int P, int Q, int r0, int n_blk, int K, int S, int high,
           bool chunked, void* stream) {
  if (B < 1 || N < 1 || P < 1 || n_blk < 1 || K < 1 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* fh = static_cast<const __nv_bfloat16*>(f_hi);
  const auto* fl = static_cast<const __nv_bfloat16*>(f_lo);
  const auto* gh = static_cast<const __nv_bfloat16*>(g_hi);
  const auto* gl = static_cast<const __nv_bfloat16*>(g_lo);
  const auto* xf = static_cast<const float*>(x);
  const auto* cr = static_cast<const float*>(cre);
  const auto* ci = static_cast<const float*>(cim);
  const auto* wf = static_cast<const float*>(w);
  const auto* af = static_cast<const float*>(a);
  auto* wk = static_cast<unsigned char*>(work);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (chunked) {
    return high ? run<true, true>(xf, cr, ci, fh, fl, gh, gl, wf, af, wk, yf,
                                  B, N, P, Q, r0, n_blk, K, S, st)
                : run<false, true>(xf, cr, ci, fh, fl, gh, gl, wf, af, wk,
                                   yf, B, N, P, Q, r0, n_blk, K, S, st);
  }
  return high ? run<true, false>(xf, cr, ci, fh, fl, gh, gl, wf, af, wk, yf,
                                 B, N, P, 1, r0, n_blk, K, S, st)
              : run<false, false>(xf, cr, ci, fh, fl, gh, gl, wf, af, wk, yf,
                                  B, N, P, 1, r0, n_blk, K, S, st);
}

}  // namespace wg
}  // namespace

// The layout of a geometry at one arm (high) and entry (chunked), into
// out[0..15]: P8, kf, Kf, Kp, Nf, forward tile columns, inverse tile
// columns, w, column tiles of the inverse, Ni, zero frames before and
// after a batch row, the forward's and the inverse's shared memory bytes,
// ring stages of each.  Returns the plans' bytes, or -1 where the entry
// refuses the geometry (see wg::takes).
extern "C" long long mlsa_cascade_tc_layout(int P, int Q, int r0, int n_blk,
                                           int K, int high, int chunked,
                                           int* out) {
  if (P < 1 || Q < 1 || n_blk < 1 || K < 1) return -1;
  const wg::Layout L =
      wg::layout_of(P, Q, r0, n_blk, K, high != 0, chunked != 0);
  const int vals[12] = {L.P8, L.kf,      L.Kf, L.Kp,    L.Nf,  L.bn_f,
                        L.bn_i, L.w, L.n_ctile, L.Ni, L.pre, L.after};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  if (chunked) {
    high ? wg::sizes<true, true>(out + 12) : wg::sizes<false, true>(out + 12);
  } else {
    high ? wg::sizes<true, false>(out + 12)
         : wg::sizes<false, false>(out + 12);
  }
  if (!wg::takes(L, 1, 1, r0, high != 0, chunked != 0)) return -1;
  return wg::plan_bytes(L, high != 0);
}

// Blocks of the forward and the inverse kernel that fit on one SM at an
// arm and entry (0 where the query fails), into out[0..1].
extern "C" int mlsa_cascade_tc_occupancy(int high, int chunked, int* out) {
  if (chunked) {
    high ? wg::occupancy<true, true>(out) : wg::occupancy<false, true>(out);
  } else {
    high ? wg::occupancy<true, false>(out) : wg::occupancy<false, false>(out);
  }
  return 0;
}

// Bytes of the scratch a call at (B, N) takes (the wrapper allocates it),
// or -1 where the entry refuses the geometry.
extern "C" long long mlsa_cascade_tc_workspace(int B, int N, int P, int Q,
                                              int r0, int n_blk, int K,
                                              int high, int chunked) {
  if (B < 1 || N < 1 || P < 1 || Q < 1 || n_blk < 1 || K < 1) return -1;
  const wg::Layout L =
      wg::layout_of(P, Q, r0, n_blk, K, high != 0, chunked != 0);
  if (!wg::takes(L, B, N, r0, high != 0, chunked != 0)) return -1;
  return wg::make_work(B, N, L, high != 0).bytes;
}

// The tap-chunked geometry (the B2 row): x (B, N, P) float32; the
// coefficient spectra of the Q tap chunks, cre and cim, each (B, N, Q, K)
// float32 in rows of 2K floats (cim = cre + K: one (B, N, Q, 2K) array, as
// kernels/mlsa.py:coef_spectrum_cat makes it); the plans f_hi, f_lo
// (forward, (Kf / 64, Nf, 64)) and g_hi, g_lo (inverse, (2 Kp / 64, Ni,
// 64)) in the ring's swizzled image (kernels/mlsa.py:tc_plans; the lo
// halves unread unless high); w, a (S+1); work, the scratch of
// mlsa_cascade_tc_workspace's bytes; y (B, N, P).  high: 1 for bf16x3
// (HIGH), 0 for one bf16 pass (DEFAULT).  Enqueues the prologue and two
// launches a stage; returns the first launch error.
extern "C" int mlsa_cascade_tc_chunked_f32(
    const void* x, const void* cre, const void* cim, const void* f_hi,
    const void* f_lo, const void* g_hi, const void* g_lo, const void* w,
    const void* a, void* work, void* y, int B, int N, int P, int Q, int r0,
    int n_blk, int K, int S, int high, void* stream) {
  return wg::launch(x, cre, cim, f_hi, f_lo, g_hi, g_lo, w, a, work, y, B,
                    N, P, Q, r0, n_blk, K, S, high, true, stream);
}

// Every other geometry (the B3 row): as the chunked entry with Q = 1, the
// spectra (B, N, K) in rows of 2K floats.
extern "C" int mlsa_cascade_tc_unchunked_f32(
    const void* x, const void* cre, const void* cim, const void* f_hi,
    const void* f_lo, const void* g_hi, const void* g_lo, const void* w,
    const void* a, void* work, void* y, int B, int N, int P, int r0,
    int n_blk, int K, int S, int high, void* stream) {
  return wg::launch(x, cre, cim, f_hi, f_lo, g_hi, g_lo, w, a, work, y, B,
                    N, P, 1, r0, n_blk, K, S, high, false, stream);
}

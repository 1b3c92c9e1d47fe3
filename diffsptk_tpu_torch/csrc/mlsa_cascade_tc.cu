// The Taylor MLSA cascade at the TPU's reduced precisions, for sm_90a: S
// stages of the DFT-plan form on the tensor cores (bf16 operands, fp32
// accumulators), in two C entries.
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
// (kernels/mlsa.py); the activations (the context rows, then Y) every
// stage.
//
// THE CHUNKED ENTRY (tc_stage_kernel, mma.sync m16n8k16).
// Bound on this card: operations.  Per frame row and stage the plans take
// n_blk P x 2K + 2K x 2P multiply-adds (102,400 at P = 80, M = 199: Q = 3,
// K = 128), 31.5 GFLOP per flagship call (B = 32, N = 240, S = 20) at one
// pass: 0.032 ms at 989 TFLOP/s, three passes at HIGH 0.095 ms.  The bytes
// (x, y and the coefficient spectra once, 24.6 MB at the flagship) take
// 0.007 ms at 3.35 TB/s.
// What the design does about it, first simply:
// - A block owns F = 16 kMT - Q consecutive frames of one batch row (grid:
//   tiles x B), so the forward product's 16 kMT rows (frames n0-Q+1 ..
//   n0+F) are whole mma tiles.  It builds the rows' contexts (im2col, a
//   row = n_blk P consecutive samples) as bf16 hi / lo in shared memory,
//   then 8 warps each take 32 output columns at a time over every row:
//   ldmatrix for A, the plan's B fragments straight from global memory (one
//   coalesced 8-byte load a lane, prefetched a k-step ahead; the plans,
//   0.4 MB a half at the flagship, stay in the 50 MB L2).
// - X goes to shared memory in fp32; the Q-term complex products read the
//   coefficient spectra from global memory (once per stage; they stay in
//   L2 at the flagship, 23.6 MB) and write Y's split over the context rows
//   (dead by then); the inverse product writes V over X.  A block holds
//   67 KB at the flagship at HIGH (50 KB at DEFAULT).
// - One launch per stage; all S are enqueued by one C call, stage s > 1
//   as the programmatic dependent of stage s-1 (Hopper's PDL), the state
//   in two ping-pong buffers, as mlsa_cascade.cu does.
// Measured (chip_smoke.py [precision], H100 80GB HBM3, 700 W), ms per 20
// stages at B = 32, N = 240, P = 80: HIGH 1.155-1.189 (12x the bound),
// DEFAULT 0.685-0.712.
// What it leaves for later: every block re-reads the whole plan each stage
// (118 MB a stage from L2 at the flagship, 288 blocks); at HIGH 110
// registers a thread leave two blocks to an SM, 1.09 waves; wgmma and TMA.
//
// THE UNCHUNKED ENTRY (tc_fwd_kernel, tc_inv_kernel: wgmma), redesigned.
// Bound at [chain48]'s P = 240, M = 199 (nfft 766, K = 384, n_blk = 3,
// r0 = 2; B = 32, N = 240, S = 20): operations, 720 x 768 + 768 x 480
// multiply-adds a frame and stage, 283 GFLOP a call at one pass: 0.2863 ms
// at 989 TFLOP/s, 0.8588 at HIGH.  The stage kernel this entry shared with
// the chunked one (32 rows a block, 256 blocks, one an SM) read a whole
// plan half, 720 x 768 + 768 x 480 bf16 = 1.84 MB (3.69 MB at HIGH), from
// L2 in every block and stage: 472 MB a stage (944 MB at HIGH), 2.5 and
// 4.0 TB/s of plan reads at its 3.83 and 4.73 ms; cuBLAS ran the same
// products in 1.0 and 2.5-3.1 ms.
// What the design does about it:
// - A stage is two tensor-core GEMMs over every frame of every batch row,
//   flattened into one M dimension, in tiles of 128 rows (two consumer
//   warpgroups, wgmma m64) that share each plan tile.  The state lives
//   split (bf16 hi, and lo at HIGH) in a padded layout: r0 zero frames
//   before each batch row and n_blk - 1 - r0 after it (Np = N + n_blk - 1
//   frames a row), each frame P8 = P rounded up to 8 wide (zeros past P),
//   so that frame m's context is the row at m P8 of length n_blk P8 of one
//   view with a 16-byte row stride; the plan's rows match it.
// - tc_fwd_kernel: X = ctx @ Ffwd (K = n_blk P8 rounded up to 64, columns
//   2 Kp, the real and imaginary part of a bin side by side, four
//   consecutive bins a thread); its epilogue applies C in fp32 and writes
//   Y split to a scratch (M x 2 Kp bf16: 11.9 MB, 23.8 MB at HIGH), 16
//   bytes a store.  The coefficients (23.8 MB a stage, from device memory)
//   load into registers, a float4 of each part a row and four bins, under
//   the main loop.
// - tc_inv_kernel: V = Y @ G; a column tile holds the same p range of the
//   lo and hi halves (in groups of 8 columns), a row tile 127 frames and a
//   halo row; its epilogue blends V[n] with V[n+1] through shared memory,
//   weighs, adds a_s out to y (read under the main loop) and writes the
//   next state already split, four p a thread.
// - Operands: the plans sit on the host in the exact image of a ring stage
//   (K-major, 128-byte swizzle), so one bulk copy (TMA, cp.async.bulk on an
//   mbarrier) moves a tile; the rows of A come by cp.async, 16 bytes a
//   thread with zero fill, since the context rows overlap (row stride P8,
//   length n_blk P8: not a tensor map's box) and the inverse tiles start
//   at any row.  A ring of 4 stages (3 at HIGH) keeps two (one) k-steps
//   of loads ahead of the wgmma, one warpgroup-group in flight.
// - Plan traffic: each plan tile is read by 128 rows, not 32: 117 MB a
//   stage at DEFAULT, 240 MB at HIGH (the A rows add 71 and 238 MB).  The
//   coefficients stream through L2 marked evict-first.
// - A geometry whose plans pass 24 MB is refused (no tile): the tiles
//   re-read them from L2.
// - Launches: a prologue kernel splits x into the padded state once, then
//   two a stage, each the programmatic dependent of the one before (its
//   first plan tiles load before it waits).
// Measured (tools/torch_tc_cascade_ab.py, H100 80GB HBM3, 700 W), ms per
// 20 stages at [chain48]'s shapes: HIGH 1.985-2.009 (2.3x the bound),
// DEFAULT 0.893-0.914 (3.1x), against 4.73 and 3.80 before; cuBLAS's same
// products 2.66-3.09 and 0.81-1.07 in the same runs.  What holds it back
// (the build variants MLSA_TC_NO_PDL, MLSA_TC_ABLATE_EPILOGUE and
// MLSA_TC_ABLATE_MMA): the products alone take 0.36 ms at DEFAULT (1.21
// at HIGH) and run as fast without the wgmma, so the main loop is bound by
// its loads from L2 (about 10 and 7 TB/s); the epilogues, whose
// coefficient reads and y, Y and state traffic wait on device memory at
// one block an SM, take the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;               // n8 tiles a warp takes at a time
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may use

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The geometry of one call, fixed on the host.
struct Geo {
  int N, P, Q, r0;
  int nbP;    // n_blk P: a context row's samples
  int Kc1;    // the forward contraction, nbP rounded up to 16
  int K, Kp;  // spectrum bins, and rounded up to 16
  int N2;     // the inverse product's columns, 2P rounded up to 32
  int lda;    // bf16 row stride of the A operands (a multiple of 16, + 8)
  int ldx;    // fp32 row stride of X and V
  int F, tiles;
};

__host__ __device__ inline int smem_bytes(const Geo& g, int rows, bool high) {
  return (high ? 2 : 1) * rows * g.lda * 2 + rows * g.ldx * 4;
}

Geo make_geo(int N, int P, int Q, int r0, int n_blk, int K) {
  Geo g;
  g.N = N;
  g.P = P;
  g.Q = Q;
  g.r0 = r0;
  g.nbP = n_blk * P;
  g.Kc1 = round_up(g.nbP, 16);
  g.K = K;
  g.Kp = round_up(K, 16);
  g.N2 = round_up(2 * P, 32);
  const int widest = g.Kc1 > 2 * g.Kp ? g.Kc1 : 2 * g.Kp;
  g.lda = widest + 8;
  g.ldx = (2 * g.Kp > g.N2 ? 2 * g.Kp : g.N2) + 4;
  g.F = 0;
  g.tiles = 0;
  return g;
}

// Rows of the block's products (16 kMT): 32 where it fits, else 16; 0
// where neither does.
int choose_rows(const Geo& g, bool high) {
  for (int rows = 32; rows >= 16; rows -= 16) {
    if (rows - g.Q >= 1 && smem_bytes(g, rows, high) <= kMaxSmem) {
      return rows;
    }
  }
  return 0;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// v = hi + lo, both bf16, rounded to nearest (lo is v - hi rounded).
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Two neighbouring values of row ``row``, columns ``col``, ``col`` + 1
// (even), into the hi (and, at HIGH, lo) A operands.
template <bool kHigh>
__device__ __forceinline__ void put2(__nv_bfloat16* ah, __nv_bfloat16* al,
                                     int idx, float v0, float v1) {
  __nv_bfloat16 h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  *reinterpret_cast<__nv_bfloat162*>(ah + idx) = __halves2bfloat162(h0, h1);
  if (kHigh) {
    *reinterpret_cast<__nv_bfloat162*>(al + idx) = __halves2bfloat162(l0, l1);
  }
}

template <bool kHigh>
__device__ __forceinline__ void load_b(uint2 (&bh)[kNT], uint2 (&bl)[kNT],
                                       const uint2* __restrict__ Bh,
                                       const uint2* __restrict__ Bl,
                                       size_t base) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    bh[j] = __ldg(Bh + base + 32 * j);
    if (kHigh) bl[j] = __ldg(Bl + base + 32 * j);
  }
}

// One warp's share of out (16 kMT x 8 n_tiles, fp32, row stride ldo) =
// A (16 kMT x 16 ksteps, bf16 hi / lo in shared memory, row stride lda) @ B
// (fragment order: (k-step, n-tile, lane) of 4 bf16, hi / lo): the column
// groups of 32 warp, warp + kWarps, ...
template <bool kHigh, int kMT>
__device__ void warp_gemm(const __nv_bfloat16* Ah, const __nv_bfloat16* Al,
                          int lda, int ksteps, const uint2* __restrict__ Bh,
                          const uint2* __restrict__ Bl, int n_tiles,
                          float* out, int ldo, int warp, int lane) {
  for (int grp = warp; grp * kNT < n_tiles; grp += kWarps) {
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const size_t col0 = static_cast<size_t>(grp) * kNT * 32 + lane;
    const size_t kstride = static_cast<size_t>(n_tiles) * 32;
    uint2 bh[kNT], bl[kNT], nh[kNT], nl[kNT];
    load_b<kHigh>(bh, bl, Bh, Bl, col0);
    const int arow = lane & 15;
    const int acol = (lane >> 4) * 8;
    for (int kt = 0; kt < ksteps; ++kt) {
      if (kt + 1 < ksteps) {
        load_b<kHigh>(nh, nl, Bh, Bl, col0 + (kt + 1) * kstride);
      }
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int off = (16 * i + arow) * lda + 16 * kt + acol;
        ldmatrix_x4(ah[i], Ah + off);
        if (kHigh) ldmatrix_x4(al[i], Al + off);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_bf16(acc[i][j], ah[i], bh[j]);
          if (kHigh) {
            mma_bf16(acc[i][j], ah[i], bl[j]);
            mma_bf16(acc[i][j], al[i], bh[j]);
          }
        }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        bh[j] = nh[j];
        if (kHigh) bl[j] = nl[j];
      }
    }
    const int r = lane >> 2;
    const int cc = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float* o = out + (16 * i + r) * ldo + (grp * kNT + j) * 8 + cc;
        *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][0],
                                                    acc[i][j][1]);
        *reinterpret_cast<float2*>(o + 8 * ldo) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
}

template <bool kHigh, int kMT>
__global__ void __launch_bounds__(kThreads)
tc_stage_kernel(const float* __restrict__ xin, const float* __restrict__ x0,
                float* __restrict__ xout, float* __restrict__ y,
                const float* __restrict__ cre, const float* __restrict__ cim,
                const uint2* __restrict__ f_hi, const uint2* __restrict__ f_lo,
                const uint2* __restrict__ g_hi, const uint2* __restrict__ g_lo,
                const float* __restrict__ w, const float* __restrict__ a,
                Geo g, int S, int s) {
  constexpr int kRows = 16 * kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ah = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* al = ah + kRows * g.lda;
  float* xs = reinterpret_cast<float*>(smem + (kHigh ? 2 : 1) * kRows *
                                                  g.lda * 2);
  const int b = blockIdx.x / g.tiles;
  const int n0 = (blockIdx.x - b * g.tiles) * g.F;
  const int N = g.N, P = g.P, Q = g.Q;
  const long long T = static_cast<long long>(N) * P;
  const float* xb = xin + b * T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Wait for the previous stage (a no-op unless launched as its
  // programmatic dependent).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // 1. The contexts of frames n0-Q+1 .. n0+F as rows of A, split.
  const int half1 = g.Kc1 / 2;
  for (int idx = tid; idx < kRows * half1; idx += kThreads) {
    const int i = idx / half1;
    const int kk = 2 * (idx - i * half1);
    const long long m = n0 - (Q - 1) + i;
    const long long pos = (m - g.r0) * P + kk;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long q = pos + e;
      v[e] = kk + e < g.nbP && q >= 0 && q < T ? xb[q] : 0.f;
    }
    put2<kHigh>(ah, al, i * g.lda + kk, v[0], v[1]);
  }
  __syncthreads();

  // 2. X = contexts @ Ffwd, into shared memory.
  warp_gemm<kHigh, kMT>(ah, al, g.lda, g.Kc1 / 16, f_hi, f_lo, 2 * g.Kp / 8,
                        xs, g.ldx, warp, lane);
  __syncthreads();

  // 3. Y of frames n0 .. n0+F (row f: frame n0+f; frame N takes C[N-1]),
  //    split into the A operand of the inverse product.  Rows past F or
  //    past frame N, and bins past K, are zero.
  const int halfK = g.Kp / 2;
  for (int idx = tid; idx < kRows * halfK; idx += kThreads) {
    const int f = idx / halfK;
    const int k = 2 * (idx - f * halfK);
    const int n = n0 + f;
    float yr[2] = {0.f, 0.f}, yi[2] = {0.f, 0.f};
    if (f <= g.F && n <= N) {
      const int nc = n < N ? n : N - 1;
      const size_t crow = (static_cast<size_t>(b) * N + nc) * Q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k + e >= g.K) break;
        for (int j = 0; j < Q; ++j) {
          const float* xr = xs + (f + Q - 1 - j) * g.ldx;
          const float re = xr[k + e];
          const float im = xr[g.Kp + k + e];
          const size_t ci = (crow + j) * g.K + k + e;
          const float c_re = cre[ci];
          const float c_im = cim[ci];
          yr[e] += re * c_re - im * c_im;
          yi[e] += re * c_im + im * c_re;
        }
      }
    }
    put2<kHigh>(ah, al, f * g.lda + k, yr[0], yr[1]);
    put2<kHigh>(ah, al, f * g.lda + g.Kp + k, yi[0], yi[1]);
  }
  __syncthreads();

  // 4. V = [Yre | Yim] @ [Gre; Gim], over X.
  warp_gemm<kHigh, kMT>(ah, al, g.lda, 2 * g.Kp / 16, g_hi, g_lo, g.N2 / 8,
                        xs, g.ldx, warp, lane);
  __syncthreads();

  // 5. Blend with the next frame, stage weight, Taylor sum.
  const float w_s = w[s];
  const float a_0 = a[0];
  const float a_s = a[s];
  for (int idx = tid; idx < g.F * P; idx += kThreads) {
    const int f = idx / P;
    const int p = idx - f * P;
    const int n = n0 + f;
    if (n >= N) break;
    const float val = (xs[f * g.ldx + p] + xs[(f + 1) * g.ldx + P + p]) * w_s;
    const size_t i = (static_cast<size_t>(b) * N + n) * P + p;
    if (s < S) xout[i] = val;
    const float prev = s == 1 ? a_0 * x0[i] : y[i];
    y[i] = prev + a_s * val;
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <bool kHigh, int kMT>
int set_smem_attribute() {
  static int err = static_cast<int>(
      cudaFuncSetAttribute(tc_stage_kernel<kHigh, kMT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem));
  return err;
}

template <bool kHigh, int kMT>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const float* src,
                   const float* x0, float* dst, float* y, const float* cre,
                   const float* cim, const uint2* fh, const uint2* fl,
                   const uint2* gh, const uint2* gl, const float* w,
                   const float* a, const Geo& g, int S, int s) {
  if (cfg.dynamicSmemBytes > 48 * 1024) {
    const int err = set_smem_attribute<kHigh, kMT>();
    if (err != 0) return static_cast<cudaError_t>(err);
  }
  return cudaLaunchKernelEx(&cfg, tc_stage_kernel<kHigh, kMT>, src, x0, dst,
                            y, cre, cim, fh, fl, gh, gl, w, a, g, S, s);
}

int run_cascade(const void* x, const void* cre, const void* cim,
                const void* f_hi, const void* f_lo, const void* g_hi,
                const void* g_lo, const void* w, const void* a, void* buf,
                void* y, int B, int N, int P, int Q, int r0, int n_blk, int K,
                int S, int high, void* stream) {
  if (B < 1 || N < 1 || P < 1 || Q < 1 || r0 < 0 || n_blk < 1 || K < 1 ||
      S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g = make_geo(N, P, Q, r0, n_blk, K);
  const int rows = choose_rows(g, high != 0);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  g.F = rows - Q;
  g.tiles = (N + g.F - 1) / g.F;
  if (static_cast<long long>(g.tiles) * B > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tiles * B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(g, rows, high != 0);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const float* x0 = static_cast<const float*>(x);
  const float* cr = static_cast<const float*>(cre);
  const float* ci = static_cast<const float*>(cim);
  const uint2* fh = static_cast<const uint2*>(f_hi);
  const uint2* fl = static_cast<const uint2*>(f_lo);
  const uint2* gh = static_cast<const uint2*>(g_hi);
  const uint2* gl = static_cast<const uint2*>(g_lo);
  const float* wf = static_cast<const float*>(w);
  const float* af = static_cast<const float*>(a);
  float* buf0 = static_cast<float*>(buf);
  float* buf1 = buf0 + static_cast<size_t>(B) * N * P;
  float* yf = static_cast<float*>(y);
  const float* src = x0;
  for (int s = 1; s <= S; ++s) {
    float* dst = s % 2 ? buf1 : buf0;
    cfg.attrs = s > 1 ? &attr : nullptr;
    cfg.numAttrs = s > 1 ? 1 : 0;
    cudaError_t err;
    if (high) {
      err = rows == 32 ? launch<true, 2>(cfg, src, x0, dst, yf, cr, ci, fh,
                                         fl, gh, gl, wf, af, g, S, s)
                       : launch<true, 1>(cfg, src, x0, dst, yf, cr, ci, fh,
                                         fl, gh, gl, wf, af, g, S, s);
    } else {
      err = rows == 32 ? launch<false, 2>(cfg, src, x0, dst, yf, cr, ci, fh,
                                          fl, gh, gl, wf, af, g, S, s)
                       : launch<false, 1>(cfg, src, x0, dst, yf, cr, ci, fh,
                                          fl, gh, gl, wf, af, g, S, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// Blocks of one instance that fit on an SM at ``bytes`` of shared memory
// (0 where the query fails).
template <bool kHigh, int kMT>
int blocks_per_sm(int bytes) {
  if (bytes > 48 * 1024 && set_smem_attribute<kHigh, kMT>() != 0) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tc_stage_kernel<kHigh, kMT>, kThreads, bytes) != cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace

// The tile of a geometry at one arm: frames per block, rows of its
// products and the blocks that fit on one SM through the pointers; returns
// its shared memory in bytes, or -1 where no tile fits (the geometry is
// refused).
extern "C" int mlsa_cascade_tc_tile(int P, int Q, int n_blk, int K, int high,
                                    int* frames, int* rows, int* per_sm) {
  if (P < 1 || Q < 1 || n_blk < 1 || K < 1) return -1;
  const Geo g = make_geo(1, P, Q, 0, n_blk, K);
  const int r = choose_rows(g, high != 0);
  *frames = r ? r - Q : 0;
  *rows = r;
  if (!r) return -1;
  const int bytes = smem_bytes(g, r, high != 0);
  *per_sm = high ? (r == 32 ? blocks_per_sm<true, 2>(bytes)
                            : blocks_per_sm<true, 1>(bytes))
                 : (r == 32 ? blocks_per_sm<false, 2>(bytes)
                            : blocks_per_sm<false, 1>(bytes));
  return bytes;
}

// The tap-chunked geometry (the B2 row): x (B, N, P) float32; the
// coefficient spectra cre, cim (B, N, Q, K) float32; the plans f_hi, f_lo
// (forward) and g_hi, g_lo (inverse) in fragment order (kernels/mlsa.py:
// tc_plans; f_lo and g_lo unread unless high); the stage weights w (S+1)
// and Taylor coefficients a (S+1); buf (2, B, N, P) scratch; y (B, N, P).
// high: 1 for bf16x3 (HIGH), 0 for one bf16 pass (DEFAULT).  Enqueues S
// launches; returns the first launch error.
extern "C" int mlsa_cascade_tc_chunked_f32(
    const void* x, const void* cre, const void* cim, const void* f_hi,
    const void* f_lo, const void* g_hi, const void* g_lo, const void* w,
    const void* a, void* buf, void* y, int B, int N, int P, int Q, int r0,
    int n_blk, int K, int S, int high, void* stream) {
  return run_cascade(x, cre, cim, f_hi, f_lo, g_hi, g_lo, w, a, buf, y, B, N,
                     P, Q, r0, n_blk, K, S, high, stream);
}

// ---------------------------------------------------------------------------
// The unchunked entry (the B3 row): two warpgroup GEMMs a stage.  Inside
// an unnamed namespace, as the rest: a static local of a template function
// with external linkage would be one object across every variant library
// of this source loaded into a process.

namespace {
namespace wg {

constexpr int kBM = 128;       // rows of a tile: two consumer warpgroups
constexpr int kBK = 64;        // K of a ring stage: one 128-byte bf16 row
constexpr int kThreads = 256;
constexpr int kTileA = kBM * 2 * kBK;          // bytes of an A tile
constexpr long long kPlanBudget = 24LL << 20;  // bytes of plans, at most

// Columns of the forward and inverse tiles and ring stages at each arm.
template <bool kHigh>
struct Tiles;
template <>
struct Tiles<false> {
  static constexpr int kFwdN = 192, kInvN = 240, kFwdStages = 4,
                       kInvStages = 4;
};
template <>
struct Tiles<true> {
  static constexpr int kFwdN = 128, kInvN = 128, kFwdStages = 3,
                       kInvStages = 3;
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

// The layout of one geometry at one arm, fixed on the host
// (kernels/mlsa.py:tc_unchunked_layout computes the same).
struct Layout {
  int P, P8, n_blk, K, Kp;
  int kf, Kf;        // forward contraction n_blk P8, and rounded up to kBK
  int Nf;            // forward columns: 2 Kp rounded up to the tile
  int bn_f, bn_i;    // the forward and inverse tiles' columns
  int w, n_ctile;    // frame columns a tile of the inverse, and its tiles
  int Ni;            // inverse columns: n_ctile bn_i
};

Layout make_layout(int P, int n_blk, int K, bool high) {
  Layout L;
  L.P = P;
  L.P8 = round_up(P, 8);
  L.n_blk = n_blk;
  L.K = K;
  L.Kp = round_up(K, 32);
  L.kf = n_blk * L.P8;
  L.Kf = round_up(L.kf, kBK);
  L.bn_f = high ? Tiles<true>::kFwdN : Tiles<false>::kFwdN;
  L.bn_i = high ? Tiles<true>::kInvN : Tiles<false>::kInvN;
  L.Nf = round_up(2 * L.Kp, L.bn_f);
  L.w = L.bn_i / 2;
  L.n_ctile = (P + L.w - 1) / L.w;
  L.Ni = L.n_ctile * L.bn_i;
  return L;
}

long long plan_bytes(const Layout& L, bool high) {
  return (static_cast<long long>(L.Nf) * L.Kf +
          static_cast<long long>(L.Ni) * 2 * L.Kp) * 2 * (high ? 2 : 1);
}

// The scratch of one call: two padded states (Np rows of P8 a batch row,
// n_blk frames of zeros after the last) and Y, each hi (and lo at HIGH),
// each part 1 KB aligned.
struct Work {
  long long state, ys;   // elements of a state part and of a Y part
  long long bytes;
};

Work make_work(int B, int N, const Layout& L, bool high) {
  const long long Np = N + L.n_blk - 1;
  Work k;
  k.state = ((static_cast<long long>(B) * Np + L.n_blk) * L.P8 + 511) /
            512 * 512;
  k.ys = (static_cast<long long>(B) * Np * 2 * L.Kp + 511) / 512 * 512;
  k.bytes = (2 * k.state + k.ys) * 2 * (high ? 2 : 1);
  return k;
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
  static_assert(kBN == 128 || kBN == 192 || kBN == 240, "tile width");
  if constexpr (kBN == 128) {
    wgmma_n128(d, a, b);
  } else if constexpr (kBN == 192) {
    wgmma_n192(d, a, b);
  } else {
    wgmma_n240(d, a, b);
  }
}

// The A rows of k-block kb into a ring stage, 16 bytes a thread, with the
// 128-byte swizzle (chunk c of row r at chunk c ^ (r & 7)); rows past
// ``rows`` and columns past ``kvalid`` read as zeros.
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
    const bool ok = row < rows && k < kvalid;
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

// Stage s, first GEMM: X = ctx @ Ffwd over one tile of 128 rows (frames
// of the flattened padded grid) by kFwdN columns (bins' re, im side by
// side), then Y = X * C[b, min(m, N-1)] for frames m <= N (zero
// otherwise), split, into the scratch y (M x 2 Kp, bin k's re and im at
// 2k, 2k + 1).  Grid: row tiles x column tiles, the column tile fastest.
template <bool kHigh>
__global__ void __launch_bounds__(kThreads, 1)
tc_fwd_kernel(const __nv_bfloat16* __restrict__ st_hi,
              const __nv_bfloat16* __restrict__ st_lo,
              const __nv_bfloat16* __restrict__ f_hi,
              const __nv_bfloat16* __restrict__ f_lo,
              const float* __restrict__ cre, const float* __restrict__ cim,
              __nv_bfloat16* __restrict__ y_hi,
              __nv_bfloat16* __restrict__ y_lo, Layout L, int N, int Np,
              int M) {
  constexpr int kBN = Tiles<kHigh>::kFwdN;
  constexpr int kStages = Tiles<kHigh>::kFwdStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = smem_u32(wg_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const int n_tiles = L.Nf / kBN;
  const int tn = blockIdx.x % n_tiles;
  const int row0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = tn * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = 2 * L.Kp;

  // Column c = 32 g + 8 jj + 2 t + e of the plan holds part e (re, im) of
  // bin 16 g + 4 t + jj, so that a thread (t = lane & 3) holds four
  // consecutive bins of each row: it loads their coefficients as one
  // float4 (where K % 4 == 0) and stores their Y as 16 bytes.  The
  // coefficients of its two rows load into registers once the ring's
  // first loads are issued (the spectra are inputs of the call, ready
  // before the first stage): their latency hides under the main loop.
  // They stream through L2 marked evict-first (23.8 MB a stage at
  // [chain48]'s shapes, read once a stage), so that they push less of Y,
  // the state and y out of it.  A row of the spectra is 2K floats: re at
  // k, im at K + k.
  constexpr int kQ = kBN / 32;
  const int t4 = 4 * (lane & 3);
  const bool vec = L.K % 4 == 0;
  int rows[2];
  bool live[2];
  float c_re[2][kQ][4], c_im[2][kQ][4];
  auto load_c = [&] {
    const uint64_t policy = evict_first();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = row0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 +
                (lane >> 2) + 8 * h;
      const int b = rows[h] < M ? rows[h] / Np : 0;
      const int m = rows[h] - b * Np;
      live[h] = rows[h] < M && m <= N;
      const size_t crow =
          (static_cast<size_t>(b) * N + (m < N ? m : N - 1)) * 2 * L.K;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int k0 = n0 / 2 + 16 * q + t4;
        if (vec && live[h] && k0 < L.K) {
          ld_stream4(c_re[h][q], cre + crow + k0, policy);
          ld_stream4(c_im[h][q], cim + crow + k0, policy);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const bool ok = live[h] && k0 + jj < L.K;
            c_re[h][q][jj] = ok ? __ldg(cre + crow + k0 + jj) : 0.f;
            c_im[h][q][jj] = ok ? __ldg(cim + crow + k0 + jj) : 0.f;
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

// Stage s, second GEMM: V = Y @ G over a tile of 128 rows (127 frames and
// a halo row) by kInvN columns (groups of 8: lo (1 - lam) of p0 .. p0 + 7,
// hi lam of the same p, ...).  The epilogue puts V in shared memory (over
// the ring) and, per frame m < N and p < P: out = (V[n, lo p] + V[n+1,
// hi p]) w_s, y += a_s out (y = a_0 x0 + a_1 out at s = 1), the next
// state (s < S) split into the padded layout (zeros past P).
template <bool kHigh>
__global__ void __launch_bounds__(kThreads, 1)
tc_inv_kernel(const __nv_bfloat16* __restrict__ y_hi,
              const __nv_bfloat16* __restrict__ y_lo,
              const __nv_bfloat16* __restrict__ g_hi,
              const __nv_bfloat16* __restrict__ g_lo,
              const float* __restrict__ x0, float* __restrict__ y,
              __nv_bfloat16* __restrict__ nx_hi,
              __nv_bfloat16* __restrict__ nx_lo,
              const float* __restrict__ w, const float* __restrict__ a,
              Layout L, int N, int Np, int M, int r0, int S, int s) {
  constexpr int kBN = Tiles<kHigh>::kInvN;
  constexpr int kStages = Tiles<kHigh>::kInvStages;
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
    m = row - b * Np;
    return item < (kBM - 1) * kG && row < M && m < N && tn * kW + pl < L.P;
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
      const size_t o = (static_cast<size_t>(b) * Np + r0 + m) * L.P8 + p;
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
               int Np, int r0, long long total) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += 256LL * gridDim.x) {
    const long long frame = i / P8;
    const int p = static_cast<int>(i - frame * P8);
    const long long b = frame / Np;
    const int f = static_cast<int>(frame - b * Np) - r0;
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

template <bool kHigh>
int fwd_smem() {
  return Ring<kHigh, Tiles<kHigh>::kFwdN, Tiles<kHigh>::kFwdStages>::kBytes;
}

template <bool kHigh>
int inv_smem() {
  return Ring<kHigh, Tiles<kHigh>::kInvN, Tiles<kHigh>::kInvStages>::kBytes;
}

template <bool kHigh>
int set_attributes() {
  static int err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        tc_fwd_kernel<kHigh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem<kHigh>());
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(tc_inv_kernel<kHigh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               inv_smem<kHigh>());
    }
    return static_cast<int>(e);
  }();
  return err;
}

// Whether the entry takes a geometry: r0 zero frames before a row and
// n_blk - 1 - r0 >= 0 after it, frame N's context ending in the next
// row's pad, the plans within kPlanBudget, indices within int.
bool takes(const Layout& L, int B, int N, int r0, bool high) {
  const long long Np = N + L.n_blk - 1;
  return r0 >= 1 && r0 <= L.n_blk - 1 && plan_bytes(L, high) <= kPlanBudget &&
         (B * Np + L.n_blk) * L.P8 < (1LL << 31) &&
         B * Np * 2 * L.Kp < (1LL << 31);
}

template <bool kHigh>
int run(const float* x, const float* cre, const float* cim,
        const __nv_bfloat16* fh, const __nv_bfloat16* fl,
        const __nv_bfloat16* gh, const __nv_bfloat16* gl, const float* w,
        const float* a, unsigned char* work, float* y, int B, int N, int P,
        int r0, int n_blk, int K, int S, cudaStream_t stream) {
  const Layout L = make_layout(P, n_blk, K, kHigh);
  if (!takes(L, B, N, r0, kHigh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err0 = set_attributes<kHigh>();
  if (err0 != 0) return err0;
  const int Np = N + n_blk - 1;
  const int M = B * Np;
  const Work k = make_work(B, N, L, kHigh);
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
                                       st[1][1], B, N, P, L.P8, Np, r0,
                                       total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t fwd = {};
  fwd.gridDim = dim3(((M + kBM - 1) / kBM) * (L.Nf / L.bn_f));
  fwd.blockDim = dim3(kThreads);
  fwd.dynamicSmemBytes = fwd_smem<kHigh>();
  fwd.stream = stream;
#ifndef MLSA_TC_NO_PDL
  fwd.attrs = &attr;
  fwd.numAttrs = 1;
#endif
  cudaLaunchConfig_t inv = fwd;
  inv.gridDim = dim3(((M + kBM - 2) / (kBM - 1)) * L.n_ctile);
  inv.dynamicSmemBytes = inv_smem<kHigh>();
  for (int s = 1; s <= S; ++s) {
    __nv_bfloat16* const* src = st[(s - 1) % 2];
    __nv_bfloat16* const* dst = st[s % 2];
    err = cudaLaunchKernelEx(&fwd, tc_fwd_kernel<kHigh>, src[0], src[1], fh,
                             fl, cre, cim, yh, yl, L, N, Np, M);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&inv, tc_inv_kernel<kHigh>, yh, yl, gh, gl, x,
                             y, dst[0], dst[1], w, a, L, N, Np, M, r0, S, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kHigh>
int per_sm(const void* kernel, int bytes) {
  if (set_attributes<kHigh>() != 0) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    bytes) != cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace wg
}  // namespace

// The unchunked entry's layout of a geometry at one arm, into out[0..13]:
// P8, kf, Kf, Kp, Nf, forward tile columns, inverse tile columns, w,
// column tiles of the inverse, Ni, the forward's and the inverse's shared
// memory bytes, ring stages of each.  Returns the plans' bytes, or -1
// where the entry refuses the geometry (plans past 24 MB, or r0 outside
// 1 .. n_blk - 1).
extern "C" long long mlsa_cascade_tc_unchunked_layout(int P, int r0,
                                                      int n_blk, int K,
                                                      int high, int* out) {
  if (P < 1 || n_blk < 1 || K < 1) return -1;
  const wg::Layout L = wg::make_layout(P, n_blk, K, high != 0);
  const int vals[14] = {
      L.P8, L.kf, L.Kf, L.Kp, L.Nf, L.bn_f, L.bn_i, L.w, L.n_ctile, L.Ni,
      high ? wg::fwd_smem<true>() : wg::fwd_smem<false>(),
      high ? wg::inv_smem<true>() : wg::inv_smem<false>(),
      high ? wg::Tiles<true>::kFwdStages : wg::Tiles<false>::kFwdStages,
      high ? wg::Tiles<true>::kInvStages : wg::Tiles<false>::kInvStages};
  for (int i = 0; i < 14; ++i) out[i] = vals[i];
  if (!wg::takes(L, 1, 1, r0, high != 0)) return -1;
  return wg::plan_bytes(L, high != 0);
}

// Blocks of the forward and the inverse kernel that fit on one SM at an
// arm (0 where the query fails), into out[0..1].
extern "C" int mlsa_cascade_tc_unchunked_occupancy(int high, int* out) {
  if (high) {
    out[0] = wg::per_sm<true>(
        reinterpret_cast<const void*>(wg::tc_fwd_kernel<true>),
        wg::fwd_smem<true>());
    out[1] = wg::per_sm<true>(
        reinterpret_cast<const void*>(wg::tc_inv_kernel<true>),
        wg::inv_smem<true>());
  } else {
    out[0] = wg::per_sm<false>(
        reinterpret_cast<const void*>(wg::tc_fwd_kernel<false>),
        wg::fwd_smem<false>());
    out[1] = wg::per_sm<false>(
        reinterpret_cast<const void*>(wg::tc_inv_kernel<false>),
        wg::inv_smem<false>());
  }
  return 0;
}

// Bytes of the scratch a call at (B, N) takes (the wrapper allocates it),
// or -1 where the entry refuses the geometry.
extern "C" long long mlsa_cascade_tc_unchunked_workspace(int B, int N, int P,
                                                         int r0, int n_blk,
                                                         int K, int high) {
  if (B < 1 || N < 1 || P < 1 || n_blk < 1 || K < 1) return -1;
  const wg::Layout L = wg::make_layout(P, n_blk, K, high != 0);
  if (!wg::takes(L, B, N, r0, high != 0)) return -1;
  return wg::make_work(B, N, L, high != 0).bytes;
}

// Every other geometry (the B3 row): x (B, N, P) float32; the coefficient
// spectra's real and imaginary parts cre, cim, each (B, N, K) float32 in
// rows of 2K floats (cim = cre + K: one (B, N, 2K) array, as
// kernels/mlsa.py:coef_spectrum_cat makes it); the plans f_hi, f_lo
// (forward, (Kf / 64, Nf, 64)) and g_hi, g_lo (inverse, (2 Kp / 64, Ni,
// 64)) in the ring's swizzled image (kernels/mlsa.py:tc_unchunked_plans;
// the lo halves unread unless high); w, a (S+1); work, the scratch of
// mlsa_cascade_tc_unchunked_workspace's bytes; y (B, N, P).  Enqueues the
// prologue and two launches a stage; returns the first launch error.
extern "C" int mlsa_cascade_tc_unchunked_f32(
    const void* x, const void* cre, const void* cim, const void* f_hi,
    const void* f_lo, const void* g_hi, const void* g_lo, const void* w,
    const void* a, void* work, void* y, int B, int N, int P, int r0,
    int n_blk, int K, int S, int high, void* stream) {
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
  return high ? wg::run<true>(xf, cr, ci, fh, fl, gh, gl, wf, af, wk, yf, B,
                              N, P, r0, n_blk, K, S, st)
              : wg::run<false>(xf, cr, ci, fh, fl, gh, gl, wf, af, wk, yf, B,
                               N, P, r0, n_blk, K, S, st);
}

// The Taylor MLSA cascade at the TPU's reduced precisions, for sm_90a: S
// stages of the DFT-plan form on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators), one launch each, in two C entries that
// share one stage kernel.
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
// (kernels/mlsa.py:tc_plans), into the mma's B-fragment order; the
// activations (the context rows, then Y) are split here every stage.
//
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
//   0.4 MB at the flagship, 2.3 MB at P = 240, stay in the 50 MB L2).
// - X goes to shared memory in fp32; the Q-term complex products read the
//   coefficient spectra from global memory (once per stage; they stay in
//   L2 at the flagship, 23.6 MB) and write Y's split over the context rows
//   (dead by then); the inverse product writes V over X.  A block holds
//   67 KB at the flagship at HIGH (50 KB at DEFAULT), 198 KB at P = 240.
// - One launch per stage; all S are enqueued by one C call, stage s > 1
//   as the programmatic dependent of stage s-1 (Hopper's PDL), the state
//   in two ping-pong buffers, as mlsa_cascade.cu does.
// Measured (chip_smoke.py [precision], H100 80GB HBM3, 700 W), ms per 20
// stages at B = 32, N = 240: P = 80 HIGH 1.155-1.177 (12x the bound),
// DEFAULT 0.685-0.712; P = 240 HIGH 4.737-4.745, DEFAULT 3.826-3.834.
// What it leaves for later: every block re-reads the whole plan each stage
// (118 MB a stage from L2 at the flagship, 288 blocks); at HIGH 110
// registers a thread leave two blocks to an SM, 1.09 waves at the
// flagship, and at P = 240 one (198 KB), 1.94 waves; wgmma and TMA.

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

// Every other geometry (the B3 row): the same kernel at Q = 1.
extern "C" int mlsa_cascade_tc_unchunked_f32(
    const void* x, const void* cre, const void* cim, const void* f_hi,
    const void* f_lo, const void* g_hi, const void* g_lo, const void* w,
    const void* a, void* buf, void* y, int B, int N, int P, int r0,
    int n_blk, int K, int S, int high, void* stream) {
  return run_cascade(x, cre, cim, f_hi, f_lo, g_hi, g_lo, w, a, buf, y, B, N,
                     P, 1, r0, n_blk, K, S, high, stream);
}

// The Taylor MLSA cascade, for sm_90a: S stages of a direct-form fp32 FIR,
// one launch each, in two C entries that share one stage kernel.
//
// Replaces, through mlsa_cascade_stage_f32 (the tap-chunked geometry, B2):
// diffsptk_tpu/kernels/pallas_mlsa.py:260 _chunked_kernel_b3 and :330
// _chunked_kernel (launched at :449); through
// mlsa_cascade_unchunked_stage_f32 (every other geometry, B3):
// pallas_mlsa.py:119 _cascade_kernel_b3 and :175 _cascade_kernel
// (launched at :498).  The TPU kernels run each stage as DFT-plan matmuls,
// the only form of an FIR that the MXU runs well; this kernel computes the
// FIR itself.
//
// Computes stage s of kernels/mlsa_cascade.py:taylor_cascade_folded (and
// of its direct twin, taylor_cascade_direct) on the (B, N, P) frame grid:
//   lo[t] = sum_m c_n[m] x[t+z-m],  hi[t] = sum_m c_{n+1}[m] x[t+z-m]
//   out[t] = (1 - lam) lo[t] + lam hi[t],  lam = p / P,  t = n P + p,
// m = 0..M, z = advance, x zero outside its batch row, c_N = c_{N-1}; then
//   xout = w_s out;  y = (s == 1 ? a_0 x : y) + a_s xout.
// Two sums blended after the fact, as the twin blends its lo and hi plan
// columns, rather than one sum over blended taps: the kernel reads c as it
// is, with no per-sample filter.  (lo, hi) rather than (lo, hi - lo):
// F+1 coefficient rows in shared memory, not 2F, and two independent
// roundings averaged by the blend rather than one.
//
// Bound on this card: operations.  The least work of a stage is that FIR
// as an FFT convolution: one real transform of the frame's P+M inputs and
// two inverse ones, two complex products and the blend, about 19 kflop per
// frame at P = 80, M = 199 (chip_smoke.cascade_bound; 0.044 ms per
// 20-stage call at the flagship, B = 32, N = 240, at 67 TFLOP/s).
// Work done here, directly: 2 sums x (M+1) taps x 2 flops per output,
// 64 kflop per frame and stage at P = 80, M = 199 (9.8 GFLOP per flagship
// call, 0.147 ms at the fp32 peak) and 192 kflop at P = 240 (29.5 GFLOP
// per 20-stage call at B = 32, N = 240); taps are padded to a multiple of
// 12 with zeros (204 at M = 199).  The DFT-plan kernel this replaces did
// 208 kflop per frame at P = 80 and 1.85 Mflop at P = 240.
// What the design does about the bound: it does 3.4x the FFT count in
// plain fp32 FMAs (no transform, no tensor-core passes, full fp32
// accuracy) and keeps the FMA pipe fed:
// - A block owns F consecutive frames of one batch row (grid: tiles x B).
//   It copies coefficient rows n0..n0+F (zero-padded to Mp taps) and the
//   stage input over [n0 P + z - (Mp-1), (n0+F) P + z + R) into shared
//   memory with cp.async, zero outside the row: the rows 16 bytes at a
//   time where M+1 is a multiple of 4, the input 4 bytes at a time (its
//   segments start at any alignment).
// - A thread item is R = 8 consecutive outputs of one frame (masked past
//   P), with 2R accumulators.  Taps advance 4 at a time: one float4 of
//   c_n and one of c_{n+1} (broadcast to the lanes of a frame) and one
//   float4 of x feed 8R = 64 FMAs.  The x values live in a 12-register
//   window that slides 4 samples per step; three steps (12 taps) are
//   unrolled so that the window rotates through fixed registers with no
//   moves.  Where P % 4 != 0 the x float4 is 4 scalar loads.
// - F is picked on the host (choose_tile): at most 256 threads a block, so
//   that 4 blocks share an SM (P = 80: F = 16, 160 threads; P = 240:
//   F = 8, 240 of 256 threads busy), one item per thread, as few idle
//   lanes as possible.  F shrinks until the tile fits, down to one frame;
//   only a geometry whose one-frame tile exceeds 227 KB is refused.
// - One launch per stage; all S are enqueued by one C call.  Stage s+1 of
//   frame n reads stage s of frames n-1 .. n+1 (and further for long
//   filters), so blocks cannot run ahead; the state ping-pongs between two
//   buffers that stay in the 50 MB L2 (2.4 MB at the flagship, 7.4 MB at
//   48 kHz).  Stage s+1 is launched as the programmatic dependent of
//   stage s (Hopper's PDL): its blocks may start once every block of s has
//   stored its outputs, copy their coefficient rows, then wait
//   (griddepcontrol.wait) for all of s.
// - Measured with tools/torch_cascade_ablation.py (H100 80GB HBM3, 700 W),
//   ms per 20 stages at P = 80 / P = 240.  One run: trigger after the tap
//   loop 0.343 / 0.869, before it 0.404 / 0.862 (into a one-wave grid the
//   next stage's blocks crowd the SMs with free slots), chosen by grid
//   size 0.341 / 0.863, no PDL 0.375 / 0.898, coefficient rows copied 4
//   bytes at a time 0.406 / 0.886, no tap loop 0.142 / 0.266.  Another,
//   where to trigger (median of 4 turns):
//   at the end of the kernel 0.343 / 0.856, after each item's tap loop
//   0.353 / 0.880, after its stores 0.353 / 0.887, nowhere (implicit at
//   exit) 0.352 / 0.890.
//
// -DMLSA_ABLATE_TAPS (tools/torch_cascade_ablation.py) skips the tap loop:
// wrong values; only the copies, stores and launches remain.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;                // outputs per thread item
constexpr int kW = kR + 4;           // x window, in registers
constexpr int kU = kW / 4;           // 4-tap steps per unrolled unit
constexpr int kTapUnit = 4 * kU;     // taps per unit; taps pad to this
constexpr int kThreads = 256;        // most threads a block
constexpr int kMaxFrames = 64;
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may use
// Four blocks fit on one SM (228 KB, 1 KB reserved per block) up to this.
constexpr int kFourPerSm = 228 * 1024 / 4 - 1024;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline int padded_taps(int M) {
  return round_up(M + 1, kTapUnit);
}

// Shared memory of a tile of F frames, in floats: F+1 coefficient rows of
// Mp taps, then the x segment.
__host__ __device__ inline int coef_floats(int F, int Mp) {
  return (F + 1) * Mp;
}
__host__ __device__ inline int x_floats(int F, int P, int Mp) {
  return F * P + Mp + kR;
}
__host__ __device__ inline int tile_bytes(int F, int P, int Mp) {
  return (coef_floats(F, Mp) + x_floats(F, P, Mp)) *
         static_cast<int>(sizeof(float));
}

struct Tile {
  int frames, threads, bytes;
};

// The tile of a geometry: one item per thread where a frame has at most
// kThreads items, four blocks to an SM where more than one frame fits,
// the fewest idle lanes, then the most frames; {0, 0, 0} where one frame
// does not fit.
Tile choose_tile(int P, int M) {
  const int G = (P + kR - 1) / kR;
  const int Mp = padded_taps(M);
  const int f_max = G >= kThreads ? 1 : kThreads / G;
  Tile best{0, 0, 0};
  double best_use = -1.0;
  for (int F = 1; F <= f_max && F <= kMaxFrames; ++F) {
    const int bytes = tile_bytes(F, P, Mp);
    if (bytes > (F == 1 ? kMaxSmem : kFourPerSm)) break;
    const int items = F * G;
    const int threads =
        items >= kThreads ? kThreads : round_up(items, 32);
    const int rounds = (items + threads - 1) / threads;
    const double use = static_cast<double>(items) / (rounds * threads);
    if (use >= best_use - 1e-9) {
      best = Tile{F, threads, bytes};
      best_use = use > best_use ? use : best_use;
    }
  }
  return best;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p) {
  if (kVec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float elem(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// kVec: P % 4 == 0, so every item's x window and outputs are
// float4-aligned.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
stage_kernel(const float* __restrict__ xin, const float* __restrict__ x0,
             float* __restrict__ xout, float* __restrict__ y,
             const float* __restrict__ c, const float* __restrict__ w,
             const float* __restrict__ a,
             int N, int P, int M, int z, int F, int tiles, int S, int s) {
  extern __shared__ __align__(16) float smem[];
  const int Mp = padded_taps(M);
  const int G = (P + kR - 1) / kR;
  const int XL = x_floats(F, P, Mp);
  const int CL = coef_floats(F, Mp);
  float* cs = smem;       // (F+1, Mp): rows n0 .. n0+F, clamped to N-1
  float* xs = smem + CL;  // x over [n0 P + z - (Mp-1), ...)
  const int b = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - b * tiles) * F;
  const long long T = static_cast<long long>(N) * P;
  const float* xb = xin + b * T;
  const float* cb = c + static_cast<size_t>(b) * N * (M + 1);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // 1. The coefficient rows (clamped to N-1, zero past tap M): they do not
  //    depend on the previous stage, so they load while it finishes.
  if ((M + 1) % 4 == 0) {  // rows 16-byte aligned
    const int q4 = Mp / 4;
    for (int idx = tid; idx < (F + 1) * q4; idx += nt) {
      const int r = idx / q4;
      const int m = 4 * (idx - r * q4);
      const int n = n0 + r < N ? n0 + r : N - 1;
      float* dst = cs + r * Mp + m;
      if (m <= M) {
        cp_async16(dst, cb + static_cast<size_t>(n) * (M + 1) + m);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int idx = tid; idx < CL; idx += nt) {
      const int r = idx / Mp;
      const int m = idx - r * Mp;
      const int n = n0 + r < N ? n0 + r : N - 1;
      if (m <= M) {
        cp_async4(cs + idx, cb + static_cast<size_t>(n) * (M + 1) + m);
      } else {
        cs[idx] = 0.f;
      }
    }
  }
  // 2. Wait for the previous stage (a no-op unless launched as its
  //    programmatic dependent), then load its output, zero outside the row.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long g0 = static_cast<long long>(n0) * P + z - (Mp - 1);
  for (int j = tid; j < XL; j += nt) {
    const long long g = g0 + j;
    if (g >= 0 && g < T) {
      cp_async4(xs + j, xb + g);
    } else {
      xs[j] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const float w_s = w[s];
  const float a_0 = a[0];
  const float a_s = a[s];
  for (int item = tid; item < F * G; item += nt) {
    const int f = item / G;
    const int p0 = (item - f * G) * kR;
    const int n = n0 + f;
    if (n >= N) break;  // items run in frame order
    const int t0 = f * P + p0;
    float lo[kR], hi[kR];
#pragma unroll
    for (int o = 0; o < kR; ++o) lo[o] = hi[o] = 0.f;

#ifndef MLSA_ABLATE_TAPS
    // 3. The taps.  Output o, tap m reads xs[t0 + Mp - 1 - m + o].  At
    // 4-tap step g the window L[i] = xs[t0 + Mp - 4 - 4g + i], i < kW,
    // sits in ring[] at rotation (-4g) mod kW; step g loads L[0..3] and
    // uses L[3-k+o].
    float ring[kW];
#pragma unroll
    for (int q = 1; q < kU; ++q) {
      const float4 v = load4<kVec>(xs + t0 + Mp + 4 * (q - 1));
      ring[4 * q] = v.x;
      ring[4 * q + 1] = v.y;
      ring[4 * q + 2] = v.z;
      ring[4 * q + 3] = v.w;
    }
    const float* xg = xs + t0 + Mp - 4;
    const float* ca = cs + f * Mp;
    const float* cn = ca + Mp;
    for (int m0 = 0; m0 < Mp; m0 += kTapUnit) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int rot = (kW - 4 * u) % kW;
        const float4 v = load4<kVec>(xg - m0 - 4 * u);
        ring[rot] = v.x;
        ring[rot + 1] = v.y;
        ring[rot + 2] = v.z;
        ring[rot + 3] = v.w;
        const float4 cv = *reinterpret_cast<const float4*>(ca + m0 + 4 * u);
        const float4 dv = *reinterpret_cast<const float4*>(cn + m0 + 4 * u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wc = elem(cv, k);
          const float wd = elem(dv, k);
#pragma unroll
          for (int o = 0; o < kR; ++o) {
            const float xv = ring[(rot + 3 - k + o) % kW];
            lo[o] = fmaf(wc, xv, lo[o]);
            hi[o] = fmaf(wd, xv, hi[o]);
          }
        }
      }
    }
#endif

    // 4. Blend, stage weight, Taylor sum.
    float val[kR];
#pragma unroll
    for (int o = 0; o < kR; ++o) {
      const float lam = static_cast<float>(p0 + o) / static_cast<float>(P);
      val[o] = ((1.f - lam) * lo[o] + lam * hi[o]) * w_s;
    }
    const size_t row = (static_cast<size_t>(b) * N + n) * P + p0;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kR / 4; ++q) {
        if (p0 + 4 * q >= P) break;
        const size_t i = row + 4 * q;
        const float4 v = make_float4(val[4 * q], val[4 * q + 1],
                                     val[4 * q + 2], val[4 * q + 3]);
        if (s < S) *reinterpret_cast<float4*>(xout + i) = v;
        float4 prev;
        if (s == 1) {
          prev = *reinterpret_cast<const float4*>(x0 + i);
          prev = make_float4(a_0 * prev.x, a_0 * prev.y, a_0 * prev.z,
                             a_0 * prev.w);
        } else {
          prev = *reinterpret_cast<const float4*>(y + i);
        }
        *reinterpret_cast<float4*>(y + i) =
            make_float4(prev.x + a_s * v.x, prev.y + a_s * v.y,
                        prev.z + a_s * v.z, prev.w + a_s * v.w);
      }
    } else {
#pragma unroll
      for (int o = 0; o < kR; ++o) {
        if (p0 + o >= P) break;
        const size_t i = row + o;
        if (s < S) xout[i] = val[o];
        const float prev = s == 1 ? a_0 * x0[i] : y[i];
        y[i] = prev + a_s * val[o];
      }
    }
  }
  // The next stage may launch and load its coefficients now.  Signalled here,
  // not left to the block's exit and not inside the item loop: both of
  // those measured 3 % slower (tools/torch_cascade_ablation.py).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <bool kVec>
int set_smem_attribute() {
  // Above 48 KB dynamic shared memory needs the opt-in attribute, set
  // once per instance to the most a block may use.
  static int err = static_cast<int>(
      cudaFuncSetAttribute(stage_kernel<kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem));
  return err;
}

// Enqueue stages 1..S on ``stream``: stage s reads x (s = 1) or the half
// of buf that stage s-1 wrote, and writes the other half and y.
int run_cascade(const void* x, const void* c, const void* w, const void* a,
                void* buf, void* y, int B, int N, int P, int M, int z, int S,
                void* stream) {
  if (B < 1 || N < 1 || P < 1 || M < 0 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tile t = choose_tile(P, M);
  if (t.frames == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + t.frames - 1) / t.frames;
  if (static_cast<long long>(tiles) * B > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = P % 4 == 0;
  if (t.bytes > 48 * 1024) {
    const int err = vec ? set_smem_attribute<true>()
                        : set_smem_attribute<false>();
    if (err != 0) return err;
  }
  // Stage 1 follows the stream's earlier work in full; stage s > 1 is
  // the programmatic dependent of stage s-1: it may start early and load
  // its coefficients, and waits for s-1 before reading s-1's output.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * B);
  cfg.blockDim = dim3(t.threads);
  cfg.dynamicSmemBytes = t.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const float* x0 = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(c);
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
    const cudaError_t err =
        vec ? cudaLaunchKernelEx(&cfg, stage_kernel<true>, src, x0, dst, yf,
                                 cf, wf, af, N, P, M, z, t.frames, tiles, S, s)
            : cudaLaunchKernelEx(&cfg, stage_kernel<false>, src, x0, dst, yf,
                                 cf, wf, af, N, P, M, z, t.frames, tiles, S,
                                 s);
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

// The tile of a geometry: frames per block and threads per block through
// the pointers; returns its shared memory in bytes, or -1 where one frame
// does not fit (the geometry is refused).
extern "C" int mlsa_cascade_tile(int P, int M, int* frames, int* threads) {
  if (P < 1 || M < 0) return -1;
  const Tile t = choose_tile(P, M);
  *frames = t.frames;
  *threads = t.threads;
  return t.frames ? t.bytes : -1;
}

// The tap-chunked geometry (the B2 row): x (B, N, P), c (B, N, M+1), the
// stage weights w (S+1) and Taylor coefficients a (S+1), float32 on the
// card; buf (2, B, N, P) scratch; y (B, N, P) the result.  Enqueues S
// launches; returns the first launch error.
extern "C" int mlsa_cascade_stage_f32(const void* x, const void* c,
                                      const void* w, const void* a, void* buf,
                                      void* y, int B, int N, int P, int M,
                                      int z, int S, void* stream) {
  return run_cascade(x, c, w, a, buf, y, B, N, P, M, z, S, stream);
}

// Every other geometry (the B3 row): the same kernel and arguments.
extern "C" int mlsa_cascade_unchunked_stage_f32(
    const void* x, const void* c, const void* w, const void* a, void* buf,
    void* y, int B, int N, int P, int M, int z, int S, void* stream) {
  return run_cascade(x, c, w, a, buf, y, B, N, P, M, z, S, stream);
}

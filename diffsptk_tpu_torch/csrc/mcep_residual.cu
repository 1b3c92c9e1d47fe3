// Residual of one Newton step of mel-cepstral analysis, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (diffsptk_tpu/ops/mcep.py:186), and the port ran it as two cuBLAS GEMMs,
// a strided subtract and an exp, each writing an (H+1, B) tensor to device
// memory and reading it back.  Here it is one pass over log|X|^2.
//
// Computes, for every frame b < B, in float32 (F = H+1 frequencies, n <= 33,
// J = 2n-1):
//   D[k]  = sum_m P1[m, k] mc[m, b]          k < F, m < n (m ascending)
//   d[k]  = expf(log_x[b, k] - 2 D[k])       (one fused multiply-add)
//   rt[j] = sum_k P2[k, j] d[k]              j < J
//   ra[j] = rt[j] - av[j]                    j < n
// Inputs: mc (n, B) lane-major, log_x (B, F) row-major, P1 (n, F), P2 (F, J),
// av (n); outputs rt (J, B) and ra (n, B) lane-major, what the Newton
// kernel (newton.cu) takes.  No layout is copied on the host.
//
// Bound on this card: fp32 operations, with the bytes close behind.  A
// frame and frequency cost 2n + 2J + 3 operations (74 FMAs at n = 25) for
// the 4 bytes of log|X|^2 read once; at the analysis shapes (n = 25, F = 257
// or 1,025, B = 38,400 to 153,600) one call's least time is about 45-90 us
// by the operations at 67 TFLOP/s, 33-65 us by the bytes at 3.35 TB/s.
// Every product is an FMA on the CUDA cores (no tensor core: the
// configurations run full fp32), and expf is the accurate one.
//
// Design: a block of 128 threads owns a tile of 64 frames and walks F in
// chunks of 32 frequencies, so D and d never leave the SM:
//  - The tile's mc is staged once in shared memory.  Each chunk's log|X|^2
//    rows, P1 columns and P2 rows (the matrices stay in L2) arrive by
//    4-byte cp.async, a warp's 32 consecutive values at a time (rows of
//    log|X|^2 and P1 are F floats long, so not 16-byte aligned),
//    double-buffered: chunk c+1 loads while chunk c computes.  A whole
//    chunk of a whole tile takes its copies without bounds checks.
//  - Phase A: each thread forms D for 4 frames x 4 frequencies (16 FMAs a
//    step of m from two 16-byte loads), then d = expf(lx - 2D), which goes
//    to shared memory.
//  - Phase B: each thread accumulates rt for 8 frames x ceil(J/8) values of
//    j in registers (56 FMAs a frequency from two 16-byte loads of d and
//    seven 4-byte loads of P2 at n = 25), over alternate frequencies of the
//    chunk in each half of the block; the halves are summed once, in the
//    epilogue, which writes rt and ra.  Shared memory delivers 32 words a
//    clock against 128 FMAs, so the register tiles are as large as the
//    registers of four blocks an SM allow (128 a thread; on an H100 more
//    registers and fewer blocks ran slower).
//  - On an H100 the copies and barriers alone take about 60 % of the time
//    of the whole at these shapes; 16-byte copies of 16-byte aligned row
//    windows took no less than these 4-byte ones.
//  - 64-frame tiles keep 600-2,400 blocks in flight at these shapes, so no
//    wave of blocks leaves most of the card idle; a chunk past F is
//    zero-filled and only its whole groups of 4 frequencies are computed.
// The sums run in another order than cuBLAS's, and lx - 2D is one rounding
// where the plain composition's lx - D - D is two, so the two differ by
// float32 round-off.

#include <cuda_runtime.h>

#include <array>
#include <atomic>
#include <cstddef>
#include <utility>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;        // frames of a block
constexpr int kChunk = 32;       // frequencies of a step
constexpr int kLxRow = kChunk + 1;
// Phase A's steps of m unrolled at once: all 25 hoisted their loads into
// registers that the 56 sums already hold, and spilled.
constexpr int kUnrollM = 5;
constexpr int kGroups = 8;       // groups of j in phase B
constexpr int kMaxOrder = 33;
constexpr int kBlocksPerSm = 4;  // the registers' cap: 65,536 / (4 * 128)

template <int N>
struct Dims {
  static constexpr int J = 2 * N - 1;
  static constexpr int JC = (J + kGroups - 1) / kGroups;  // j a thread
  // A stage of P2: kChunk rows of J, and room for the last group's reads
  // past J (their sums are never written).
  static constexpr int P2Stage = (kChunk * J + kGroups * JC - J + 3) / 4 * 4;
};

// Frames are kept in "slot" order in mc and d: slot 4 i + r holds frame
// i + 16 r, so that phase A's thread i reads its frames i, i+16, i+32, i+48
// as one float4.
__device__ __forceinline__ int slot_of(int f) { return 4 * (f % 16) + f / 16; }
__device__ __forceinline__ int frame_of(int s) { return s / 4 + 16 * (s % 4); }

template <int N>
struct Smem {
  alignas(16) float mc[N][kTile];
  alignas(16) float p1[2][N][kChunk];
  alignas(16) float d[kChunk][kTile];
  alignas(16) float lx[2][kTile][kLxRow];  // frame order
  alignas(16) float p2[2][Dims<N>::P2Stage];
};

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of chunk c into stage s; out of range reads zero.
// log|X|^2 and P1: a warp copies 32 consecutive values of a row, the block
// 4 rows at a time; P2's rows k0 .. k0+31 are kChunk * J consecutive
// values.  A whole chunk of a whole tile takes no bounds checks.
template <int N>
__device__ __forceinline__ void load_chunk(Smem<N>& sm, int s, int c,
                                           const float* __restrict__ lx,
                                           const float* __restrict__ p1,
                                           const float* __restrict__ p2,
                                           int b0, int B, int F) {
  using D = Dims<N>;
  constexpr int kP2 = kChunk * D::J;
  const int k0 = c * kChunk;
  const int t = threadIdx.x;
  const int k = t % kChunk, r0 = t / kChunk;
  const size_t row4 = static_cast<size_t>(4) * F;
  const float* lsrc = lx + static_cast<size_t>(b0 + r0) * F + k0 + k;
  const float* psrc = p1 + static_cast<size_t>(r0) * F + k0 + k;
  const float* qsrc = p2 + static_cast<size_t>(k0) * D::J + t;
  if (b0 + kTile <= B && k0 + kChunk <= F) {
#pragma unroll
    for (int i = 0; i < kTile / 4; ++i) {
      copy4(&sm.lx[s][r0 + 4 * i][k], lsrc + i * row4, true);
    }
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) {
      if (r0 + 4 * i < N) copy4(&sm.p1[s][r0 + 4 * i][k], psrc + i * row4, true);
    }
#pragma unroll
    for (int i = 0; i < (kP2 + kThreads - 1) / kThreads; ++i) {
      if (kP2 % kThreads == 0 || t + kThreads * i < kP2) {
        copy4(&sm.p2[s][t + kThreads * i], qsrc + kThreads * i, true);
      }
    }
    return;
  }
  const bool kin = k0 + k < F;
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i) {
    const bool ok = kin && b0 + r0 + 4 * i < B;
    copy4(&sm.lx[s][r0 + 4 * i][k], ok ? lsrc + i * row4 : lx, ok);
  }
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) {
    if (r0 + 4 * i < N) {
      copy4(&sm.p1[s][r0 + 4 * i][k], kin ? psrc + i * row4 : p1, kin);
    }
  }
  const int rows = min(kChunk, F - k0);
#pragma unroll
  for (int i = 0; i < (kP2 + kThreads - 1) / kThreads; ++i) {
    const int e = t + kThreads * i;
    if (e < kP2) {
      const bool ok = e < rows * D::J;
      copy4(&sm.p2[s][e], ok ? qsrc + kThreads * i : p2, ok);
    }
  }
}

// Phase B over `steps` frequencies of this half (k = 2 q + half): with
// kSteps > 0 the trip count is kSteps and the loop unrolls.
template <int N, int kSteps>
__device__ __forceinline__ void accumulate(const Smem<N>& sm, int s, int half,
                                           int fb, int jg, int steps,
                                           float (&acc)[8][Dims<N>::JC]) {
  using D = Dims<N>;
  const int trips = kSteps > 0 ? kSteps : steps;
#pragma unroll
  for (int q = 0; q < trips; ++q) {
    const int k = 2 * q + half;
    const float4 d0 = *reinterpret_cast<const float4*>(&sm.d[k][8 * fb]);
    const float4 d1 = *reinterpret_cast<const float4*>(&sm.d[k][8 * fb + 4]);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    float pv[D::JC];
#pragma unroll
    for (int i = 0; i < D::JC; ++i) pv[i] = sm.p2[s][k * D::J + jg * D::JC + i];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int i = 0; i < D::JC; ++i) acc[r][i] = fmaf(dv[r], pv[i], acc[r][i]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mcep_residual_kernel(const float* __restrict__ mc, const float* __restrict__ lx,
                     const float* __restrict__ p1, const float* __restrict__ p2,
                     const float* __restrict__ av, float* __restrict__ rt,
                     float* __restrict__ ra, int B, int F) {
  using D = Dims<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kTile;
  const size_t ld = static_cast<size_t>(B);
  const int chunks = (F + kChunk - 1) / kChunk;

  // Phase A's thread: frames fa + 16 r (slots 4 fa + r), frequencies 4 ka ..
  const int fa = t % 16, ka = t / 16;
  // Phase B's thread: half of the chunk's frequencies, slots 8 fb .. 8 fb + 7,
  // j-group jg; a quarter warp spans 4 fb, so its 16-byte loads of d fall in
  // distinct banks, and a warp's 4-byte loads of P2 read 4 distinct banks.
  const int half = t / 64, u = t % 64;
  const int fb = (u & 3) | ((u >> 1) & 4);
  const int jg = ((u >> 2) & 1) | ((u >> 3) & 6);

  // The room past each P2 stage's rows, which no copy fills, reads zero.
  for (int e = kChunk * D::J + t; e < D::P2Stage; e += kThreads) {
    sm.p2[0][e] = 0.0f;
    sm.p2[1][e] = 0.0f;
  }
  for (int e = t; e < N * kTile; e += kThreads) {
    const int m = e / kTile, f = e % kTile;
    sm.mc[m][slot_of(f)] = b0 + f < B ? mc[m * ld + b0 + f] : 0.0f;
  }
  __syncthreads();  // the zeros land before any copy into the same stages
  load_chunk<N>(sm, 0, 0, lx, p1, p2, b0, B, F);
  commit();

  float acc[8][D::JC];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int i = 0; i < D::JC; ++i) acc[r][i] = 0.0f;
  }

  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    wait_all();
    // Chunk c is in; every thread is past phase B of chunk c - 1, so stage
    // s ^ 1 and d are free.
    __syncthreads();
    if (c + 1 < chunks) load_chunk<N>(sm, s ^ 1, c + 1, lx, p1, p2, b0, B, F);
    commit();
    const int valid = min(kChunk, F - c * kChunk);

    if (4 * ka < valid) {
      float dd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dd[r][q] = 0.0f;
      }
#pragma unroll kUnrollM
      for (int m = 0; m < N; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.mc[m][4 * fa]);
        const float4 p =
            *reinterpret_cast<const float4*>(&sm.p1[s][m][4 * ka]);
        const float av4[4] = {a.x, a.y, a.z, a.w};
        const float pv4[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) dd[r][q] = fmaf(av4[r], pv4[q], dd[r][q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * ka + q;
        float o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r] = expf(fmaf(-2.0f, dd[r][q], sm.lx[s][fa + 16 * r][k]));
        }
        *reinterpret_cast<float4*>(&sm.d[k][4 * fa]) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    if (valid == kChunk) {
      accumulate<N, kChunk / 2>(sm, s, half, fb, jg, 0, acc);
    } else {
      accumulate<N, 0>(sm, s, half, fb, jg, ((valid + 3) / 4) * 2, acc);
    }
  }

  // Sum the two halves: the upper half's sums go through shared memory,
  // in the log|X|^2 and P2 stages, which no copy fills any more.
  __syncthreads();
  float* sums = &sm.lx[0][0][0];
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int i = 0; i < D::JC; ++i) sums[(r * D::JC + i) * 64 + u] = acc[r][i];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int b = b0 + frame_of(8 * fb + r);
      if (b >= B) continue;
#pragma unroll
      for (int i = 0; i < D::JC; ++i) {
        const int j = jg * D::JC + i;
        if (j >= D::J) break;
        const float v = acc[r][i] + sums[(r * D::JC + i) * 64 + u];
        rt[j * ld + b] = v;
        if (j < N) ra[j * ld + b] = v - __ldg(av + j);
      }
    }
  }
}

using Launch = int (*)(const float*, const float*, const float*, const float*,
                       const float*, float*, float*, int, int, cudaStream_t);

template <int N>
int launch(const float* mc, const float* lx, const float* p1, const float* p2,
           const float* av, float* rt, float* ra, int B, int F,
           cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(Smem<N>));
  static_assert(bytes <= 227 * 1024, "shared memory of a block");
  static_assert(offsetof(Smem<N>, p2) == offsetof(Smem<N>, lx) +
                                             sizeof(Smem<N>::lx) &&
                    sizeof(Smem<N>::lx) + sizeof(Smem<N>::p2) >=
                        sizeof(float) * 8 * Dims<N>::JC * 64,
                "the epilogue's sums fit in the stages of log|X|^2 and P2");
  // The opt-in to more than 48 KB of shared memory holds per device.
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(mcep_residual_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const int grid = (B + kTile - 1) / kTile;
  mcep_residual_kernel<N><<<grid, kThreads, bytes, stream>>>(
      mc, lx, p1, p2, av, rt, ra, B, F);
  return static_cast<int>(cudaGetLastError());
}

template <int... I>
constexpr std::array<Launch, sizeof...(I)> launches(
    std::integer_sequence<int, I...>) {
  return {&launch<I + 1>...};
}

constexpr auto kOrders = std::make_integer_sequence<int, kMaxOrder>{};

}  // namespace

// mc (n, B), log_x (B, F), P1 (n, F), P2 (F, 2n-1), av (n) -> rt (2n-1, B),
// ra (n, B); every array contiguous float32.
extern "C" int mcep_residual_f32(const void* mc, const void* lx, const void* p1,
                                 const void* p2, const void* av, void* rt,
                                 void* ra, int n, int B, int F, void* stream) {
  if (n < 1 || n > kMaxOrder || B < 0 || F < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  static constexpr auto table = launches(kOrders);
  return table[n - 1](
      static_cast<const float*>(mc), static_cast<const float*>(lx),
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(av), static_cast<float*>(rt),
      static_cast<float*>(ra), B, F, static_cast<cudaStream_t>(stream));
}

// Batched symmetric-positive-definite solve, for sm_90a.
//
// Replaces: diffsptk_tpu/kernels/pallas_solve.py:_solve_kernel (reached
// through spd_solve_pallas / spd_solve_tpu).
//
// Computes, for each of B independent systems, x = A^-1 b by a
// right-looking Cholesky factor and both triangular sweeps:
//   A (B, n, n) row-major, b (B, n) -> x (B, n), float32, 1 <= n <= 64.
// Only the lower triangle of A is read, as in the JAX kernel.
//
// Bound on this card: bytes.  At the LPC analysis shapes (n = 24,
// B = 7,680) the solve must read the lower triangle of A and b and write
// x, (n(n+1)/2 + 2n) B floats = 10.7 MB, about 3.2 us at 3.35 TB/s; its
// n^3/3 + 2n^2 flops per system (44 MFLOP) take 0.66 us at the fp32 peak.
//
// Design: csrc/newton.cu's.  One warp per system, the system in registers.
//  - Orders are rounded up to N, a multiple of 8 (8 template instances,
//    one per N, so every loop unrolls and each lane's arrays are indexed
//    only statically).  Rows and columns n..N-1 are the identity, b there
//    is 0, made while loading: A is never copied.  For the real entries
//    that is exact: the padded columns come after every real one, so the
//    factor and the forward sweep never see them, and in the backward
//    sweep they add only -0 * 0 terms.
//  - Loading: row i's lower triangle A[i][0..i] is read by the lanes along
//    the row, so each load is coalesced and touches only the 32-byte
//    sectors that hold it; it goes through a per-warp shared buffer of
//    odd row stride (N|1), from which lane i takes row i (and lane i row
//    i+32 for N > 32) without bank conflicts.
//  - Step j of the factor: the pivot is broadcast with a shuffle, every
//    lane scales its L[i][j] by rsqrtf of it (no clamp: a non-positive
//    pivot gives NaN or inf, as in the JAX kernel), column j goes to a
//    small double-buffered shared buffer (one store a lane, one
//    __syncwarp a step) and each lane reads it back four values at a time
//    with broadcast 16-byte loads to update its row(s) in registers.
//  - Forward sweep: y_j is broadcast with a shuffle and each lane i > j
//    subtracts L[i][j] y_j from its entry.
//  - Backward sweep: L goes through the shared buffer once so that lane i
//    holds column i of L; x_j is then the dot product of column j with
//    the x_k already found, broadcast from its lane.
//  - Blocks of 4 warps (2 for N > 32, whose buffer is 16.6 KB a warp);
//    static shared memory, at most 34.3 KB: no opt-in.
// Order of the arithmetic, per entry: A[i][k] -= L[i][j] L[k][j] for j
// ascending; y_j = (b_j - sum_{k<j} L[j][k] y_k) / L[j][j] and
// x_j = (y_j - sum_{k>j} L[k][j] x_k) / L[j][j], each sum taken k
// ascending: the JAX kernel's order and that of kernels/solve.py's
// spd_solve_plain.  Each a - l m is one fused multiply-add here, two
// roundings there.

#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int kMaxOrder = 64;
constexpr int kStep = 8;  // orders are rounded up to a multiple of this
constexpr unsigned kAll = 0xffffffffu;

// Systems per block at order N.
template <int N>
constexpr int kWarpsOf = N > 32 ? 2 : 4;

// Shared memory of a block at order N.
template <int N>
struct Smem {
  static constexpr int W = kWarpsOf<N>;
  static constexpr int LS = N | 1;  // odd row stride
  float f[W][N][LS];                // rows of A as loaded, then L
  alignas(16) float col[W][2][N];   // column j of L, double-buffered
};

template <int N>
__global__ void __launch_bounds__(kWarpsOf<N> * 32)
spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int n, long long B) {
  constexpr int W = kWarpsOf<N>;
  constexpr bool kTwo = N > 32;      // lane l also holds row l + 32
  constexpr int N0 = kTwo ? 32 : N;  // rows held first by the lanes
  __shared__ Smem<N> sm;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long sys = static_cast<long long>(blockIdx.x) * W + w;
  if (sys >= B) return;  // a whole warp leaves; no block barrier follows
  float(*f)[Smem<N>::LS] = sm.f[w];
  const float* a = A + sys * n * n;
  const float* bs = b + sys * n;

  // Load row i's lower triangle along the lanes; rows past n are the
  // identity's, entries above the diagonal 0.
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int h = 0; h < (kTwo ? 2 : 1); ++h) {
      const int k = lane + 32 * h;
      if (k < N) {
        float v = 0.0f;
        if (k <= i) v = i < n ? __ldg(a + i * n + k) : (k == i ? 1.0f : 0.0f);
        f[i][k] = v;
      }
    }
  }
  float v0 = lane < n ? __ldg(bs + lane) : 0.0f;  // b, then y, of row r0
  float v1 = 0.0f;                                // of row r1
  if (kTwo && lane + 32 < n) v1 = __ldg(bs + lane + 32);
  __syncwarp();

  // Lanes past the last row repeat row N-1: their results are never read.
  const int r0 = lane < N ? lane : N - 1;
  const int r1 = kTwo && lane + 32 < N ? lane + 32 : N - 1;
  float a0[N0], a1[kTwo ? N : 1];
#pragma unroll
  for (int k = 0; k < N0; ++k) a0[k] = f[r0][k];
  if constexpr (kTwo) {
#pragma unroll
    for (int k = 0; k < N; ++k) a1[k] = f[r1][k];
  }

  // Right-looking Cholesky: a0[k] becomes L[r0][k] for k < r0, a1[k]
  // L[r1][k].
  float d0 = 0.0f, d1 = 0.0f;  // 1 / L[r0][r0], 1 / L[r1][r1]
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float* col = sm.col[w][j & 1];
    if (j < N0) {
      const float inv = rsqrtf(__shfl_sync(kAll, a0[j], j));
      if (lane == j) d0 = inv;
      a0[j] *= inv;
      if constexpr (kTwo) a1[j] *= inv;
      if (lane < N0) col[lane] = a0[j];
    } else if constexpr (kTwo) {
      const float inv = rsqrtf(__shfl_sync(kAll, a1[j], j - 32));
      if (lane == j - 32) d1 = inv;
      a1[j] *= inv;
    }
    if constexpr (kTwo) {
      if (lane + 32 < N) col[lane + 32] = a1[j];
    }
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4; q < N / 4; ++q) {
      const float4 c4 = reinterpret_cast<const float4*>(col)[q];
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * q + t;
        if (k > j) {
          if (k < N0 && j < N0) a0[k] = fmaf(-a0[j], c[t], a0[k]);
          if constexpr (kTwo) a1[k] = fmaf(-a1[j], c[t], a1[k]);
        }
      }
    }
  }

  // Forward sweep: v0 becomes y of row r0, v1 of row r1.
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < N0) {
      const float yj = __shfl_sync(kAll, v0 * d0, j);
      v0 = lane == j ? yj : (lane > j ? fmaf(-a0[j], yj, v0) : v0);
      if constexpr (kTwo) v1 = fmaf(-a1[j], yj, v1);
    } else if constexpr (kTwo) {
      const float yj = __shfl_sync(kAll, v1 * d1, j - 32);
      v1 = lane == j - 32 ? yj : (lane > j - 32 ? fmaf(-a1[j], yj, v1) : v1);
    }
  }

  // Transpose L through the shared buffer: c0[k] = L[k][r0] for k > r0,
  // c1[k] = L[k][r1] for k > r1.
  if (lane < N0) {
#pragma unroll
    for (int k = 0; k < N0; ++k) f[lane][k] = a0[k];
  }
  if constexpr (kTwo) {
    if (lane + 32 < N) {
#pragma unroll
      for (int k = 0; k < N; ++k) f[lane + 32][k] = a1[k];
    }
  }
  __syncwarp();
  float c0[N], c1[kTwo ? N : 1];
#pragma unroll
  for (int k = 1; k < N; ++k) c0[k] = f[k][r0];
  if constexpr (kTwo) {
#pragma unroll
    for (int k = 33; k < N; ++k) c1[k] = f[k][r1];
  }

  // Backward sweep, each sum k ascending from the x_k already broadcast.
  float xs[N];
  float mine0 = 0.0f, mine1 = 0.0f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    if (j < N0) {
      float acc = v0;
#pragma unroll
      for (int k = j + 1; k < N; ++k) acc = fmaf(-c0[k], xs[k], acc);
      xs[j] = __shfl_sync(kAll, acc * d0, j);
      if (lane == j) mine0 = xs[j];
    } else if constexpr (kTwo) {
      float acc = v1;
#pragma unroll
      for (int k = j + 1; k < N; ++k) acc = fmaf(-c1[k], xs[k], acc);
      xs[j] = __shfl_sync(kAll, acc * d1, j - 32);
      if (lane == j - 32) mine1 = xs[j];
    }
  }

  float* xo = x + sys * n;
  if (lane < n) xo[lane] = mine0;
  if (kTwo && lane + 32 < n) xo[lane + 32] = mine1;
}

using Launch = void (*)(const float*, const float*, float*, int, long long,
                        cudaStream_t);

template <int N>
void launch(const float* A, const float* b, float* x, int n, long long B,
            cudaStream_t stream) {
  constexpr int W = kWarpsOf<N>;
  const long long grid = (B + W - 1) / W;
  spd_solve_kernel<N><<<static_cast<unsigned>(grid), W * 32, 0, stream>>>(
      A, b, x, n, B);
}

template <int... I>
constexpr std::array<Launch, sizeof...(I)> launches(
    std::integer_sequence<int, I...>) {
  return {&launch<kStep * (I + 1)>...};
}

template <int... I>
constexpr std::array<int, sizeof...(I)> smem_sizes(
    std::integer_sequence<int, I...>) {
  return {static_cast<int>(sizeof(Smem<kStep * (I + 1)>))...};
}

constexpr auto kOrders = std::make_integer_sequence<int, kMaxOrder / kStep>{};

}  // namespace

// Static shared memory of a block at order n (that of n rounded up to a
// multiple of 8).
extern "C" int spd_solve_smem_bytes(int n) {
  if (n < 1 || n > kMaxOrder) return -1;
  return smem_sizes(kOrders)[(n - 1) / kStep];
}

extern "C" int spd_solve_f32(const void* A, const void* b, void* x, int n,
                             long long B, void* stream) {
  if (n < 1 || n > kMaxOrder || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if ((B + 1) / 2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static constexpr auto table = launches(kOrders);
  table[(n - 1) / kStep](static_cast<const float*>(A), static_cast<const float*>(b),
                         static_cast<float*>(x), n, B,
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

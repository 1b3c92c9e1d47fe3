// Toeplitz+Hankel Newton solve of (mel-generalized) cepstral analysis,
// for sm_90a.
//
// Replaces: diffsptk_tpu/kernels/pallas_newton.py:_newton_kernel, both
// of its entries: toephank_solve (mgcep, two generators) and
// newton_solve_t (mcep, one generator), each through
// toephank_solve_lane_major.
//
// Computes, for each of B systems laid out lane-major (system index on the
// fastest axis), x = A^-1 b with A[i][j] = p[|i-j|] + q[i+j]:
//   p (n, B), q (2n-1, B), b (n, B) -> x (n, B), float32, 1 <= n <= 33.
// mcep's systems take p = q[:n] (A[i][j] = rt[|i-j|] + rt[i+j]): the
// caller passes the same pointer for both, p then being the first n rows
// of q at the same stride, and the kernel stages that generator once.
//
// Bound on this card: bytes.  At the mel-cepstral analysis shapes (n = 25,
// B = 7,680) the solve needs about B (n^3/3 + 2n^2) = 50 MFLOP but must
// move (2n-1 + 2n) B floats = 3.0 MB (mgcep at n = 24: (n + 2n-1 + 2n) B
// floats = 3.7 MB), so the least time is the ~1 us the bytes take; in
// practice one launch costs more than either.
//
// Design: one warp per system, the system in registers.  n is a template
// parameter (one instance per n, chosen by toephank_solve_f32), so every
// loop over rows and columns unrolls and each lane's arrays are indexed
// only statically.  Lane i holds row i of A, then of L; for n = 33 row 32
// is computed by every lane alike (its inputs are all warp-uniform).
//  - A block of 4 warps stages its 4 systems' generators and b through
//    shared memory with coalesced loads (16 bytes of 4 consecutive
//    systems per row), and writes x back the same way.  The latency of
//    each step's shuffle, rsqrtf and shared round trip is hidden by
//    other warps.
//    4-warp blocks measured faster than 8-warp ones (n=25: 0.0216-0.0218
//    against 0.0229 ms of device time on an H100 80GB HBM3 at 700 W,
//    tools/torch_newton_gather_ab.py on both, in turns).  Holding n <= 25
//    to 64 registers gave 0.0200 ms, but with a minimum of blocks per SM
//    in the launch bounds ptxas spilled at some larger orders, whatever
//    that minimum, so the bounds name none.
//  - Step j of the right-looking Cholesky: lane j's diagonal is
//    broadcast with a shuffle, every lane scales its L[i][j] by rsqrtf of
//    it (no clamp: a non-positive pivot gives NaN or inf, as in the JAX
//    kernel), column j goes to a small shared buffer (one store a lane,
//    double-buffered, one __syncwarp a step), and each lane reads it back
//    four values at a time with broadcast 16-byte loads to update its row
//    in registers.  About n^2/2 FMAs and n^2/8 shared loads per warp.
//  - Forward sweep: y_j is broadcast with a shuffle and each lane i > j
//    subtracts L[i][j] y_j from its entry.
//  - Backward sweep: L goes through shared memory once so that lane i
//    holds column i of L; x_j is then the dot product of column j with
//    the x_k already found, broadcast from lane j.
// Order of the arithmetic, per entry: A[i][k] -= L[i][j] L[k][j] for j
// ascending; y_j = (b_j - sum_{k<j} L[j][k] y_k) / L[j][j] and
// x_j = (y_j - sum_{k>j} L[k][j] x_k) / L[j][j], each sum taken k
// ascending: the JAX kernel's order and that of kernels/newton.py's
// toephank_solve_plain.  Each a - l m is one fused multiply-add here, two
// roundings there.

#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int kWarps = 4;  // systems per block
constexpr int kMaxOrder = 33;
constexpr int kCol = 36;   // column buffer: 33 rows, padded to float4
constexpr unsigned kAll = 0xffffffffu;

// Shared memory of a block for order N.
template <int N>
struct Smem {
  static constexpr int R = 2 * N - 1;  // Hankel generator length (odd)
  static constexpr int LS = N | 1;     // odd row stride of the factor
  float g[kWarps][N + R];              // generators: p at 0, q at N
  float v[kWarps][LS];                 // b, then x
  float f[kWarps][N][LS];              // L, for its transpose
  alignas(16) float col[kWarps][2][kCol];
};

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
newton_kernel(const float* p, const float* q, const float* __restrict__ b,
              float* __restrict__ x, int B) {
  constexpr bool kRow32 = N > 32;  // row 32, computed by every lane
  constexpr int R = Smem<N>::R;
  __shared__ Smem<N> sm;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int sys0 = blockIdx.x * kWarps;
  const size_t ld = static_cast<size_t>(B);
  const bool one = p == q;  // one generator: p is q's first n rows

  // Stage the block's systems.  A system past B gets p[0] = 1 and q = 0
  // (with one generator, q[0] = 1: A = diag(2, 1, ...)) and b = 0, so
  // its lanes stay finite.
  for (int e = threadIdx.x; e < R * kWarps; e += kWarps * 32) {
    const int k = e / kWarps, s = e % kWarps;
    sm.g[s][N + k] = sys0 + s < B ? __ldg(q + k * ld + sys0 + s)
                                  : (one && k == 0 ? 1.0f : 0.0f);
  }
  if (!one) {
    for (int e = threadIdx.x; e < N * kWarps; e += kWarps * 32) {
      const int k = e / kWarps, s = e % kWarps;
      sm.g[s][k] = sys0 + s < B ? __ldg(p + k * ld + sys0 + s)
                                : (k == 0 ? 1.0f : 0.0f);
    }
  }
  for (int e = threadIdx.x; e < N * kWarps; e += kWarps * 32) {
    const int k = e / kWarps, s = e % kWarps;
    sm.v[s][k] = sys0 + s < B ? __ldg(b + k * ld + sys0 + s) : 0.0f;
  }
  __syncthreads();

  // Lanes past the last row repeat row N-1: their results are never read.
  const int i = lane < N ? lane : N - 1;
  const float* tp = sm.g[w] + (one ? N : 0);  // Toeplitz generator
  const float* hq = sm.g[w] + N;              // Hankel generator
  float a[N], a32[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a[k] = tp[i >= k ? i - k : k - i] + hq[i + k];
    if constexpr (kRow32) a32[k] = tp[32 - k] + hq[32 + k];
  }

  // Right-looking Cholesky: a[k] becomes L[i][k] for k < i.
  float d = 0.0f, d32 = 0.0f;  // 1 / L[i][i], 1 / L[32][32]
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float* col = sm.col[w][j & 1];
    float inv;
    if (kRow32 && j == 32) {
      inv = rsqrtf(a32[32]);
      d32 = inv;
    } else {
      inv = rsqrtf(__shfl_sync(kAll, a[j], j));
      if (lane == j) d = inv;
    }
    a[j] *= inv;
    if constexpr (kRow32) {
      a32[j] *= inv;
      if (lane == 0) col[32] = a32[j];
    }
    col[lane] = a[j];
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4; q < (N + 3) / 4; ++q) {
      const float4 c4 = reinterpret_cast<const float4*>(col)[q];
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * q + t;
        if (k > j && k < N) {
          a[k] = fmaf(-a[j], c[t], a[k]);
          if constexpr (kRow32) a32[k] = fmaf(-a32[j], c[t], a32[k]);
        }
      }
    }
  }

  // Forward sweep: v becomes y_i on lane i (y32 for row 32).
  float v = sm.v[w][i];
  float y32 = kRow32 ? sm.v[w][kRow32 ? 32 : 0] : 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (kRow32 && j == 32) {
      y32 *= d32;
    } else {
      const float yj = __shfl_sync(kAll, v * d, j);
      v = lane == j ? yj : (lane > j ? fmaf(-a[j], yj, v) : v);
      if constexpr (kRow32) y32 = fmaf(-a32[j], yj, y32);
    }
  }

  // Transpose L through shared memory: c[k] = L[k][i] for k > i.
  float(*f)[Smem<N>::LS] = sm.f[w];
  if (lane < N) {
#pragma unroll
    for (int k = 0; k < N; ++k) f[lane][k] = a[k];
  }
  if constexpr (kRow32) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) f[32][k] = a32[k];
    }
  }
  __syncwarp();
  float c[N];
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] = f[k][i];

  // Backward sweep, each sum k ascending from the x_k already broadcast.
  float xs[N];
  float mine = 0.0f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    if (kRow32 && j == 32) {
      xs[j] = y32 * d32;
    } else {
      float acc = v;
#pragma unroll
      for (int k = j + 1; k < N; ++k) acc = fmaf(-c[k], xs[k], acc);
      xs[j] = __shfl_sync(kAll, acc * d, j);
    }
    if (lane == j) mine = xs[j];
  }

  if (lane < N) sm.v[w][lane] = mine;
  if constexpr (kRow32) {
    if (lane == 0) sm.v[w][32] = xs[kRow32 ? 32 : 0];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * kWarps; e += kWarps * 32) {
    const int k = e / kWarps, s = e % kWarps;
    if (sys0 + s < B) x[k * ld + sys0 + s] = sm.v[s][k];
  }
}

using Launch = void (*)(const float*, const float*, const float*, float*,
                        int, cudaStream_t);

template <int N>
void launch(const float* p, const float* q, const float* b, float* x, int B,
            cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  newton_kernel<N><<<grid, kWarps * 32, 0, stream>>>(p, q, b, x, B);
}

template <int... I>
constexpr std::array<Launch, sizeof...(I)> launches(
    std::integer_sequence<int, I...>) {
  return {&launch<I + 1>...};
}

template <int... I>
constexpr std::array<int, sizeof...(I)> smem_sizes(
    std::integer_sequence<int, I...>) {
  return {static_cast<int>(sizeof(Smem<I + 1>))...};
}

constexpr auto kOrders = std::make_integer_sequence<int, kMaxOrder>{};

}  // namespace

extern "C" int newton_smem_bytes(int n) {
  if (n < 1 || n > kMaxOrder) return -1;
  return smem_sizes(kOrders)[n - 1];
}

// p (n, B), q (2n-1, B), b and x (n, B), each row B floats apart; p == q
// for mcep's one-generator systems (p = q[:n]).
extern "C" int toephank_solve_f32(const void* p, const void* q, const void* b,
                                  void* x, int n, int B, void* stream) {
  if (n < 1 || n > kMaxOrder || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // Static shared memory, at most 21 KB (n = 33): no opt-in needed.
  static constexpr auto table = launches(kOrders);
  table[n - 1](static_cast<const float*>(p), static_cast<const float*>(q),
               static_cast<const float*>(b), static_cast<float*>(x), B,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

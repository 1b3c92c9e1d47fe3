// Batched symmetric-positive-definite solve, for sm_90a.
//
// Replaces: diffsptk_tpu/kernels/pallas_solve.py:_solve_kernel (reached
// through spd_solve_pallas / spd_solve_tpu).
//
// Computes, for each of B independent systems, x = A^-1 b by a
// right-looking Cholesky factor and both triangular sweeps:
//   A (B, n, n) row-major, b (B, n) -> x (B, n), float32, 1 <= n <= 64.
// Only the lower triangle of A is used, as in the JAX kernel.
//
// Bound on this card: bytes.  At the LPC analysis shapes (n = 24,
// B = 7,680) the solve must read the lower triangle of A and b and write
// x, (n(n+1)/2 + 2n) B floats = 10.7 MB, about 3.2 us at 3.35 TB/s; its
// n^3/3 + 2n^2 flops per system (44 MFLOP) take 0.66 us at the fp32 peak.
//
// Design: one warp per system, the system in shared memory, as in
// csrc/newton.cu.  The TPU kernel's lane-major layout and its identity
// padding of the batch are not carried over: the warp reads its system's
// n^2 contiguous floats coalesced and keeps the lower triangle with an odd
// row stride (n|1), so the lanes reading one column hit distinct banks.  In
// the right-looking step j, lane l owns rows j+1+l and j+33+l: it scales
// L[i][j] and updates row i of the trailing block, so a system's serial
// chain is about n^2/2 updates instead of n^3/6.  A block holds as many
// systems as fit in 48 KB of shared memory, at most 8: 8 at n = 24
// (20.7 KB), 2 at n = 64 (34.3 KB).  Pivots are rsqrtf with no clamp, so
// a non-positive pivot gives NaN or inf as in the JAX kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;     // systems per block at most
constexpr int kMaxOrder = 64;
constexpr int kSmemBudget = 48 * 1024;  // no opt-in needed below this

// Floats of shared memory per system: L (n rows of stride n|1), v (n),
// inverse pivots (n).
__host__ __device__ inline int system_floats(int n) { return n * (n | 1) + 2 * n; }

inline int systems_per_block(int n) {
  const int fit = kSmemBudget / (system_floats(n) * static_cast<int>(sizeof(float)));
  return fit < kMaxWarps ? (fit < 1 ? 1 : fit) : kMaxWarps;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int n, long long B) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long sys = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (sys >= B) return;  // a whole warp leaves; no block barrier follows
  const int LS = n | 1;
  float* L = smem + w * system_floats(n);  // (n, LS) lower triangle
  float* v = L + n * LS;                   // b, then y, then x
  float* d = v + n;                        // 1 / L[j][j]
  const float* a = A + sys * n * n;
  const float* bs = b + sys * n;

  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n;
    const int j = e - i * n;
    const float val = __ldg(a + e);
    if (j <= i) L[i * LS + j] = val;
  }
  for (int i = lane; i < n; i += 32) v[i] = __ldg(bs + i);
  __syncwarp();

  // Right-looking Cholesky, in place.
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(L[j * LS + j]);
    for (int i = j + 1 + lane; i < n; i += 32) L[i * LS + j] *= inv;
    if (lane == 0) d[j] = inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = L[i * LS + j];
      for (int k = j + 1; k <= i; ++k) L[i * LS + k] -= lij * L[k * LS + j];
    }
    __syncwarp();
  }

  // Forward sweep: y_j = (b_j - sum_{k<j} L[j][k] y_k) / L[j][j].
  for (int j = 0; j < n; ++j) {
    const float yj = v[j] * d[j];
    __syncwarp();
    if (lane == 0) v[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) v[i] -= L[i * LS + j] * yj;
    __syncwarp();
  }

  // Backward sweep: x_j = (y_j - sum_{k>j} L[k][j] x_k) / L[j][j].
  for (int j = n - 1; j >= 0; --j) {
    const float xj = v[j] * d[j];
    __syncwarp();
    if (lane == 0) v[j] = xj;
    for (int i = lane; i < j; i += 32) v[i] -= L[j * LS + i] * xj;
    __syncwarp();
  }

  float* xs = x + sys * n;
  for (int i = lane; i < n; i += 32) xs[i] = v[i];
}

}  // namespace

extern "C" int spd_solve_smem_bytes(int n) {
  return systems_per_block(n) * system_floats(n) * static_cast<int>(sizeof(float));
}

extern "C" int spd_solve_f32(const void* A, const void* b, void* x, int n,
                             long long B, void* stream) {
  if (n < 1 || n > kMaxOrder || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int warps = systems_per_block(n);
  const long long grid = (B + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  spd_solve_kernel<<<static_cast<unsigned>(grid), warps * 32, spd_solve_smem_bytes(n),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(b),
      static_cast<float*>(x), n, B);
  return static_cast<int>(cudaGetLastError());
}

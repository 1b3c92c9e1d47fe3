// Toeplitz+Hankel Newton solve of mel-cepstral analysis, for sm_90a.
//
// Replaces: diffsptk_tpu/kernels/pallas_newton.py:_newton_kernel (reached
// through toephank_solve_lane_major / newton_solve_t).
//
// Computes, for each of B systems laid out lane-major (system index on the
// fastest axis), x = A^-1 b with A[i][j] = rt[|i-j|] + rt[i+j]:
//   rt (2n-1, B), b (n, B) -> x (n, B), float32.
//
// Bound on this card: bytes.  At the mel-cepstral analysis shapes (n = 25,
// B = 7,680) the solve needs about B (n^3/3 + 2n^2) = 50 MFLOP but must
// move (2n-1 + 2n) B floats = 3.0 MB, so the least time is the ~0.9 us the
// bytes take; in practice one launch costs more than either.
//
// Design: one warp per system.  With one thread per system the 7,680
// systems of a call give only ~60 threads per SM, each running the
// Cholesky's n^3/6 dependent updates alone, so nothing hides the latency.
// A warp per system gives the card 7,680 warps, and the warp's lanes share
// each step: the right-looking update of column j runs the rows below j in
// parallel (lane l takes row j+1+l), so a system's serial chain is about
// n^2/2 updates instead of n^3/6.  The system lives in shared memory: the
// generator vector, the lower triangle of A with an odd row stride (a
// warp's lanes read a column on distinct banks), the right-hand side and
// the pivots.  A is formed from rt on the fly.  The factor is in place;
// pivots are rsqrtf with no clamp, so a non-positive pivot gives NaN or
// inf as in the JAX kernel.  Both sweeps run column by column.  The
// arithmetic, and its order per entry, is the JAX kernel's.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // systems per block
constexpr int kMaxOrder = 33;

// Floats of shared memory per system: rt (2n-1, padded to 2n), A (n rows
// of stride n|1), v (n), inverse pivots (n).
__host__ __device__ inline int system_floats(int n) { return 2 * n + n * (n | 1) + 2 * n; }

__global__ void __launch_bounds__(kWarps * 32)
newton_kernel(const float* __restrict__ rt, const float* __restrict__ b,
              float* __restrict__ x, int n, int B) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;  // a whole warp leaves; no block barrier follows
  const int LS = n | 1;
  float* r = smem + w * system_floats(n);  // (2n-1) generator
  float* A = r + 2 * n;                    // (n, LS) lower triangle
  float* v = A + n * LS;                   // b, then y, then x
  float* d = v + n;                        // 1 / L[j][j]
  const size_t ld = static_cast<size_t>(B);

  for (int k = lane; k < 2 * n - 1; k += 32) r[k] = __ldg(rt + k * ld + sys);
  for (int i = lane; i < n; i += 32) v[i] = __ldg(b + i * ld + sys);
  __syncwarp();
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n;
    const int j = e - i * n;
    if (j <= i) A[i * LS + j] = r[i - j] + r[i + j];
  }
  __syncwarp();

  // Right-looking Cholesky, in place.
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(A[j * LS + j]);
    for (int i = j + 1 + lane; i < n; i += 32) A[i * LS + j] *= inv;
    if (lane == 0) d[j] = inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = A[i * LS + j];
      for (int k = j + 1; k <= i; ++k) A[i * LS + k] -= lij * A[k * LS + j];
    }
    __syncwarp();
  }

  // Forward sweep: y_j = (b_j - sum_{k<j} L[j][k] y_k) / L[j][j].
  for (int j = 0; j < n; ++j) {
    const float yj = v[j] * d[j];
    __syncwarp();
    if (lane == 0) v[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) v[i] -= A[i * LS + j] * yj;
    __syncwarp();
  }

  // Backward sweep: x_j = (y_j - sum_{k>j} L[k][j] x_k) / L[j][j].
  for (int j = n - 1; j >= 0; --j) {
    const float xj = v[j] * d[j];
    __syncwarp();
    if (lane == 0) v[j] = xj;
    for (int i = lane; i < j; i += 32) v[i] -= A[j * LS + i] * xj;
    __syncwarp();
  }

  for (int i = lane; i < n; i += 32) x[i * ld + sys] = v[i];
}

}  // namespace

extern "C" int newton_smem_bytes(int n) {
  return kWarps * system_floats(n) * static_cast<int>(sizeof(float));
}

extern "C" int newton_solve_f32(const void* rt, const void* b, void* x, int n,
                                int B, void* stream) {
  if (n < 1 || n > kMaxOrder || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // At most 8 x 1,221 floats = 39 KB: below the 48 KB that needs no opt-in.
  const int bytes = newton_smem_bytes(n);
  const int grid = (B + kWarps - 1) / kWarps;
  newton_kernel<<<grid, kWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rt), static_cast<const float*>(b),
      static_cast<float*>(x), n, B);
  return static_cast<int>(cudaGetLastError());
}

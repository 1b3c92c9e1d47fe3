// Windowed gather: out[b, n, k] = x[b, clamp(starts[b, n] + k, 0, T-1)].
//
// Replaces: diffsptk_tpu/kernels/pallas_gather.py:_make_kernel's _kernel
// (reached through _pallas_gather / gather_windows).
//
// The WORLD analysis reads many short windows of a row at f0-dependent
// starts: CheapTrick's DC correction and linear smoothing
// (ops/world_common.py:_frame_windows), D4C's, and TANDEM's band windows
// (ops/ap.py, one call for all bands).  Indices are clamped elementwise to
// the row, the rule of the JAX package's fallback (pallas_gather.py:123),
// so the kernel and its plain twin agree on every input.
//
// Bound on this card: bytes.  The least traffic is the output written once
// (B N L values), the starts, and each input sample that some clamped
// window covers read once: at most min(B T, B N L) values, and at WORLD's
// sites far fewer than B T, since a row is padded and each frame's windows
// lie within its own stride (chip_smoke.py counts the covered samples from
// the starts).  There is no arithmetic.
//
// Design: a copy with data-dependent starts.  A block of 256 threads takes
// kWindows windows of one row; it loads their starts itself (no scalar
// prefetch on this card), and for each window its threads run along k, so
// consecutive threads read consecutive samples of x and write consecutive
// outputs: both are coalesced, whatever the start's alignment.  The TPU
// kernel's 128-lane roll has no counterpart: a warp's unaligned read costs
// at most one extra 32-byte sector.  Windows overlap, so their samples are
// read again from L2, not from device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindows = 8;  // windows per block

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ x, const int* __restrict__ starts,
              float* __restrict__ out, int T, int N, int L) {
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kWindows;
  const float* xb = x + static_cast<size_t>(b) * T;
  __shared__ int s[kWindows];
  if (threadIdx.x < kWindows && n0 + threadIdx.x < N) {
    s[threadIdx.x] = starts[static_cast<size_t>(b) * N + n0 + threadIdx.x];
  }
  __syncthreads();
  const int nw = min(kWindows, N - n0);
  for (int w = 0; w < nw; ++w) {
    const long long st = s[w];
    float* o = out + (static_cast<size_t>(b) * N + n0 + w) * L;
    for (int k = threadIdx.x; k < L; k += kThreads) {
      long long i = st + k;
      i = i < 0 ? 0 : (i >= T ? T - 1 : i);
      o[k] = __ldg(xb + i);
    }
  }
}

}  // namespace

extern "C" int gather_windows_f32(const void* x, const void* starts,
                                  void* out, int B, int T, int N, int L,
                                  void* stream) {
  if (B < 1 || T < 1 || N < 1 || L < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kWindows - 1) / kWindows, B);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(starts),
      static_cast<float*>(out), T, N, L);
  return static_cast<int>(cudaGetLastError());
}

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
// Design: a copy with data-dependent starts, so it is held back by the
// loads in flight, not by arithmetic.  The output is one flat span of
// B N L values; each warp takes kSpan consecutive values of it, whatever
// the windows and rows they fall in, so no window leaves a thread idle.
// Lane l of the warp takes values l, l + 32, ..., so each of its
// kPerLane loads and stores is coalesced across the warp (32 consecutive
// samples of one window, or of two neighbours), and all kPerLane clamped
// loads are issued before the first store: 8 loads a thread, up to 64 KB
// in flight on an SM.  (Eight consecutive values a thread with 16-byte
// stores would stride the warp's loads by 32 bytes, eight lines per load
// instruction.)  A lane finds the window and offset of its first value
// with one division by L and one by N, each a multiply by a reciprocal
// computed on the host (kernels/gather.py:split_index, tested on the
// CPU), corrected by one step; it then steps 32 values at a time, across
// window and row edges, with no further division.  The starts, a few KB,
// are read through the read-only path, the next window's ahead of need.
// Flat indices and starts are 64-bit: the callers' int64 starts need no
// conversion launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 8;            // values a thread, loads in flight
constexpr int kSpan = 32 * kPerLane;   // consecutive values of a warp

// q = a / d and a - q d for 0 <= a < 2^53, from inv = 1.0 / d rounded
// to double: the truncated product is q, q - 1 or q + 1.
__device__ __forceinline__ long long split(long long a, int d, double inv,
                                           int* rem) {
  long long q = static_cast<long long>(static_cast<double>(a) * inv);
  long long r = a - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
  *rem = static_cast<int>(r);
  return q;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ x,
              const long long* __restrict__ starts,
              float* __restrict__ out, long long total, long long windows,
              int T, int N, int L, double inv_len, double inv_n) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long f = warp * kSpan + lane;
  if (f >= total) return;

  int k, n;
  long long w = split(f, L, inv_len, &k);     // window, offset in it
  const long long b = split(w, N, inv_n, &n);  // row, window in the row
  const float* xb = x + b * T;
  long long s = __ldg(starts + w);
  long long s_next = w + 1 < windows ? __ldg(starts + w + 1) : 0;

  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (f + 32 * j < total) {
      long long i = s + k;
      i = i < 0 ? 0 : (i >= T ? T - 1 : i);
      v[j] = __ldg(xb + i);
    }
    if (j + 1 < kPerLane) {
      k += 32;
      while (k >= L) {  // at most once a step for L >= 32
        k -= L;
        ++w;
        if (++n == N) {
          n = 0;
          xb += T;
        }
        s = s_next;
        s_next = w + 1 < windows ? __ldg(starts + w + 1) : 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (f + 32 * j < total) out[f + 32 * j] = v[j];
  }
}

}  // namespace

extern "C" int gather_windows_f32(const void* x, const void* starts,
                                  void* out, int B, int T, int N, int L,
                                  double inv_len, double inv_n,
                                  void* stream) {
  if (B < 1 || T < 1 || N < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long windows = static_cast<long long>(B) * N;
  const long long total = windows * L;
  if (total >= (1LL << 53)) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = (total + kSpan - 1) / kSpan;
  const long long grid = (warps * 32 + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const long long*>(starts),
      static_cast<float*>(out), total, windows, T, N, L, inv_len, inv_n);
  return static_cast<int>(cudaGetLastError());
}

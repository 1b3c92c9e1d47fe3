// Overlap-add: y[b, tidx[b, p] + l] += resp[b, p, l] for every slot p and
// l < L, slots taken in a nondecreasing order of tidx.
//
// Replaces: diffsptk_tpu/kernels/pallas_ola.py:_make_kernel's _kernel
// (reached through _pallas_ola / overlap_add).
//
// WORLD synthesis adds one response of L = fft_length samples per pulse
// slot into the output row (ops/world_synth.py); the backward of the
// windowed gather (kernels/gather.py) is the same operation at the gather's
// starts.
//
// Bound on this card: bytes.  The responses are read once and the output
// written once: at the [world] shapes (B = 32, about 743 slots of 1,024)
// 97 MB in and 2.6 MB out, 30 us at 3.35 TB/s.  One add per input value.
//
// Design: output-stationary, so the sums are deterministic.  The TPU kernel
// serialises its read-modify-writes on one core; Hopper's blocks run in
// parallel, and atomics would make the order of the sums, and so the
// rounding, change from run to run.  Instead a block of 256 threads owns 256
// consecutive output samples of one row and sums, in slot order, every slot
// whose window covers them: the slot table is sorted by start, so the slots
// that touch [t0, t0 + 256) are one contiguous range, found by two binary
// searches.  Each thread keeps one output sample in a register; for a
// slot, the warp's 32 threads read 32 consecutive response samples
// (coalesced), and the slot's start is one broadcast read.  A thread issues
// the loads of 8 slots at once: a run of hundreds of slots at one start
// (WORLD's unused slots) would otherwise be one dependent load after
// another.  Every output sample is written exactly once, so the output
// needs no zeroing.  An optional permutation gives the response row of
// each sorted slot, so a caller with unsorted starts (the gather's
// backward) sorts only the starts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // slots whose loads are in flight together

// First p in [0, P) with tidx[p] >= v (P when none); tidx is sorted.
__device__ inline int lower_bound(const int* tidx, int P, long long v) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tidx[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
ola_kernel(const int* __restrict__ tidx, const int* __restrict__ perm,
           const float* __restrict__ resp, float* __restrict__ y, int P,
           int L, int out_len) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kThreads;
  const int* tb = tidx + static_cast<size_t>(b) * P;
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    range[0] = lower_bound(tb, P, static_cast<long long>(t0) - L + 1);
    range[1] = lower_bound(tb, P, static_cast<long long>(t0) + kThreads);
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  const float* rb = resp + static_cast<size_t>(b) * P * L;
  const int* pb = perm ? perm + static_cast<size_t>(b) * P : nullptr;
  // Slots in groups of kUnroll: the group's loads are issued together
  // (predicated, not branched), so a block that walks a long run of slots
  // (WORLD's unused slots all repeat the last pulse) keeps several loads in
  // flight; the adds stay in slot order.
  float acc = 0.f;
  int p = range[0];
  for (; p + kUnroll <= range[1]; p += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int d = t - __ldg(tb + p + u);
      const int row = pb ? __ldg(pb + p + u) : p + u;
      v[u] = (d >= 0 && d < L) ? __ldg(rb + static_cast<size_t>(row) * L + d)
                               : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  for (; p < range[1]; ++p) {
    const int d = t - __ldg(tb + p);
    const int row = pb ? __ldg(pb + p) : p;
    if (d >= 0 && d < L) acc += __ldg(rb + static_cast<size_t>(row) * L + d);
  }
  if (t < out_len) y[static_cast<size_t>(b) * out_len + t] = acc;
}

}  // namespace

extern "C" int overlap_add_f32(const void* tidx, const void* perm,
                               const void* resp, void* y, int B, int P, int L,
                               int out_len, void* stream) {
  if (B < 1 || P < 1 || L < 1 || out_len < L || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((out_len + kThreads - 1) / kThreads, B);
  ola_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tidx), static_cast<const int*>(perm),
      static_cast<const float*>(resp), static_cast<float*>(y), P, L,
      out_len);
  return static_cast<int>(cudaGetLastError());
}

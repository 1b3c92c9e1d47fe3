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
// written once: at the [world] shapes (B = 32, 740 slots of 1,024) 97 MB in
// and 2.6 MB out, 30 us at 3.35 TB/s.  One add per input value.
//
// Design: output-stationary, so the sums are deterministic (atomics would
// make the order of the sums, and so the rounding, change from run to run),
// in two passes that bound every thread's serial chain.
//
// The slot table is sorted by start, so the slots that touch an output
// tile are one contiguous range.  A block that owned a tile and walked its
// whole range (the first design) was as slow as its longest range: WORLD's
// unused slots all repeat the last pulse's start, so the five or so tiles
// under that pulse's window walked several hundred slots each, against
// about forty mid-row, and a few blocks set the kernel's length.
//
// Pass 1 (ola_group_kernel) cuts each row's slots into groups of `group`
// consecutive slots, g = 0 .. G-1, and overlap-adds each group alone into
// its own region of a workspace row of out_len + G L values: group g's sum
// at output t lands at t + g L, so its region [first(g) + g L, last(g) + L
// + g L) (first and last the group's starts) ends before group g+1's
// begins, since starts are sorted.  A block owns kTile consecutive
// workspace values, which meet at most 2 regions when L >= kTile, and sums
// in slot order only the slots of those groups that touch it: at most 2
// `group` slots, whatever the slot table.  The group's starts and rows are
// staged in shared memory; the slots that touch the tile are counted with
// two block-wide counts (__syncthreads_count); then, as before, each thread
// keeps one output in a register, a warp reads 32 consecutive response
// samples of a slot (coalesced), and a thread has 8 slots' loads in flight.
// Blocks take the row ends first, where the repeated starts pile up.
//
// Pass 2 (ola_sum_kernel) sums, for each output t, the regions that cover
// it, in ascending g: the groups g with first(g) <= t < last(g) + L, a
// contiguous range, at most G.  It reads the workspace (out_len + about G L
// values a row) once, coalesced, and writes every output once, so the
// output needs no zeroing; the workspace between regions is never read.
//
// The order of the adds is fixed (slot order within a group, group order
// across groups), so two runs agree bit for bit and a plain version in the
// same order (kernels/ola.py:overlap_add_grouped) equals the kernel.
// Starts and the optional permutation (the response row of each sorted
// slot, for the gather's backward) are int64, as the callers hold them: no
// conversion launch.
//
// 16-byte loads were weighed and left out: with 8 loads of 4 bytes in
// flight per thread and 2,048 threads an SM, 64 KB are in flight per SM,
// about three times what 3.35 TB/s needs at the card's latency; the first
// design was held back by its longest block, not by the load width.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // values a block, one a thread
constexpr int kUnroll = 8;       // slots whose loads are in flight together

// Counts, over the groups g < G, of last(g) + L + g L <= lo (regions wholly
// before lo) and of first(g) + g L < hi (regions that start before hi),
// with `shift` = L for workspace coordinates and 0 for output ones.
__device__ inline void count_regions(const long long* tb, int P, int L,
                                     int group, int G, long long lo,
                                     long long hi, long long shift,
                                     int* before, int* starting) {
  __shared__ int counts[2];
  if (threadIdx.x == 0) counts[0] = counts[1] = 0;
  __syncthreads();
  int n_before = 0, n_starting = 0;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const long long base = shift * g;
    const int p0 = g * group;
    const int p1 = min(p0 + group, P) - 1;
    n_before += __ldg(tb + p1) + L + base <= lo;
    n_starting += __ldg(tb + p0) + base < hi;
  }
  if (n_before) atomicAdd(&counts[0], n_before);
  if (n_starting) atomicAdd(&counts[1], n_starting);
  __syncthreads();
  *before = counts[0];
  *starting = counts[1];
}

__global__ void __launch_bounds__(kThreads)
ola_group_kernel(const long long* __restrict__ tidx,
                 const long long* __restrict__ perm,
                 const float* __restrict__ resp, float* __restrict__ ws,
                 int P, int L, int group, int G, long long W) {
  const int b = blockIdx.x;
  const long long w0 =
      static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kTile;
  const long long* tb = tidx + static_cast<size_t>(b) * P;
  const long long* pb = perm ? perm + static_cast<size_t>(b) * P : nullptr;
  const float* rb = resp + static_cast<size_t>(b) * P * L;
  int g_lo, g_hi;
  count_regions(tb, P, L, group, G, w0, w0 + kTile, L, &g_lo, &g_hi);

  __shared__ long long start[kThreads];
  __shared__ long long row[kThreads];
  const long long w = w0 + threadIdx.x;
  float acc = 0.f;
  bool mine = false;  // w lies in a region
  for (int g = g_lo; g < g_hi; ++g) {
    const int p0 = g * group;
    const int n = min(group, P - p0);
    __syncthreads();  // the previous group's starts are no longer read
    if (threadIdx.x < n) {
      start[threadIdx.x] = __ldg(tb + p0 + threadIdx.x);
      row[threadIdx.x] = pb ? __ldg(pb + p0 + threadIdx.x) : p0 + threadIdx.x;
    }
    __syncthreads();
    const long long shift = static_cast<long long>(g) * L;
    const long long t = w - shift;  // the output this value belongs to
    const bool here = t >= start[0] && t < start[n - 1] + L;
    mine = mine || here;
    // the group's slots that touch the tile: those before p_lo end before
    // it, those from p_hi on start after it
    const long long t_lo = w0 - shift;
    const int p_lo = __syncthreads_count(threadIdx.x < n &&
                                         start[threadIdx.x] + L <= t_lo);
    const int p_hi = __syncthreads_count(
        threadIdx.x < n && start[threadIdx.x] < t_lo + kTile);
    int p = p_lo;
    for (; p + kUnroll <= p_hi; p += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long d = t - start[p + u];
        v[u] = (here && d >= 0 && d < L)
                   ? __ldg(rb + static_cast<size_t>(row[p + u]) * L + d)
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += v[u];
    }
    for (; p < p_hi; ++p) {
      const long long d = t - start[p];
      if (here && d >= 0 && d < L) {
        acc += __ldg(rb + static_cast<size_t>(row[p]) * L + d);
      }
    }
  }
  if (mine) ws[static_cast<size_t>(b) * W + w] = acc;
}

__global__ void __launch_bounds__(kThreads)
ola_sum_kernel(const long long* __restrict__ tidx,
               const float* __restrict__ ws, float* __restrict__ y, int P,
               int L, int group, int G, long long W, int out_len) {
  const int b = blockIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long* tb = tidx + static_cast<size_t>(b) * P;
  int g_lo, g_hi;
  count_regions(tb, P, L, group, G, t0, t0 + kTile, 0, &g_lo, &g_hi);
  const long long t = t0 + threadIdx.x;
  const float* wb = ws + static_cast<size_t>(b) * W + t;
  float acc = 0.f;
  for (int g = g_lo; g < g_hi; ++g) {
    const long long first = __ldg(tb + g * group);
    const long long end = __ldg(tb + min(g * group + group, P) - 1) + L;
    if (t >= first && t < end) acc += wb[static_cast<size_t>(g) * L];
  }
  if (t < out_len) y[static_cast<size_t>(b) * out_len + t] = acc;
}

}  // namespace

extern "C" int overlap_add_f32(const void* tidx, const void* perm,
                               const void* resp, void* ws, void* y, int B,
                               int P, int L, int out_len, int group,
                               void* stream) {
  if (B < 1 || P < 1 || L < 1 || out_len < L || group < 1 ||
      group > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = (P + group - 1) / group;
  const long long W = static_cast<long long>(out_len) +
                      static_cast<long long>(G) * L;
  const long long tiles_ws = (W + kTile - 1) / kTile;
  const long long tiles_y = (out_len + kTile - 1) / kTile;
  if (tiles_ws > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const long long*>(tidx);
  ola_group_kernel<<<dim3(B, static_cast<unsigned>(tiles_ws)), kThreads, 0,
                     st>>>(t, static_cast<const long long*>(perm),
                           static_cast<const float*>(resp),
                           static_cast<float*>(ws), P, L, group, G, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ola_sum_kernel<<<dim3(B, static_cast<unsigned>(tiles_y)), kThreads, 0,
                   st>>>(t, static_cast<const float*>(ws),
                         static_cast<float*>(y), P, L, group, G, W, out_len);
  return static_cast<int>(cudaGetLastError());
}

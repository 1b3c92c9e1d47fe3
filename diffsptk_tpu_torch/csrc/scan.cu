// First-order linear recurrence (affine scan along time), for sm_90a.
//
// Replaces: diffsptk_tpu/kernels/pallas_scan.py:_kernel and _kernel_complex
// (reached through pallas_first_order_scan / scan_diff).
//
// Computes, for R rows of T samples,
//   y[r][t] = p[r][t] y[r][t-1] + x[r][t],   y[r][-1] = 0,
// in float32, or in complex64 read natively in torch's interleaved layout
// (float2: re, im), with no split planes.
//
// Bound on this card: bytes.  p and x must be read once and y written once,
// 3 R T values: at R = 32, T = 19,200 float32 that is 7.4 MB, about 2.2 us
// at 3.35 TB/s.  The work is 2 flops per sample.
//
// Design: the maps s -> p s + x compose associatively, (pl, xl) then
// (pr, xr) = (pl pr, xl pr + xr), so a row splits into chunks of 1,024
// samples scanned in parallel; 32 rows would leave most SMs idle with one
// block per row.  A block of 256 threads takes one chunk: each thread
// composes the maps of its 4 consecutive samples, the warp composes its
// threads' maps with shuffles, and the 8 warp maps meet in shared memory.
// A row of more than one chunk takes three passes, all enqueued by one call:
//   1. every chunk's composed map, its summary (R x n_chunks maps);
//   2. the same scan over each row's summaries (recursively, if a row has
//      more than 1,024 chunks), which gives the state at the end of every
//      chunk;
//   3. every chunk again: each thread applies the map of the samples before
//      it to the state entering the chunk, then runs its 4 samples serially.
// So p and x are read twice (5 R T values move, 1.7x the bound's bytes) and
// all chunks of all rows run at once: 32 rows of 19 chunks are 608 blocks.
// The products of p over a chunk are formed in float32 (complex64), as the
// TPU kernel forms them (pallas_scan.py:74-79).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;

struct Real {
  using V = float;
  __device__ static V one() { return 1.0f; }
  __device__ static V zero() { return 0.0f; }
  __device__ static V mul(V a, V b) { return a * b; }
  __device__ static V fma(V a, V b, V c) { return a * b + c; }  // a b + c
  __device__ static V shfl_up(V v, int d) { return __shfl_up_sync(0xffffffffu, v, d); }
};

struct Complex {
  using V = float2;
  __device__ static V one() { return make_float2(1.0f, 0.0f); }
  __device__ static V zero() { return make_float2(0.0f, 0.0f); }
  __device__ static V mul(V a, V b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  }
  __device__ static V fma(V a, V b, V c) {
    const V m = mul(a, b);
    return make_float2(m.x + c.x, m.y + c.y);
  }
  __device__ static V shfl_up(V v, int d) {
    return make_float2(__shfl_up_sync(0xffffffffu, v.x, d),
                       __shfl_up_sync(0xffffffffu, v.y, d));
  }
};

template <class Op>
struct Map {
  typename Op::V p, x;
};

// The map of ``l`` followed by ``r``.
template <class Op>
__device__ inline Map<Op> compose(const Map<Op>& l, const Map<Op>& r) {
  return {Op::mul(l.p, r.p), Op::fma(l.x, r.p, r.x)};
}

template <class Op>
__device__ inline Map<Op> identity() {
  return {Op::one(), Op::zero()};
}

// One block per (row, chunk); blockIdx.x = row * n_chunks + chunk.  With
// kApply false the block writes its chunk's composed map to (sum_p, sum_x);
// with kApply true it writes y, entering the chunk with the state
// carry[row][chunk - 1] (0 for the first chunk, or when carry is null).
template <class Op, bool kApply>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const typename Op::V* __restrict__ p, const typename Op::V* __restrict__ x,
            typename Op::V* __restrict__ y, const typename Op::V* __restrict__ carry,
            typename Op::V* __restrict__ sum_p, typename Op::V* __restrict__ sum_x,
            long long T, int n_chunks) {
  using V = typename Op::V;
  __shared__ Map<Op> warp_maps[kWarps];
  const int row = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - row * n_chunks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(row) * T;
  const long long t0 = static_cast<long long>(chunk) * kChunk + threadIdx.x * kPerThread;

  V pk[kPerThread], xk[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long t = t0 + k;
    pk[k] = t < T ? p[base + t] : Op::one();
    xk[k] = t < T ? x[base + t] : Op::zero();
  }
  Map<Op> m{pk[0], xk[0]};
#pragma unroll
  for (int k = 1; k < kPerThread; ++k) m = compose<Op>(m, Map<Op>{pk[k], xk[k]});

  // Inclusive scan of the threads' maps within the warp.
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const Map<Op> o{Op::shfl_up(m.p, d), Op::shfl_up(m.x, d)};
    if (lane >= d) m = compose<Op>(o, m);
  }
  if (lane == 31) warp_maps[warp] = m;
  Map<Op> before{Op::shfl_up(m.p, 1), Op::shfl_up(m.x, 1)};
  if (lane == 0) before = identity<Op>();
  __syncthreads();

  if (!kApply) {
    if (threadIdx.x == 0) {
      Map<Op> total = warp_maps[0];
      for (int w = 1; w < kWarps; ++w) total = compose<Op>(total, warp_maps[w]);
      const long long s = static_cast<long long>(row) * n_chunks + chunk;
      sum_p[s] = total.p;
      sum_x[s] = total.x;
    }
    return;
  }

  Map<Op> prefix = identity<Op>();
  for (int w = 0; w < warp; ++w) prefix = compose<Op>(prefix, warp_maps[w]);
  prefix = compose<Op>(prefix, before);
  V s = Op::zero();
  if (carry != nullptr && chunk > 0)
    s = carry[static_cast<long long>(row) * n_chunks + chunk - 1];
  s = Op::fma(s, prefix.p, prefix.x);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    s = Op::fma(s, pk[k], xk[k]);
    if (t0 + k < T) y[base + t0 + k] = s;
  }
}

long long chunks_of(long long T) { return (T + kChunk - 1) / kChunk; }

// Values of scratch that a scan of R rows of T samples needs.
long long scratch_values(long long R, long long T) {
  const long long nc = chunks_of(T);
  return nc <= 1 ? 0 : 3 * R * nc + scratch_values(R, nc);
}

template <class Op>
int scan(const typename Op::V* p, const typename Op::V* x, typename Op::V* y,
         typename Op::V* scratch, long long R, long long T, cudaStream_t stream) {
  const long long nc = chunks_of(T);
  if (R * nc > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(R * nc);
  if (nc <= 1) {
    scan_kernel<Op, true><<<grid, kThreads, 0, stream>>>(p, x, y, nullptr, nullptr,
                                                        nullptr, T, 1);
    return static_cast<int>(cudaGetLastError());
  }
  typename Op::V* sum_p = scratch;
  typename Op::V* sum_x = sum_p + R * nc;
  typename Op::V* ends = sum_x + R * nc;
  scan_kernel<Op, false><<<grid, kThreads, 0, stream>>>(p, x, nullptr, nullptr, sum_p,
                                                       sum_x, T, static_cast<int>(nc));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = scan<Op>(sum_p, sum_x, ends, ends + R * nc, R, nc, stream);
  if (err != 0) return err;
  scan_kernel<Op, true><<<grid, kThreads, 0, stream>>>(p, x, y, ends, nullptr, nullptr,
                                                      T, static_cast<int>(nc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long first_order_scan_scratch(long long R, long long T) {
  return scratch_values(R, T);
}

extern "C" int first_order_scan_f32(const void* p, const void* x, void* y, void* scratch,
                                    long long R, long long T, void* stream) {
  if (R < 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || T == 0) return 0;
  return scan<Real>(static_cast<const float*>(p), static_cast<const float*>(x),
                    static_cast<float*>(y), static_cast<float*>(scratch), R, T,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int first_order_scan_c64(const void* p, const void* x, void* y, void* scratch,
                                    long long R, long long T, void* stream) {
  if (R < 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || T == 0) return 0;
  return scan<Complex>(static_cast<const float2*>(p), static_cast<const float2*>(x),
                       static_cast<float2*>(y), static_cast<float2*>(scratch), R, T,
                       static_cast<cudaStream_t>(stream));
}

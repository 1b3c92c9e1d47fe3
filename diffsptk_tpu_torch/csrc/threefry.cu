// JAX's default random numbers on the card: Threefry-2x32 (20 rounds) in
// JAX's partitionable layout, as uniform bits or float32 normals.
//
// Replaces: jax.random.normal as the JAX package calls it for WORLD's
// noise, diffsptk_tpu/ops/world_common.py:293-298 (the windowed
// waveform's dither, PRNGKey(0)) and diffsptk_tpu/ops/world_synth.py:128-143
// (_slot_noise: per slot, fold_in(PRNGKey(seed), ctr) then
// normal(key, (length,))).  Not a Pallas kernel: on the TPU it is XLA's
// lowering of the threefry primitive.  The plain twin is
// diffsptk_tpu_torch/utils/prng.py, which holds the arithmetic's sources.
//
// Element i of a draw hashes the counter (i >> 32, i & 0xFFFFFFFF) under
// its key; its 32 bits are the xor of the two output words.  A float32
// normal is sqrt(2) erfinv(u) with u = max(lo, 2 f + lo), f the top 23 bits
// over 2^23 and lo = nextafter(-1, 0) (JAX's uniform on [lo, 1): its scale
// 1 - lo rounds to 2, so 2 f is exact and no contraction changes u), and
// erfinv Giles' single-precision polynomial, as XLA lowers erf_inv.
//
// Bound on this card: operations.  A draw writes 4 bytes an element and
// does about a hundred operations on it (77 for the hash, about 30 for u
// and erfinv): against the fp32 peak that is 1.3 times the time of the
// bytes (chip_smoke.py computes both), and the hash's adds, xors and
// rotations run on the integer pipe at half that rate.  So the kernel keeps
// the hash lean: one thread an element, a rotation is one funnel shift, and
// the slot draw gives each block one slot, whose key (one more hash) each
// thread computes once for the values it writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32 of the counter (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// The 32-bit draw of flat element i under the key.
__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1,
                                           long long i) {
  const unsigned long long c = static_cast<unsigned long long>(i);
  uint32_t x0 = static_cast<uint32_t>(c >> 32);
  uint32_t x1 = static_cast<uint32_t>(c);
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// XLA's ErfInv32 (Giles): |x| < 1 here, so no infinite edge.
__device__ __forceinline__ float erfinv_giles(float x) {
  constexpr float kSmall[9] = {2.81022636e-08f, 3.43273939e-07f,
                               -3.5233877e-06f, -4.39150654e-06f,
                               0.00021858087f,  -0.00125372503f,
                               -0.00417768164f, 0.246640727f,
                               1.50140941f};
  constexpr float kLarge[9] = {-0.000200214257f, 0.000100950558f,
                               0.00134934322f,   -0.00367342844f,
                               0.00573950773f,   -0.0076224613f,
                               0.00943887047f,   1.00167406f,
                               2.83297682f};
  float w = -log1pf(-x * x);
  const bool small = w < 5.0f;
  w = small ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = small ? kSmall[0] : kLarge[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (small ? kSmall[i] : kLarge[i]) + p * w;
  return p * x;
}

__device__ __forceinline__ float normal_of(uint32_t b) {
  constexpr float kLo = -0x1.fffffep-1f;            // nextafter(-1, 0)
  const float f = static_cast<float>(b >> 9) * 0x1p-23f;
  const float u = fmaxf(kLo, f * 2.0f + kLo);
  return 0x1.6a09e6p+0f * erfinv_giles(u);          // float32(sqrt(2))
}

// Flat draw: out[i] for i < n, as raw bits (int32 bit pattern) or normals.
template <bool kBits>
__global__ void __launch_bounds__(kThreads)
threefry_flat_kernel(uint32_t k0, uint32_t k1, void* __restrict__ out,
                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t b = bits32(k0, k1, i);
    if (kBits) {
      static_cast<uint32_t*>(out)[i] = b;
    } else {
      static_cast<float*>(out)[i] = normal_of(b);
    }
  }
}

// Slot draw: block s = b P + p draws out[s, 0:length) under
// fold_in(key, ctr), ctr = (b + offset) span + time_index[b, p] mod 2^32.
template <bool kBits>
__global__ void __launch_bounds__(kThreads)
threefry_slot_kernel(uint32_t k0, uint32_t k1,
                     const long long* __restrict__ time_index,
                     void* __restrict__ out, int P, int length,
                     long long span, long long offset) {
  const long long s = blockIdx.x;
  const long long b = s / P;
  uint32_t c0 = 0;
  uint32_t c1 = static_cast<uint32_t>((b + offset) * span + time_index[s]);
  threefry(k0, k1, c0, c1);                           // fold_in
  const size_t base = static_cast<size_t>(s) * length;
  for (int i = threadIdx.x; i < length; i += kThreads) {
    const uint32_t v = bits32(c0, c1, i);
    if (kBits) {
      static_cast<uint32_t*>(out)[base + i] = v;
    } else {
      static_cast<float*>(out)[base + i] = normal_of(v);
    }
  }
}

}  // namespace

extern "C" int threefry_flat(unsigned int k0, unsigned int k1, void* out,
                             long long n, int want_bits, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  auto st = static_cast<cudaStream_t>(stream);
  if (want_bits) {
    threefry_flat_kernel<true><<<grid, kThreads, 0, st>>>(k0, k1, out, n);
  } else {
    threefry_flat_kernel<false><<<grid, kThreads, 0, st>>>(k0, k1, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_slot(unsigned int k0, unsigned int k1,
                             const void* time_index, void* out, int B, int P,
                             int length, long long span, long long offset,
                             int want_bits, void* stream) {
  const long long slots = static_cast<long long>(B) * P;
  if (B < 1 || P < 1 || length < 1 || slots > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto ti = static_cast<const long long*>(time_index);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(slots);
  if (want_bits) {
    threefry_slot_kernel<true><<<grid, kThreads, 0, st>>>(
        k0, k1, ti, out, P, length, span, offset);
  } else {
    threefry_slot_kernel<false><<<grid, kThreads, 0, st>>>(
        k0, k1, ti, out, P, length, span, offset);
  }
  return static_cast<int>(cudaGetLastError());
}

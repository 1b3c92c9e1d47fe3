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
// Design: one launch per scan, which reads p and x from device memory once
// and writes y once.  The maps s -> p s + x compose associatively,
// (pl, xl) then (pr, xr) = (pl pr, xl pr + xr).  A row is cut into tiles
// of kTile = 1,024 samples, one block of 256 sample threads each, and its
// tiles into groups of kGroup = 32:
//  1. The block takes a ticket from an atomic counter; tickets are handed
//     out in row-major order of the tiles (row, tile).  Every thread loads
//     its 4 consecutive samples of p and x (16-byte loads where the rows
//     are aligned) and keeps them in registers.
//  2. It composes the tile's map: each thread its 4 samples in order, the
//     warp its threads' maps with shuffles (Hillis-Steele), thread 0 the 8
//     warp maps in order through shared memory.  Thread 0 publishes this
//     aggregate in the tile's workspace slot, tagged with the call.
//  3. Meanwhile a ninth warp finds the state entering the tile from
//     published aggregates alone, each set of up to 32 composed in one
//     fixed tree, one map a lane, lane l with lane l + d for d = 1, 2, 4,
//     8, 16 (``tree``): the earlier tiles of the tile's group, and before
//     them the aggregates of every earlier group of the row, 32 at a time,
//     the chunks in order.  A group's aggregate is the tree of its 32
//     tiles' aggregates, published by the ninth warp of its last tile
//     before that warp waits on any group.  So a tile waits on at most 31
//     tiles' slots and one chunk of 32 group slots per 32 earlier groups,
//     and a group's slot waits only on its own tiles' aggregates: no chain
//     of waits runs along the row.  Only aggregates are read, never a
//     running prefix, so the result does not depend on the blocks' timing:
//     two runs give y equal bit for bit.  No wait can deadlock: a tile or
//     group waited on belongs to lower tickets, whose blocks are running
//     or done, and publishing an aggregate waits only on tile aggregates,
//     which never wait.
//  4. Each thread applies the state entering the tile and the maps of the
//     samples before it, runs its 4 samples serially and writes y.
// The workspace (one per device and stream, zeroed once by its owner) holds
// one 64-bit word, the ticket counter beside an epoch, one slot per tile
// and one per whole group.  A block takes its ticket and the call's epoch
// in one atomic add; a slot is this call's when its tag equals that epoch
// + 1.  The block that takes the last ticket resets the counter and
// advances the epoch (every other block of the call has taken its ticket
// by then).  So nothing passed from the host makes the slots valid, and
// the scan stays right when a CUDA graph captures and replays it.  Scans
// sharing one workspace must not run concurrently: one per stream, in
// stream order.  A ticket past the grid (two such scans mixed) traps.
// The products of p over a tile are formed in float32 (complex64), as the
// TPU kernel forms them (pallas_scan.py:74-79).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kGroup = 32;  // tiles a group: one a lane of the look-back warp
constexpr unsigned kAll = 0xffffffffu;

struct Real {
  using V = float;
  __device__ static V one() { return 1.0f; }
  __device__ static V zero() { return 0.0f; }
  __device__ static V mul(V a, V b) { return a * b; }
  __device__ static V fma(V a, V b, V c) { return a * b + c; }  // a b + c
  __device__ static V shfl_up(V v, int d) { return __shfl_up_sync(kAll, v, d); }
  __device__ static V shfl_down(V v, int d) { return __shfl_down_sync(kAll, v, d); }
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
    return make_float2(__shfl_up_sync(kAll, v.x, d), __shfl_up_sync(kAll, v.y, d));
  }
  __device__ static V shfl_down(V v, int d) {
    return make_float2(__shfl_down_sync(kAll, v.x, d),
                       __shfl_down_sync(kAll, v.y, d));
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

// The 32 lanes' maps composed in the fixed tree, lane l with lane l + d for
// d = 1, 2, 4, 8, 16; the whole is lane 0's.
template <class Op>
__device__ inline Map<Op> tree(Map<Op> g, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const Map<Op> o{Op::shfl_down(g.p, d), Op::shfl_down(g.x, d)};
    if ((lane & (2 * d - 1)) == 0) g = compose<Op>(g, o);
  }
  return g;
}

// A tile's aggregate in its workspace slot: each float of it in a 64-bit
// word beside the call's tag, (value, tag), two words for float32 (p, x)
// and four for complex64, stored and loaded 16 bytes at a time.  An
// aligned 64-bit access is single-copy atomic, so a word whose tag is this
// call's holds this call's value: the writer needs no fence and the reader
// no second round trip.
__device__ inline unsigned long long tagged(float v, unsigned tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}

__device__ inline void store_words(float4* w, float a, float b, unsigned tag) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(w), "l"(tagged(a, tag)),
               "l"(tagged(b, tag))
               : "memory");
}

// The two words at ``w``; whether both carry ``tag``.
__device__ inline bool load_words(const float4* w, unsigned tag, float2* v) {
  unsigned long long a, b;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(w) : "memory");
  *v = make_float2(__uint_as_float(static_cast<unsigned>(a)),
                   __uint_as_float(static_cast<unsigned>(b)));
  return static_cast<unsigned>(a >> 32) == tag && static_cast<unsigned>(b >> 32) == tag;
}

__device__ inline void publish(float4* w, const Map<Real>& m, unsigned tag) {
  store_words(w, m.p, m.x, tag);
}
__device__ inline void publish(float4* w, const Map<Complex>& m, unsigned tag) {
  store_words(w, m.p.x, m.p.y, tag);
  store_words(w + 1, m.x.x, m.x.y, tag);
}

// Wait until slot ``w`` holds this call's aggregate, and read it.
__device__ inline void await(const float4* w, unsigned tag, Map<Real>* m) {
  float2 v;
  while (!load_words(w, tag, &v)) {
  }
  *m = {v.x, v.y};
}
__device__ inline void await(const float4* w, unsigned tag, Map<Complex>* m) {
  float2 p, x;
  bool ready;
  do {
    ready = load_words(w, tag, &p);
    ready = load_words(w + 1, tag, &x) && ready;
  } while (!ready);
  *m = {p, x};
}

// 16 bytes of consecutive values, as values and as one vector.
__device__ inline void unvec(float4 v, float* d) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ inline void unvec(float4 v, float2* d) {
  d[0] = make_float2(v.x, v.y);
  d[1] = make_float2(v.z, v.w);
}
__device__ inline float4 vec4(const float* d) { return make_float4(d[0], d[1], d[2], d[3]); }
__device__ inline float4 vec4(const float2* d) {
  return make_float4(d[0].x, d[0].y, d[1].x, d[1].y);
}

struct Header {
  // The next ticket in the low 32 bits, the epoch (calls so far, modulo
  // 2^32 - 1) in the high 32: one atomic add takes a ticket and reads the
  // epoch it belongs to.
  unsigned long long next;
  unsigned long long pad;
};

// Load kPerThread values at ``src``, as 16-byte vectors (``vec``) or one by
// one, those at or past ``left`` as ``fill``.
template <class Op>
__device__ inline void load_run(const typename Op::V* __restrict__ src, long long left,
                                bool vec, typename Op::V fill, typename Op::V (&dst)[kPerThread]) {
  using V = typename Op::V;
  constexpr int kPerVec = 16 / sizeof(V);
  if (vec && left >= kPerThread) {
#pragma unroll
    for (int q = 0; q < kPerThread / kPerVec; ++q)
      unvec(__ldg(reinterpret_cast<const float4*>(src) + q), dst + q * kPerVec);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) dst[k] = k < left ? __ldg(src + k) : fill;
  }
}

// Barrier ``id`` of ``kCount`` threads (bar.sync: the warps that take part
// arrive at it wherever they are).
template <int kCount>
__device__ inline void barrier(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kCount) : "memory");
}

// Blocks of kThreads sample threads and one look-back warp.  ``slots``
// holds the tiles' slots, ``groups`` the whole groups' (n_tiles / kGroup a
// row).
template <class Op>
__global__ void __launch_bounds__(kThreads + 32)
scan_kernel(const typename Op::V* __restrict__ p, const typename Op::V* __restrict__ x,
            typename Op::V* __restrict__ y, long long T, unsigned n_tiles, bool vec,
            Header* hdr, float4* slots, float4* groups) {
  using V = typename Op::V;
  __shared__ Map<Op> warp_maps[kWarps];
  __shared__ unsigned s_ticket, s_tag;
  __shared__ V s_in;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    const unsigned long long word = atomicAdd(&hdr->next, 1ull);
    const unsigned ticket = static_cast<unsigned>(word);
    const unsigned epoch = static_cast<unsigned>(word >> 32);
    if (ticket >= gridDim.x) __trap();
    s_ticket = ticket;
    s_tag = epoch + 1u;
    // The last ticket: every block of this call has its ticket and epoch,
    // so the workspace can be readied for the next call.
    if (ticket == gridDim.x - 1)
      *reinterpret_cast<volatile unsigned long long*>(&hdr->next) =
          static_cast<unsigned long long>(epoch + 1u == 0xffffffffu ? 0u : epoch + 1u) << 32;
  }
  __syncthreads();
  const unsigned ticket = s_ticket, tag = s_tag;
  const unsigned row = ticket / n_tiles;
  const unsigned tile = ticket - row * n_tiles;

  if (warp == kWarps) {
    // 3. The look-back warp: the state entering the tile, from aggregates
    // alone, while the other warps load and compose.
    const unsigned group = tile / kGroup, in_group = tile % kGroup;
    const unsigned member = lane;              // this lane's tile of the group
    const bool last = in_group == kGroup - 1;  // publishes the group's aggregate
    Map<Op> a = identity<Op>();
    if (member < in_group || (last && member == in_group))
      await(slots + 2 * static_cast<size_t>(ticket - in_group + member), tag, &a);
    const Map<Op> tiles_before = tree<Op>(member < in_group ? a : identity<Op>(), lane);
    const size_t row_groups = static_cast<size_t>(row) * (n_tiles / kGroup);
    if (last) {
      const Map<Op> whole = tree<Op>(a, lane);
      if (lane == 0) publish(groups + 2 * (row_groups + group), whole, tag);
    }
    Map<Op> prefix = tiles_before;
    if (group > 0) {
      Map<Op> earlier = identity<Op>();
      for (unsigned c = 0; c < group; c += 32) {
        Map<Op> g = identity<Op>();
        if (c + member < group) await(groups + 2 * (row_groups + c + member), tag, &g);
        g = tree<Op>(g, lane);
        earlier = c == 0 ? g : compose<Op>(earlier, g);
      }
      prefix = compose<Op>(earlier, tiles_before);
    }
    if (lane == 0) s_in = tile == 0 ? Op::zero() : prefix.x;
    barrier<kThreads + 32>(2);
    return;
  }

  const long long t0 = static_cast<long long>(tile) * kTile + threadIdx.x * kPerThread;
  const long long at = static_cast<long long>(row) * T + t0;

  // 1. This thread's samples, read once.
  V pk[kPerThread], xk[kPerThread];
  load_run<Op>(p + at, T - t0, vec, Op::one(), pk);
  load_run<Op>(x + at, T - t0, vec, Op::zero(), xk);

  // 2. The tile's map, published by thread 0 once the sample warps have
  // theirs (a barrier of theirs alone: the publication never waits on
  // the look-back, so no block's waits chain through another's).
  Map<Op> m{pk[0], xk[0]};
#pragma unroll
  for (int k = 1; k < kPerThread; ++k) m = compose<Op>(m, Map<Op>{pk[k], xk[k]});
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const Map<Op> o{Op::shfl_up(m.p, d), Op::shfl_up(m.x, d)};
    if (lane >= d) m = compose<Op>(o, m);
  }
  if (lane == 31) warp_maps[warp] = m;
  Map<Op> before{Op::shfl_up(m.p, 1), Op::shfl_up(m.x, 1)};
  if (lane == 0) before = identity<Op>();
  barrier<kThreads>(1);
  if (threadIdx.x == 0) {
    Map<Op> total = warp_maps[0];
    for (int w = 1; w < kWarps; ++w) total = compose<Op>(total, warp_maps[w]);
    publish(slots + 2 * static_cast<size_t>(ticket), total, tag);
  }
  barrier<kThreads + 32>(2);  // s_in from the look-back warp

  // 4. Apply it and the maps of the samples before this thread's.
  Map<Op> pre = identity<Op>();
  for (int w = 0; w < warp; ++w) pre = compose<Op>(pre, warp_maps[w]);
  pre = compose<Op>(pre, before);
  V s = Op::fma(s_in, pre.p, pre.x);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    s = Op::fma(s, pk[k], xk[k]);
    pk[k] = s;
  }
  V* out = y + at;
  const long long left = T - t0;
  if (vec && left >= kPerThread) {
    constexpr int kPerVec = 16 / sizeof(V);
#pragma unroll
    for (int q = 0; q < kPerThread / kPerVec; ++q)
      reinterpret_cast<float4*>(out)[q] = vec4(pk + q * kPerVec);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (k < left) out[k] = pk[k];
  }
}

// A workspace for ``tiles`` tiles: the header, then a slot per tile, then
// one per whole group (at most tiles / kGroup over all rows).
long long workspace_bytes(long long tiles) {
  return static_cast<long long>(sizeof(Header)) + (tiles + tiles / kGroup) * 2 * sizeof(float4);
}

template <class Op>
int scan(const void* p, const void* x, void* y, void* workspace, long long capacity,
         long long R, long long T, cudaStream_t stream) {
  using V = typename Op::V;
  if (R < 0 || T < 0 || capacity < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || T == 0) return 0;
  const long long tiles = R * ((T + kTile - 1) / kTile);
  if (tiles > capacity || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<std::uintptr_t>(p) | reinterpret_cast<std::uintptr_t>(x) |
                     reinterpret_cast<std::uintptr_t>(y)) % 16 == 0) &&
                   (T * static_cast<long long>(sizeof(V))) % 16 == 0;
  auto* hdr = static_cast<Header*>(workspace);
  auto* slots = reinterpret_cast<float4*>(hdr + 1);
  scan_kernel<Op><<<static_cast<unsigned>(tiles), kThreads + 32, 0, stream>>>(
      static_cast<const V*>(p), static_cast<const V*>(x), static_cast<V*>(y), T,
      static_cast<unsigned>((T + kTile - 1) / kTile), vec, hdr, slots, slots + 2 * capacity);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of a workspace with slots for ``tiles`` tiles; it must be zeroed
// once before its first use.
extern "C" long long first_order_scan_workspace_bytes(long long tiles) {
  return workspace_bytes(tiles);
}

extern "C" int first_order_scan_f32(const void* p, const void* x, void* y, void* workspace,
                                    long long capacity, long long R, long long T,
                                    void* stream) {
  return scan<Real>(p, x, y, workspace, capacity, R, T, static_cast<cudaStream_t>(stream));
}

extern "C" int first_order_scan_c64(const void* p, const void* x, void* y, void* workspace,
                                    long long capacity, long long R, long long T,
                                    void* stream) {
  return scan<Complex>(p, x, y, workspace, capacity, R, T, static_cast<cudaStream_t>(stream));
}

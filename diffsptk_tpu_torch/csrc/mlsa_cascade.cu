// One stage of the tap-chunked Taylor MLSA cascade, for sm_90a.
//
// Replaces: diffsptk_tpu/kernels/pallas_mlsa.py:_chunked_kernel_b3 and
// _chunked_kernel (reached through _cascade_pallas_chunked / taylor_cascade).
//
// Computes stage s of kernels/mlsa_cascade.py:taylor_cascade_folded's
// chunked branch on the (B, N, P) frame grid:
//   X[e]  = sum_r xpad[e + r] @ F[r]                  (n_blk plan blocks)
//   Y[n]  = sum_j X[n + Q-1-j] * C[n, j]               (complex, Q chunks)
//   V[n]  = Yre[n] @ Gre + Yim[n] @ Gim                (K, 3P) inverse plans
//   out[n] = V[n, :P] + (n < N-1 ? V[n+1, P:2P] : V[n, 2P:3P])
//   xout = w_s * out;  y = (s == 1 ? a_0 x : y) + a_s xout
// xpad is the state with r0+Q-1 zero rows before and n_blk-1-r0 after
// each batch row.
//
// Bound on this card: operations.  The least work of a stage is a 200-tap
// FIR per frame, blended between the filters of frames n and n+1: as an
// FFT convolution one real transform of the frame's P+M = 279 inputs and
// two inverse ones (2.5 L log2 L flops each), two complex products and
// the blend, about 19 kflop per frame (directly, 2 (M+1) 2 flops per
// sample, 64 kflop).  At the flagship (B = 32, N = 240, M = 199, 20
// stages) that is 2.9 GFLOP per call, 0.044 ms at 67 TFLOP/s, against
// 11 MB of x, y and c.
// This kernel's DFT-plan method does more: per frame and stage the forward
// plans take 2 n_blk P 2K flops, the inverse 2 (2K) 2P and the chunk
// products 8 Q K, about 208 kflop at P = 80, K = 128, n_blk = 3, Q = 3.
//
// Design: one launch per stage.  Stage s+1 of frame n reads stage s of
// frames n-r0-Q+1 .. n+n_blk-r0, so a block cannot run ahead of its
// neighbours; the (B, N, P) state ping-pongs between two buffers in device
// memory (2.4 MB at the flagship, so it stays in the 50 MB L2 between
// launches).  A block owns TF = kRows - Q output frames of one batch row.
// It loads the state rows it needs, halo included, into shared memory
// (zero outside the row: batch rows are independent, so no gap rows), then
// computes its kRows X rows, its TF+1 Y rows and the V rows in turn.  The
// two plan products are the bulk of the work.  In each, a thread keeps a
// 9-row x 4-column tile of the result in registers: one shared-memory
// float4 feeds 16 FMAs, and a plan float4 read from L2 feeds 36.  Reading a
// shared operand per FMA group would make shared-memory traffic, not the
// FMAs, the limit.  A warp covers 8 column groups x 4 row groups (padded
// row strides put the 4 rows on distinct banks), so threads left without
// columns form whole idle warps.  The last frame of a row blends with its
// own edge block (V[N-1, 2P:3P]); only the tile that holds it computes
// those columns.  All arithmetic is fp32.
//
// Built with -DMLSA_ABLATE_FORWARD or -DMLSA_ABLATE_INVERSE, a stage leaves
// out its forward or inverse plan product: the values are wrong, and only
// the time of what remains counts (tools/torch_cascade_ablation.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 36;         // X rows per tile: TF output frames + Q
constexpr int kRowGroups = 4;     // thread tile: kTileRows rows x 4 columns
constexpr int kTileRows = kRows / kRowGroups;
constexpr int kColGroups = kThreads / kRowGroups;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int up4(int v) { return (v + 3) & ~3; }

// Shared-memory layout of one block, in floats.  Row strides are padded so
// that the 4 row groups of a warp (rows kTileRows apart) fall on distinct
// banks.
struct Layout {
  int PS, VS, YS, NS, NV, xs, x, y, floats;
};

__host__ __device__ inline Layout layout(int P, int K, int Q, int n_blk) {
  Layout l;
  l.PS = up4(P) + 4;        // state row stride (zero past P)
  l.VS = up4(3 * P);        // V row stride
  l.YS = 2 * K + 4;         // Y row stride
  l.NS = kRows + n_blk - 1;
  l.NV = kRows - Q + 1;
  const int xcap = kRows * 2 * K > kRows * l.VS ? kRows * 2 * K : kRows * l.VS;
  l.xs = 0;
  l.x = l.NS * l.PS;
  l.y = l.x + xcap;
  l.floats = l.y + kRows * l.YS;
  return l;
}

__global__ void __launch_bounds__(kThreads, 2)
stage_kernel(const float* __restrict__ xin, const float* __restrict__ x0,
             float* __restrict__ xout, float* __restrict__ y,
             const float* __restrict__ cre, const float* __restrict__ cim,
             const float* __restrict__ F, const float* __restrict__ Gre,
             const float* __restrict__ Gim, const float* __restrict__ wa,
             int N, int P, int K, int Q, int n_blk, int r0, int S, int s) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout(P, K, Q, n_blk);
  const int TF = kRows - Q;
  const int NV = l.NV;
  const int K2 = 2 * K, P3 = 3 * P;
  const int PS = l.PS, VS = l.VS, YS = l.YS;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TF;
  const int tid = threadIdx.x;
  // A warp covers 8 column groups x 4 row groups.
  const int rg = tid % kRowGroups;
  const int cg = tid / kRowGroups;
  const int i0 = rg * kTileRows;
  float* xs = smem + l.xs;  // (NS, PS) state rows n0-r0-Q+1 ...
  float* X = smem + l.x;    // (kRows, 2K), then V (kRows, VS)
  float* Y = smem + l.y;    // (kRows, YS); rows NV.. are zero

  // 1. State rows of the tile, halo included, zero outside the batch row.
  const float* xb = xin + static_cast<size_t>(b) * N * P;
  const int row0 = n0 - (r0 + Q - 1);
  for (int idx = tid; idx < l.NS * PS; idx += kThreads) {
    const int i = idx / PS;
    const int p = idx - i * PS;
    const int row = row0 + i;
    xs[idx] = (p < P && row >= 0 && row < N) ? xb[static_cast<size_t>(row) * P + p] : 0.f;
  }
  __syncthreads();

  // 2. Forward plans: X[i] = sum_r xs[i + r] @ F[r]; X row i is frame row
  //    n0 + i of the extended grid.  Thread tile: rows i0.., columns c0..c0+3.
#ifndef MLSA_ABLATE_FORWARD
  for (int c0 = 4 * cg; c0 < K2; c0 += 4 * kColGroups) {
    float acc[kTileRows][4];
#pragma unroll
    for (int ii = 0; ii < kTileRows; ++ii) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ii][q] = 0.f;
    }
    for (int r = 0; r < n_blk; ++r) {
      const float* Fr = F + static_cast<size_t>(r) * P * K2 + c0;
      const float* xr = xs + (i0 + r) * PS;
      for (int p = 0; p < P; p += 4) {
        float f[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p + u < P) v = __ldg(reinterpret_cast<const float4*>(Fr + static_cast<size_t>(p + u) * K2));
          f[u][0] = v.x;
          f[u][1] = v.y;
          f[u][2] = v.z;
          f[u][3] = v.w;
        }
#pragma unroll
        for (int ii = 0; ii < kTileRows; ++ii) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + ii * PS + p);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float t = acc[ii][q];
            t = fmaf(xv.x, f[0][q], t);
            t = fmaf(xv.y, f[1][q], t);
            t = fmaf(xv.z, f[2][q], t);
            t = fmaf(xv.w, f[3][q], t);
            acc[ii][q] = t;
          }
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kTileRows; ++ii) {
      *reinterpret_cast<float4*>(X + (i0 + ii) * K2 + c0) =
          make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
    }
  }
#endif
  __syncthreads();

  // 3. Chunk products: Y[v] = sum_j X[v + Q-1-j] * C[n0 + v, j].
  const size_t crow = static_cast<size_t>(b) * N;
  for (int idx = tid; idx < kRows * K; idx += kThreads) {
    const int v = idx / K;
    const int k = idx - v * K;
    const int n = n0 + v;
    float yr = 0.f, yi = 0.f;
    if (v < NV && n < N) {
      for (int j = 0; j < Q; ++j) {
        const float* Xe = X + (v + Q - 1 - j) * K2;
        const float xr = Xe[k], xi = Xe[K + k];
        const size_t ci = ((crow + n) * Q + j) * K + k;
        const float cr = __ldg(cre + ci), cm = __ldg(cim + ci);
        yr += xr * cr - xi * cm;
        yi += xr * cm + xi * cr;
      }
    }
    Y[v * YS + k] = yr;
    Y[v * YS + K + k] = yi;
  }
  __syncthreads();

  // 4. Inverse plans with the blend folded in: V[v] = Yre Gre + Yim Gim,
  //    written over X (every read of X ended at the barrier above).
  //    Columns [2P, 3P) (the last frame's edge block) only where needed.
  float* V = X;
#ifndef MLSA_ABLATE_INVERSE
  const int ncol = (n0 + TF >= N) ? P3 : 2 * P;
  for (int c0 = 4 * cg; c0 < ncol; c0 += 4 * kColGroups) {
    float acc[kTileRows][4];
#pragma unroll
    for (int ii = 0; ii < kTileRows; ++ii) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ii][q] = 0.f;
    }
    for (int k = 0; k < K; k += 4) {
      float gr[4][4], gi[4][4];
      if (P3 % 4 == 0) {  // rows of G are float4-aligned
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const size_t g = static_cast<size_t>(k + u) * P3 + c0;
          const float4 vr = __ldg(reinterpret_cast<const float4*>(Gre + g));
          const float4 vi = __ldg(reinterpret_cast<const float4*>(Gim + g));
          gr[u][0] = vr.x;
          gr[u][1] = vr.y;
          gr[u][2] = vr.z;
          gr[u][3] = vr.w;
          gi[u][0] = vi.x;
          gi[u][1] = vi.y;
          gi[u][2] = vi.z;
          gi[u][3] = vi.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const size_t g = static_cast<size_t>(k + u) * P3 + c0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool in = c0 + q < ncol;
            gr[u][q] = in ? __ldg(Gre + g + q) : 0.f;
            gi[u][q] = in ? __ldg(Gim + g + q) : 0.f;
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kTileRows; ++ii) {
        const float4 a = *reinterpret_cast<const float4*>(Y + (i0 + ii) * YS + k);
        const float4 m = *reinterpret_cast<const float4*>(Y + (i0 + ii) * YS + K + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float t = acc[ii][q];
          t = fmaf(a.x, gr[0][q], t);
          t = fmaf(a.y, gr[1][q], t);
          t = fmaf(a.z, gr[2][q], t);
          t = fmaf(a.w, gr[3][q], t);
          t = fmaf(m.x, gi[0][q], t);
          t = fmaf(m.y, gi[1][q], t);
          t = fmaf(m.z, gi[2][q], t);
          t = fmaf(m.w, gi[3][q], t);
          acc[ii][q] = t;
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kTileRows; ++ii) {
      *reinterpret_cast<float4*>(V + (i0 + ii) * VS + c0) =
          make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
    }
  }
#endif
  __syncthreads();

  // 5. Row-shift blend, stage weight, Taylor accumulation.
  const float w_s = wa[s];
  const float a_0 = wa[S + 1];
  const float a_s = wa[S + 1 + s];
  for (int idx = tid; idx < TF * P; idx += kThreads) {
    const int v = idx / P;
    const int p = idx - v * P;
    const int n = n0 + v;
    if (n >= N) continue;
    const float lo = V[v * VS + p];
    const float hi = (n < N - 1) ? V[(v + 1) * VS + P + p] : V[v * VS + 2 * P + p];
    const float val = (lo + hi) * w_s;
    const size_t o = (crow + n) * P + p;
    xout[o] = val;
    const float prev = (s == 1) ? a_0 * x0[o] : y[o];
    y[o] = prev + a_s * val;
  }
}

}  // namespace

extern "C" int mlsa_cascade_smem_bytes(int P, int K, int Q, int n_blk) {
  return layout(P, K, Q, n_blk).floats * static_cast<int>(sizeof(float));
}

extern "C" int mlsa_cascade_stage_f32(
    const void* xin, const void* x0, void* xout, void* y, const void* cre,
    const void* cim, const void* F, const void* Gre, const void* Gim,
    const void* wa, int B, int N, int P, int K, int Q, int n_blk, int r0,
    int S, int s, void* stream) {
  if (B < 1 || N < 1 || P < 1 || K < 4 || K % 4 != 0 || Q < 1 || Q >= kRows ||
      n_blk < 1 || r0 < 0 || s < 1 || s > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = mlsa_cascade_smem_bytes(P, K, Q, n_blk);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB dynamic shared memory needs the opt-in attribute, set
  // once to the most a block may use.
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const int TF = kRows - Q;
  const dim3 grid((N + TF - 1) / TF, B);
  stage_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xin), static_cast<const float*>(x0),
      static_cast<float*>(xout), static_cast<float*>(y),
      static_cast<const float*>(cre), static_cast<const float*>(cim),
      static_cast<const float*>(F), static_cast<const float*>(Gre),
      static_cast<const float*>(Gim), static_cast<const float*>(wa), N, P, K,
      Q, n_blk, r0, S, s);
  return static_cast<int>(cudaGetLastError());
}

// The frontend's band-operator products (ops/scale_space.py::mxu_dot):
// L @ X for a left operator (the stacked cascades LL, the window row-sum
// S5H, the y ramp YH) and X @ R for a right one (the cascades R0 and R1, the
// x ramp XW, the window column-sum S5W), visiting only the band.
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// as dense matrix products (rebvio_tpu/ops/scale_space.py, edge_detect.py).
// The operators are 0.5-4.5 % dense (box cascades of 19 and 25 taps, 5-tap
// window sums, 4 non-zero taps in each ramp), so a dense SGEMM does ~50x the
// work the band needs, and under vmap it ran as one SGEMM a lane.
//
// Summation order: that of the library's float32 SIMT SGEMM at the
// product's shape, so that for finite inputs the result is the dense
// product's bit for bit.  On the H100 that SGEMM deals the k axis out in
// 8-deep blocks (aligned to k = 0) round-robin to S partial sums (split-K:
// S = 4 or 2 at the parity shapes), each one chain of fused multiply-adds
// over its k ascending from +0.0, and adds the partials in order at the end,
// ((p0 + p1) + p2) + p3.  Here an output keeps the same S chains over its
// band's k, read from `splits` (ops/kernels.py::band_library_splits picks S
// once a product shape, at set-up: the least S whose result equals the
// library's on a random operand).  The k outside the band only add products that are
// exact zeros, which leave a chain started at +0.0 unchanged.  The library
// is built with --fmad=false, which keeps a written a * b + c as a rounded
// multiply and a rounded add; the explicit intrinsics keep the fused form
// with its single rounding.  The order does not depend on the lane count: a
// lane of a batched launch is the unbatched launch bit for bit.
//
// Bound on the H100: bytes.  At 480x752 the seven products of a detection
// read each input once and write each output once, 33.2 MB a lane (~0.0099
// ms at 3.35 TB/s), for ~91 MFLOP of band work: under 3 operations a byte.
//
// Design: one block an output tile of kLines band lines (rows of L @ X,
// columns of X @ R) by kFree free indices (columns of L @ X, rows of X @ R).
// ops/kernels.py::band_tiles cuts the lines into runs whose k ranges span at
// most kLines + taps - 1 and gives each run its first k; the block stages
// that span of X in shared memory with loads along X's contiguous axis (zero
// past X's edges), and its lines' coefficients and first k beside it.  Left:
// a thread takes 4 adjacent columns of two lines, a float4 shared read and a
// broadcast coefficient a tap.  Right: a warp takes 32 adjacent output
// columns (adjacent shared addresses inside the band), a thread 8 rows with
// its line's coefficient in a register across them.  Grid: tiles x free
// blocks x lanes; X carries a lane stride, the band is shared by every lane.

#include <cuda_runtime.h>

namespace {

constexpr int kLines = 32;     // band lines a block (ops/kernels.py BAND_TILE_LINES)
constexpr int kFree = 64;      // free indices a block
constexpr int kThreads = 256;

struct Tile {
  int line0, lines, kbase;
};

__device__ __forceinline__ Tile tile_of(const int* __restrict__ tiles) {
  const int* t = tiles + 3 * blockIdx.x;
  return {t[0], t[1], t[2]};
}

// The k-blocks of partial sum s among a line's blocks jfirst .. jlast: the
// first, j == s (mod splits); then every splits-th.
__device__ __forceinline__ int first_block(int jfirst, int s, int splits) {
  return jfirst + ((s - jfirst % splits) + splits) % splits;
}

// out[b, line, q] = sum over t of coef[line, t] * x[b, k0[line] + t, q]
__global__ void __launch_bounds__(kThreads)
band_matmul_left_kernel(const float* __restrict__ x, long long lane_stride,
                        const int* __restrict__ k0, const float* __restrict__ coef,
                        const int* __restrict__ tiles, const int* __restrict__ splits_of,
                        float* __restrict__ out, int K, int Q, int n_lines, int taps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ks[kLines];
  const int span = kLines + taps - 1;
  const int splits = *splits_of;
  float* xs = smem;                  // [span][kFree]: x rows kbase.., columns q0..
  float* cs = xs + span * kFree;     // [kLines][taps]
  const Tile tl = tile_of(tiles);
  const int q0 = blockIdx.y * kFree;
  const float* xb = x + blockIdx.z * lane_stride;
  const int tid = threadIdx.x;
  for (int e = tid; e < span * kFree; e += kThreads) {
    const int k = tl.kbase + e / kFree, q = q0 + e % kFree;
    xs[e] = (k < K && q < Q) ? xb[(size_t)k * Q + q] : 0.0f;
  }
  for (int e = tid; e < tl.lines * taps; e += kThreads)
    cs[e] = coef[(size_t)tl.line0 * taps + e];
  if (tid < tl.lines) ks[tid] = k0[tl.line0 + tid] - tl.kbase;
  __syncthreads();

  const int c = (tid % 16) * 4;
  const int q = q0 + c;
  float* ob = out + (size_t)blockIdx.z * n_lines * Q;
  for (int l = tid / 16; l < tl.lines; l += kThreads / 16) {
    const float* xl = xs + ks[l] * kFree + c;
    const float* cl = cs + l * taps;
    const int k0l = tl.kbase + ks[l];
    const int jfirst = k0l >> 3, jlast = (k0l + taps - 1) >> 3;
    float4 acc;
    for (int s = 0; s < splits; ++s) {
      float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = first_block(jfirst, s, splits); j <= jlast; j += splits) {
        const int t1 = min(taps, 8 * j + 8 - k0l);
        for (int t = max(0, 8 * j - k0l); t < t1; ++t) {
          const float w = cl[t];
          const float4 v = *reinterpret_cast<const float4*>(xl + t * kFree);
          part.x = __fmaf_rn(w, v.x, part.x);
          part.y = __fmaf_rn(w, v.y, part.y);
          part.z = __fmaf_rn(w, v.z, part.z);
          part.w = __fmaf_rn(w, v.w, part.w);
        }
      }
      if (s == 0) {
        acc = part;
      } else {
        acc.x = __fadd_rn(acc.x, part.x);
        acc.y = __fadd_rn(acc.y, part.y);
        acc.z = __fadd_rn(acc.z, part.z);
        acc.w = __fadd_rn(acc.w, part.w);
      }
    }
    float* o = ob + (size_t)(tl.line0 + l) * Q + q;
    if ((Q & 3) == 0 && q + 3 < Q) {
      *reinterpret_cast<float4*>(o) = acc;
    } else {
      if (q < Q) o[0] = acc.x;
      if (q + 1 < Q) o[1] = acc.y;
      if (q + 2 < Q) o[2] = acc.z;
      if (q + 3 < Q) o[3] = acc.w;
    }
  }
}

constexpr int kRowStep = kThreads / kLines;     // 8 warps, each a row phase
constexpr int kRows = kFree / kRowStep;         // 8 rows a thread

// out[b, q, line] = sum over t of x[b, q, k0[line] + t] * coef[line, t]
__global__ void __launch_bounds__(kThreads)
band_matmul_right_kernel(const float* __restrict__ x, long long lane_stride,
                         const int* __restrict__ k0, const float* __restrict__ coef,
                         const int* __restrict__ tiles, const int* __restrict__ splits_of,
                         float* __restrict__ out, int K, int Q, int n_lines, int taps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ks[kLines];
  const int span = kLines + taps - 1;
  const int splits = *splits_of;
  float* xs = smem;                  // [kFree][span]: x rows q0.., columns kbase..
  float* cs = xs + kFree * span;     // [taps][kLines]
  const Tile tl = tile_of(tiles);
  const int q0 = blockIdx.y * kFree;
  const float* xb = x + blockIdx.z * lane_stride;
  const int tid = threadIdx.x;
  for (int e = tid; e < kFree * span; e += kThreads) {
    const int q = q0 + e / span, k = tl.kbase + e % span;
    xs[e] = (q < Q && k < K) ? xb[(size_t)q * K + k] : 0.0f;
  }
  for (int e = tid; e < tl.lines * taps; e += kThreads)
    cs[(e % taps) * kLines + e / taps] = coef[(size_t)tl.line0 * taps + e];
  if (tid < tl.lines) ks[tid] = k0[tl.line0 + tid] - tl.kbase;
  __syncthreads();

  const int l = tid % kLines, r0 = tid / kLines;
  if (l >= tl.lines) return;
  const float* xl = xs + r0 * span + ks[l];
  const int k0l = tl.kbase + ks[l];
  const int jfirst = k0l >> 3, jlast = (k0l + taps - 1) >> 3;
  float acc[kRows], part[kRows];
  for (int s = 0; s < splits; ++s) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
    for (int j = first_block(jfirst, s, splits); j <= jlast; j += splits) {
      const int t1 = min(taps, 8 * j + 8 - k0l);
      for (int t = max(0, 8 * j - k0l); t < t1; ++t) {
        const float w = cs[t * kLines + l];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          part[r] = __fmaf_rn(xl[r * kRowStep * span + t], w, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = s == 0 ? part[r] : __fadd_rn(acc[r], part[r]);
  }
  float* ob = out + (size_t)blockIdx.z * Q * n_lines + tl.line0 + l;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int q = q0 + r0 + r * kRowStep;
    if (q < Q) ob[(size_t)q * n_lines] = acc[r];
  }
}

}  // namespace

// One launch over `lanes` lanes of x (lane b at x + b * lane_stride, each
// lane row-major: [K, Q] for a left operator, [Q, K] for a right one) into
// out ([lanes, n_lines, Q] or [lanes, Q, n_lines]); the band: k0 [n_lines],
// coef [n_lines, taps], tiles [n_tiles, 3] (first line, lines, first k),
// splits [1] (the partial sums S >= 1, read on the device).
extern "C" int rk_band_matmul(const float* x, long long lane_stride, const int* k0,
                              const float* coef, const int* tiles, int n_tiles,
                              const int* splits, float* out, int lanes, int K, int Q,
                              int n_lines, int taps, int left, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t smem =
      ((size_t)(kLines + taps - 1) * kFree + (size_t)kLines * taps) * sizeof(float);
  if (n_tiles < 1 || lanes < 1 || lanes > 65535 || taps < 1 || taps > K || Q < 1 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, (Q + kFree - 1) / kFree, lanes);
  if (left) {
    band_matmul_left_kernel<<<grid, kThreads, smem, stream>>>(
        x, lane_stride, k0, coef, tiles, splits, out, K, Q, n_lines, taps);
  } else {
    band_matmul_right_kernel<<<grid, kThreads, smem, stream>>>(
        x, lane_stride, k0, coef, tiles, splits, out, K, Q, n_lines, taps);
  }
  return (int)cudaGetLastError();
}

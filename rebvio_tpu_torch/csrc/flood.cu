// K1: jump flood of the nearest-keyline attribute field.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::_att_flood (the flood over the
// row-stacked seed regions built by distance_field.seed_stack_dense).
//
// Bound on the H100: bytes.  At the parity geometry (field 240x376, field
// search range 20 -> steps 16, 8, 4, 2, 1, 1) the least traffic is one
// read of the [5*(rows+PAD), cols] f32 seed stack (1.9 MB) and one write
// of the [8, rows*cols] f32 field (2.9 MB): ~1.4 us at 3.35 TB/s, below
// the launch latency of the 6 step kernels + 1 finishing kernel this
// design issues (and their 6 full passes over the stack).
//
// Design: one thread per field cell, one launch per jump step, ping-pong
// between two copies of the stack in device memory (both start as the seed
// stack, so the sentinel pad rows never need writing).  Each step reads the
// 8 candidates from the input copy and writes the winner's five region
// values to the output copy.  The semantics are _att_flood's exactly:
//   * candidate (dy, dx) reads cell (y - dy, x - dx) of the WHOLE stack
//     (pltpu.roll == jnp.roll): rows wrap modulo 5*(rows+PAD), so a data
//     row near the top of a region reads the previous region's pad rows;
//     columns wrap modulo cols;
//   * candidates in the order dy outer, dx inner over (-s, 0, s), (0,0)
//     skipped, accepted only if strictly closer than the running best,
//     which starts at the cell's own d2;
//   * d2 = (y - sy)^2 + (x - sx)^2 in f32 with round-to-nearest intrinsics
//     and no FMA contraction, so ties resolve as in the reference.
// The last kernel writes the 8 output planes with the in-range mask.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float dist2(float y, float x, float sy, float sx) {
  float a = __fsub_rn(y, sy);
  float b = __fsub_rn(x, sx);
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

__global__ void flood_step(const float* __restrict__ in, float* __restrict__ out,
                           int rows, int cols, int Rp, int s) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  if (x >= cols || y >= rows) return;
  const int SR = 5 * Rp;
  const float yf = (float)y, xf = (float)x;
  float best = dist2(yf, xf, in[y * cols + x], in[(Rp + y) * cols + x]);
  int by = 0, bx = 0;
  bool found = false;
  for (int iy = -1; iy <= 1; ++iy) {
    const int dy = iy * s;
    for (int ix = -1; ix <= 1; ++ix) {
      const int dx = ix * s;
      if (dy == 0 && dx == 0) continue;
      const int c = wrap(x - dx, cols);
      const float csy = in[wrap(y - dy, SR) * cols + c];
      const float csx = in[wrap(Rp + y - dy, SR) * cols + c];
      const float cd2 = dist2(yf, xf, csy, csx);
      if (cd2 < best) {
        best = cd2;
        by = dy;
        bx = dx;
        found = true;
      }
    }
  }
  const int c = found ? wrap(x - bx, cols) : x;
  for (int r = 0; r < 5; ++r) {
    const int src = found ? wrap(r * Rp + y - by, SR) : r * Rp + y;
    out[(r * Rp + y) * cols + x] = in[src * cols + c];
  }
}

__global__ void flood_finish(const float* __restrict__ st, float* __restrict__ out,
                             int rows, int cols, int Rp, float r2, float scale) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  if (x >= cols || y >= rows) return;
  const int n = rows * cols;
  const int i = y * cols + x;
  const float sy = st[y * cols + x];
  const float sx = st[(Rp + y) * cols + x];
  const float id = st[(2 * Rp + y) * cols + x];
  const float gx = st[(3 * Rp + y) * cols + x];
  const float gy = st[(4 * Rp + y) * cols + x];
  const float d2 = dist2((float)y, (float)x, sy, sx);
  out[i] = 0.0f;
  out[n + i] = d2;
  out[2 * n + i] = (d2 <= r2) ? id : -1.0f;
  out[3 * n + i] = gx;
  out[4 * n + i] = gy;
  out[5 * n + i] = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  out[6 * n + i] = __fmul_rn(sx, scale);
  out[7 * n + i] = __fmul_rn(sy, scale);
}

}  // namespace

extern "C" int rk_att_flood(const float* stack, float* buf_a, float* buf_b, float* out,
                            int rows, int cols, int pad, int search_range, float scale,
                            void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int Rp = rows + pad;
  const size_t bytes = (size_t)5 * Rp * cols * sizeof(float);
  cudaMemcpyAsync(buf_a, stack, bytes, cudaMemcpyDeviceToDevice, stream);
  cudaMemcpyAsync(buf_b, stack, bytes, cudaMemcpyDeviceToDevice, stream);
  dim3 block(128);
  dim3 grid((cols + 127) / 128, rows);
  int s = 1;
  while (2 * s < search_range) s *= 2;
  float* src = buf_a;
  float* dst = buf_b;
  for (bool extra = false;; ) {
    flood_step<<<grid, block, 0, stream>>>(src, dst, rows, cols, Rp, s);
    float* t = src; src = dst; dst = t;
    if (s > 1) {
      s /= 2;
    } else if (!extra) {
      extra = true;  // the extra refinement pass at step 1 (JFA+1)
    } else {
      break;
    }
  }
  flood_finish<<<grid, block, 0, stream>>>(src, out, rows, cols, Rp,
                                           (float)(search_range * search_range), scale);
  return (int)cudaGetLastError();
}

// K7: id-only jump flood of the nearest-keyline field.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::nn_field_pallas.  The seeds
// come from csrc/seed_scatter.cu's winner plane (largest kept keyline index
// per cell, the sequential scatter's last writer).
//
// It is not K1 with fewer planes.  The Pallas body keeps three separate
// [rows, cols] planes (id, sy, sx) plus the running best distance, rolls
// each plane on its own (rows wrap modulo rows, columns modulo cols: no
// region stack, no pad rows), and UPDATES the state after every direction:
// the next direction rolls the state the previous one wrote.  So the flood
// is 8 * len(steps) dependent full-field passes (48 at field search range
// 20: steps 16, 8, 4, 2, 1, 1), in the order dy outer, dx inner over
// (-s, 0, s) with (0, 0) skipped.
//
// Design: one thread per cell, one launch per direction, ping-pong between
// two copies of the state (id int32; sy, sx, best float32) in device
// memory: pass p reads cell (y - dy, x - dx) of the copy pass p-1 wrote, so
// no pass races with itself.  An empty candidate (id < 0) has distance 1e9;
// a candidate is taken only if strictly closer; d2 = (y - sy)^2 + (x - sx)^2
// in float32 with round-to-nearest intrinsics and no FMA contraction, so
// ties resolve as in the reference.  The last kernel applies the radius
// gate.
//
// Bound on the H100: operations, barely.  The least traffic is the keyline
// table read once and the [rows*cols] int32 field written once (0.5 MB,
// 0.15 us at 3.35 TB/s); the 48 passes do about 7 float32 operations per
// cell each (30 MFLOP, 0.45 us at 67 TFLOP/s).  Both are far below the 50
// launches this design makes, each a full pass over 1.4 MB of state that
// stays in L2.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e9f;

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float dist2(float y, float x, float sy, float sx) {
  float a = __fsub_rn(y, sy);
  float b = __fsub_rn(x, sx);
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// state planes of one copy: sid[n] int32, then f[3*n] = sy, sx, best
__global__ void nn_init(const float* __restrict__ pos, const int* __restrict__ winner,
                        int rows, int cols, int* __restrict__ sid, float* __restrict__ f) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= cols || y >= rows) return;
  const int n = rows * cols;
  const int i = y * cols + x;
  const int w = winner[i];
  float sy = BIG, sx = BIG, best = BIG;
  if (w >= 0) {
    sx = pos[2 * w];
    sy = pos[2 * w + 1];
    best = dist2((float)y, (float)x, sy, sx);
  }
  sid[i] = w;
  f[i] = sy;
  f[n + i] = sx;
  f[2 * n + i] = best;
}

__global__ void nn_step(const int* __restrict__ sid_in, const float* __restrict__ f_in,
                        int* __restrict__ sid_out, float* __restrict__ f_out,
                        int rows, int cols, int dy, int dx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= cols || y >= rows) return;
  const int n = rows * cols;
  const int i = y * cols + x;
  const int j = wrap(y - dy, rows) * cols + wrap(x - dx, cols);
  int id = sid_in[i];
  float sy = f_in[i], sx = f_in[n + i], best = f_in[2 * n + i];
  const int cid = sid_in[j];
  const float csy = f_in[j], csx = f_in[n + j];
  const float cd2 = (cid >= 0) ? dist2((float)y, (float)x, csy, csx) : BIG;
  if (cd2 < best) {
    id = cid;
    sy = csy;
    sx = csx;
    best = cd2;
  }
  sid_out[i] = id;
  f_out[i] = sy;
  f_out[n + i] = sx;
  f_out[2 * n + i] = best;
}

__global__ void nn_finish(const int* __restrict__ sid, const float* __restrict__ f, int n,
                          float r2, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (f[2 * n + i] <= r2) ? sid[i] : -1;
}

}  // namespace

// pos [K, 2] in field units, winner [rows*cols] from rk_seed_winner;
// sid_a/sid_b [rows*cols] int32 and f_a/f_b [3*rows*cols] float32 scratch;
// out [rows*cols] int32.
extern "C" int rk_nn_flood(const float* pos, const int* winner, int* sid_a, float* f_a,
                           int* sid_b, float* f_b, int* out, int rows, int cols,
                           int search_range, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n = rows * cols;
  dim3 block(128);
  dim3 grid((cols + 127) / 128, rows);
  nn_init<<<grid, block, 0, stream>>>(pos, winner, rows, cols, sid_a, f_a);
  int* sid_src = sid_a;
  float* f_src = f_a;
  int* sid_dst = sid_b;
  float* f_dst = f_b;
  int s = 1;
  while (2 * s < search_range) s *= 2;
  for (bool extra = false;;) {
    for (int iy = -1; iy <= 1; ++iy) {
      for (int ix = -1; ix <= 1; ++ix) {
        if (iy == 0 && ix == 0) continue;
        nn_step<<<grid, block, 0, stream>>>(sid_src, f_src, sid_dst, f_dst, rows, cols,
                                            iy * s, ix * s);
        int* ti = sid_src; sid_src = sid_dst; sid_dst = ti;
        float* tf = f_src; f_src = f_dst; f_dst = tf;
      }
    }
    if (s > 1) {
      s /= 2;
    } else if (!extra) {
      extra = true;  // the extra refinement pass at step 1 (JFA+1)
    } else {
      break;
    }
  }
  nn_finish<<<(n + 255) / 256, 256, 0, stream>>>(sid_src, f_src, n,
                                                 (float)(search_range * search_range), out);
  return (int)cudaGetLastError();
}

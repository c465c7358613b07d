// K1b (seeding part) and K7 (seeding part): scatter the keyline table into
// field cells with a deterministic collision rule.
//
// Replaces the scatter seeding of
//   rebvio_tpu/ops/pallas_kernels.py::att_field_pallas (the [K] -> [n, 8]
//   row scatter, last writer wins), and
//   rebvio_tpu/ops/pallas_kernels.py::nn_field_pallas (three last-writer
//   scatters of id, pos_y, pos_x).
// The flood that follows is csrc/flood.cu (K1b) or csrc/nn_flood.cu (K7).
//
// A sequential scatter leaves in each cell the keyline with the LARGEST
// index among those that round into it, and the whole row comes from that
// one keyline.  Two kernels reproduce that without any write race:
//   seed_winner: one thread per keyline; a kept keyline whose cell lies in
//                the field does atomicMax(winner[cell], k) on an int32
//                plane preset to -1.  Integer max is order-independent, so
//                the plane is the same in every run.
//   seed_stack:  one thread per cell of the [5*(rows+PAD), cols] region
//                stack (regions sy, sx, id, gx, gy); a data cell whose
//                winner is k takes all five values from keyline k, every
//                other cell and every pad row takes the sentinel
//                (BIG, BIG, -1, 0, 0).  Writes are coalesced and each cell
//                is written once.
//
// Bound on the H100: bytes.  At the parity geometry (K = 16000, field
// 240x376, PAD 16) the least traffic is the keyline table (pos, grad, use:
// 272 KB) read once and the stack (1.9 MB) written once, under 1 us at
// 3.35 TB/s: both kernels sit at launch latency.
//
// Arithmetic as the Pallas wrappers: pos * inv_s with one rounded multiply
// (inv_s is float32(1/scale)), cell = floor(p + 0.5), dropped outside the
// field.  The seed coordinates written to the stack are those products.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e9f;

__global__ void seed_winner(const float* __restrict__ pos,
                            const unsigned char* __restrict__ use, int K, float inv_s,
                            int rows, int cols, int* __restrict__ winner) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K || !use[k]) return;
  const float px = __fmul_rn(pos[2 * k], inv_s);
  const float py = __fmul_rn(pos[2 * k + 1], inv_s);
  const float fc = floorf(__fadd_rn(px, 0.5f));
  const float fr = floorf(__fadd_rn(py, 0.5f));
  // comparisons in float: NaN and far-out coordinates fail them
  if (!(fr >= 0.0f && fr < (float)rows && fc >= 0.0f && fc < (float)cols)) return;
  atomicMax(&winner[(int)fr * cols + (int)fc], k);
}

__global__ void seed_stack(const float* __restrict__ pos, const float* __restrict__ grad,
                           const int* __restrict__ winner, float inv_s, int rows, int cols,
                           int Rp, float* __restrict__ stack) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;  // row of a region, pad rows included
  if (x >= cols || y >= Rp) return;
  const int w = (y < rows) ? winner[y * cols + x] : -1;
  float v[5] = {BIG, BIG, -1.0f, 0.0f, 0.0f};
  if (w >= 0) {
    v[0] = __fmul_rn(pos[2 * w + 1], inv_s);
    v[1] = __fmul_rn(pos[2 * w], inv_s);
    v[2] = (float)w;  // exact below 2^24
    v[3] = grad[2 * w];
    v[4] = grad[2 * w + 1];
  }
  for (int r = 0; r < 5; ++r) stack[((size_t)r * Rp + y) * cols + x] = v[r];
}

}  // namespace

// winner[rows*cols] <- largest kept keyline index per cell, -1 where none.
extern "C" int rk_seed_winner(const float* pos, const unsigned char* use, int K, float inv_s,
                              int rows, int cols, int* winner, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaMemsetAsync(winner, 0xFF, (size_t)rows * cols * sizeof(int), stream);  // all -1
  if (K > 0) {
    seed_winner<<<(K + 255) / 256, 256, 0, stream>>>(pos, use, K, inv_s, rows, cols, winner);
  }
  return (int)cudaGetLastError();
}

// stack[5*(rows+pad), cols] <- the flood's seeded region stack.
extern "C" int rk_seed_stack(const float* pos, const float* grad, const int* winner,
                             float inv_s, int rows, int cols, int pad, float* stack,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int Rp = rows + pad;
  dim3 block(128);
  dim3 grid((cols + 127) / 128, Rp);
  seed_stack<<<grid, block, 0, stream>>>(pos, grad, winner, inv_s, rows, cols, Rp, stack);
  return (int)cudaGetLastError();
}

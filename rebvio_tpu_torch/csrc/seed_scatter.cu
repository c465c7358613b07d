// K7 (seeding part): the winner plane of the keyline table, the seeds of
// csrc/nn_flood.cu's id flood.
//
// Replaces the scatter seeding of
//   rebvio_tpu/ops/pallas_kernels.py::nn_field_pallas (three last-writer
//   scatters of id, pos_y, pos_x).
// K1b (att_field_pallas) seeds inside its own flood launch (csrc/flood.cu,
// att_field_kernel), with the same cell rule (seed_cell.cuh).
//
// A sequential scatter leaves in each cell the keyline with the LARGEST
// index among those that round into it.  seed_winner reproduces that
// without any write race: one thread per keyline; a kept keyline whose cell
// lies in the field does atomicMax(winner[cell], k) on an int32 plane preset
// to -1.  Integer max is order-independent, so the plane is the same in
// every run.
//
// Bound on the H100: bytes.  At K = 16000 the least traffic is the table
// (pos, use: 144 KB) read once and the plane written once (361 KB at the
// parity field), ~0.15 us at 3.35 TB/s: the memset and the kernel sit at
// launch latency.

#include <cuda_runtime.h>

#include "seed_cell.cuh"

namespace {

__global__ void seed_winner(const float* __restrict__ pos,
                            const unsigned char* __restrict__ use, int K, float inv_s,
                            int rows, int cols, int* __restrict__ winner) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  int cell;
  if (k < K && use[k] && seed_cell(pos + 2 * k, inv_s, rows, cols, cell))
    atomicMax(&winner[cell], k);
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

// Unrolled Cholesky inverse of a batch of small matrices
// (TooN::Cholesky::get_inverse; geometry/linalg.py::chol_inverse).
//
// It replaces no TPU kernel: the JAX package leaves the same unrolled scalar
// recurrence (rebvio_tpu/geometry/linalg.py::_chol_inverse_unrolled) to XLA.
// In eager PyTorch that recurrence is ~n^3 one-element launches, so the port
// runs it here as one launch.
//
// Bound on the H100: launch latency.  A 7x7 matrix is 196 bytes in, 196
// out and ~400 float32 operations; the chain of ~n^3/3 dependent scalar
// operations (seven square roots, n(n+1)/2 + n(n-1)/2 divisions) is the
// device time.
//
// Design: one thread per matrix of the [..., n, n] batch, n <= 8 a template
// parameter so every loop unrolls and L, inv(L) live in registers.  The
// operations and their order are those of the plain version: the factor
// L[i][j] = (m[i][j] - sum_k L[i][k] L[j][k]) {sqrt | / L[j][j]}, the
// forward substitution Li[i][j] = -(sum) / L[i][i], and out[i][j] = sum over
// k from max(i, j) up of Li[k][i] Li[k][j] starting from 0.  sqrtf and /
// are IEEE-rounded (no fast-math; the build has --fmad=false), so a
// non-positive-definite input gives NaN exactly where the plain version
// does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <int N>
__global__ void chol_inverse_kernel(const float* __restrict__ m, float* __restrict__ out,
                                    int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* a = m + (size_t)b * N * N;
  float* o = out + (size_t)b * N * N;
  float L[N][N], Li[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i * N + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(s) : s / L[j][j];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    Li[j][j] = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s = L[i][j] * Li[j][j];
#pragma unroll
      for (int k = j + 1; k < i; ++k) s = s + L[i][k] * Li[k][j];
      Li[i][j] = -s / L[i][i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = (i > j ? i : j); k < N; ++k) s = s + Li[k][i] * Li[k][j];
      o[i * N + j] = s;
    }
  }
}

template <int N>
int launch(const float* m, float* out, int batch, cudaStream_t stream) {
  chol_inverse_kernel<N><<<(batch + kThreads - 1) / kThreads, kThreads, 0, stream>>>(m, out,
                                                                                    batch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rk_chol_inverse(const float* m, float* out, int n, int batch, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (n) {
    case 1: return launch<1>(m, out, batch, stream);
    case 2: return launch<2>(m, out, batch, stream);
    case 3: return launch<3>(m, out, batch, stream);
    case 4: return launch<4>(m, out, batch, stream);
    case 5: return launch<5>(m, out, batch, stream);
    case 6: return launch<6>(m, out, batch, stream);
    case 7: return launch<7>(m, out, batch, stream);
    case 8: return launch<8>(m, out, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

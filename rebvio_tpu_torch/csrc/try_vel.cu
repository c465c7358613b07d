// K2: one fused tryVel pass of the translation tracker (core.cpp:78-148).
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::try_vel_math_pallas (the
// post-gather math of the TPU path) and computes exactly what the fused
// try_vel_pallas of the same file computes: projection of every old
// keyline by the trial velocity, the [8] attribute-row gather from the new
// map's field at the projected cell, the gradient-similarity gate, Huber
// reweight, residual and score, the 4x4 JtJ|JtF Gram sums, new residuals
// and forward match ids.  The in-kernel gather that Mosaic could not lower
// is an ordinary load here.
//
// Bound on the H100: launch latency.  At 16000 keylines one pass reads
// 7 [K] f32 planes + 3 floats and gathers 6 f32 of the field per keyline
// (~0.83 MB) and writes 2 [K] planes (0.13 MB): ~0.3 us at 3.35 TB/s,
// below the ~2-3 us of the two launches.  Six passes per frame run back to
// back on the stream with no host round trip (vel lives on the device).
//
// Design: one thread per keyline, 256 per block; each block reduces its
// 10 Gram entries + score in shared memory with a fixed tree and writes a
// partial row; a second single-block kernel sums the partial rows in block
// order.  No float atomics, so a pass repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 11;  // G00 G01 G02 G03 G11 G12 G13 G22 G23 G33 score

struct Params {
  int K, N, H, W, fscale, Wf;
  float fm, cx, cy, R, rw, mthr;
};

__global__ void try_vel_pass(const float* __restrict__ pos_img, const float* __restrict__ rho_in,
                             const float* __restrict__ sigma_rho, const float* __restrict__ grad,
                             const float* __restrict__ use_f, const float* __restrict__ res_in,
                             const float* __restrict__ vel, const float* __restrict__ att,
                             Params p, float* __restrict__ partials,
                             float* __restrict__ res_out, int* __restrict__ mif) {
  __shared__ float sh[kSums][kThreads];
  const int k = blockIdx.x * kThreads + threadIdx.x;
  float v[kSums];
  for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
  if (k < p.K) {
    const float v0 = vel[0], v1 = vel[1], v2 = vel[2];
    const bool use = use_f[k] > 0.5f;
    const float res = res_in[k];
    const float weight = res > p.rw ? p.rw / res : 1.0f;
    const float sr = sigma_rho[k];
    const float inv_sr = 1.0f / (sr > 0.0f ? sr : 1.0f);
    const float rho = rho_in[k];
    const float z_p = 1.0f / (rho != 0.0f ? rho : 1e-20f) + v2;
    const bool front = z_p > 0.0f;
    const float rho_p = 1.0f / (front ? z_p : 1.0f);
    const float pxi = pos_img[2 * k], pyi = pos_img[2 * k + 1];
    const float p_x = rho_p * (v0 * p.fm - v2 * pxi) + pxi;
    const float p_y = rho_p * (v1 * p.fm - v2 * pyi) + pyi;
    const float p_xc = p_x + p.cx;
    const float p_yc = p_y + p.cy;
    const int x = (int)floorf(p_xc + 0.5f);
    const int y = (int)floorf(p_yc + 0.5f);
    const bool inb = (x >= 1) && (y >= 1) && (x < p.W - 1) && (y < p.H - 1);
    const bool lookup_ok = use && front && inb;
    const int xs = min(max(x, 0), p.W - 1);
    const int ys = min(max(y, 0), p.H - 1);
    const int fidx = p.fscale > 1 ? (ys / p.fscale) * p.Wf + xs / p.fscale : ys * p.W + xs;
    const float idf = att[2 * p.N + fidx];
    const float gNx = att[3 * p.N + fidx], gNy = att[4 * p.N + fidx];
    const float gnN = att[5 * p.N + fidx];
    const float posNx = att[6 * p.N + fidx], posNy = att[7 * p.N + fidx];
    const int fid = lookup_ok ? (int)idf : -1;
    const float gx = grad[2 * k], gy = grad[2 * k + 1];
    const float dot = gNx * gx + gNy * gy;
    const float n2 = gnN * gnN;
    const bool matched = (fid >= 0) && (fabsf(dot - n2) <= p.mthr * n2);
    const float gsafe = gnN > 0.0f ? gnN : 1.0f;
    const float ux = gNx / gsafe, uy = gNy / gsafe;
    const float fi = (p_xc - posNx) * ux + (p_yc - posNy) * uy;
    const float f = (matched ? fi * inv_sr : p.R * inv_sr) * weight;
    const bool m = matched && use;
    if (use) v[10] = f * f;
    if (m) {
      const float df_dx = ux * inv_sr, df_dy = uy * inv_sr;
      const float J[4] = {rho_p * p.fm * df_dx * weight, rho_p * p.fm * df_dy * weight,
                          -rho_p * (p_x * df_dx + p_y * df_dy) * weight, f};
      int j = 0;
      for (int a = 0; a < 4; ++a)
        for (int b = a; b < 4; ++b) v[j++] = J[a] * J[b];
    }
    res_out[k] = m ? fabsf(fi) : res;
    mif[k] = m ? fid : -1;
  }
  for (int j = 0; j < kSums; ++j) sh[j][threadIdx.x] = v[j];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      for (int j = 0; j < kSums; ++j) sh[j][threadIdx.x] += sh[j][threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x < kSums) partials[blockIdx.x * kSums + threadIdx.x] = sh[threadIdx.x][0];
}

__global__ void try_vel_sum(const float* __restrict__ partials, int nblk,
                            float* __restrict__ G, float* __restrict__ score) {
  const int j = threadIdx.x;
  if (j >= kSums) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += partials[b * kSums + j];
  if (j == 10) {
    score[0] = s;
    return;
  }
  int a = 0, idx = j;
  while (idx >= 4 - a) { idx -= 4 - a; ++a; }
  const int b = a + idx;
  G[a * 4 + b] = s;
  G[b * 4 + a] = s;
}

}  // namespace

extern "C" int rk_try_vel(const float* pos_img, const float* rho, const float* sigma_rho,
                          const float* grad, const float* use_f, const float* res_in,
                          const float* vel, const float* att, int K, int N, int H, int W,
                          int fscale, float fm, float cx, float cy, float R, float rw,
                          float mthr, float* partials, float* G, float* score, float* res_out,
                          int* mif, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Params p{K, N, H, W, fscale, (W + fscale - 1) / fscale, fm, cx, cy, R, rw, mthr};
  const int nblk = (K + kThreads - 1) / kThreads;
  try_vel_pass<<<nblk, kThreads, 0, stream>>>(pos_img, rho, sigma_rho, grad, use_f, res_in,
                                              vel, att, p, partials, res_out, mif);
  try_vel_sum<<<1, 32, 0, stream>>>(partials, nblk, G, score);
  return (int)cudaGetLastError();
}

extern "C" int rk_try_vel_blocks(int K) { return (K + kThreads - 1) / kThreads; }

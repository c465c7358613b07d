// K2: the translation tracker's Levenberg-Marquardt solve, every tryVel pass
// and the update between two passes in one cooperative launch
// (core.cpp:78-189).
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::try_vel_math_pallas (the
// post-gather math of one pass on the TPU path; 1 + iterations passes a
// solve with the LM update in XLA between them) and computes per pass what
// the fused try_vel_pallas of the same file computes: projection of every
// old keyline by the trial velocity, the [8] attribute-row gather from the
// new map's field at the projected cell, the gradient-similarity gate,
// Huber reweight, residual and score, the 4x4 JtJ|JtF Gram sums, new
// residuals and forward match ids.  The in-kernel gather that Mosaic could
// not lower is an ordinary load here.
//
// Bound on the H100: latency.  At 16000 keylines a solve reads 7 [K] f32
// planes + 3 floats once, gathers 6 f32 of the field per keyline per pass
// (the 2.9 MB field stays in the 50 MB L2) and writes 2 [K] planes once:
// ~0.3 us of memory work per pass at 3.35 TB/s.  What sets the time is the
// chain of dependent passes: each needs the velocity that the pass before
// decided, so a solve is 1 + iterations grid-wide reductions.
//
// Design: one cooperative launch, one thread per keyline, 256 per block
// (63 blocks at K = 16000: one wave on 132 SMs; the launch is refused when
// the grid cannot be co-resident).  A thread loads its keyline's seven
// constants once and keeps them, the running residual and 1/sigma in
// registers over all passes.  Per pass: the 11 sums (10 Gram entries +
// score) reduce by warp shuffles in a fixed tree, across the block's warps
// through shared memory in warp order, and go to one partial row per block
// (double-buffered over passes); ONE grid sync; then every block sums the
// partial rows in block order and runs the LM update itself (damped 3x3
// adjugate inverse in linalg.invert3's operation order with a true division
// by det, the step, the gain, accept, u, v).  Identical arithmetic in every
// block gives bit-identical trial velocities everywhere: no second sync, no
// float atomics, and a launch repeats bit for bit.  The residuals and the
// forward ids are written once, by the last pass, accepted or not, as the
// reference has it.  With iterations = 0 the same kernel is the single
// tryVel pass (rk_minimize_vel with a residual plane given): one body of
// pass arithmetic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 11;  // G00 G01 G02 G03 G11 G12 G13 G22 G23 G33 score
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int K, N, H, W, fscale, Wf;
  float fm, cx, cy, R, rw, mthr;
};

// What a thread keeps of its keyline over all passes.
struct Keyline {
  float pxi, pyi, gx, gy, inv_rho, inv_sr;
  bool use;
};

// One tryVel pass for one keyline: its 11 terms into v, its new residual and
// forward id.  `res` is the residual of the pass before (the Huber weight).
__device__ __forceinline__ void try_vel_keyline(const Keyline& c, float res, float v0, float v1,
                                                float v2, const float* __restrict__ att,
                                                const Params& p, float (&v)[kSums],
                                                float& res_new, int& mid) {
  const float weight = res > p.rw ? p.rw / res : 1.0f;
  const float z_p = c.inv_rho + v2;
  const bool front = z_p > 0.0f;
  const float rho_p = 1.0f / (front ? z_p : 1.0f);
  const float p_x = rho_p * (v0 * p.fm - v2 * c.pxi) + c.pxi;
  const float p_y = rho_p * (v1 * p.fm - v2 * c.pyi) + c.pyi;
  const float p_xc = p_x + p.cx;
  const float p_yc = p_y + p.cy;
  const int x = (int)floorf(p_xc + 0.5f);
  const int y = (int)floorf(p_yc + 0.5f);
  const bool inb = (x >= 1) && (y >= 1) && (x < p.W - 1) && (y < p.H - 1);
  const bool lookup_ok = c.use && front && inb;
  const int xs = min(max(x, 0), p.W - 1);
  const int ys = min(max(y, 0), p.H - 1);
  const int fidx = p.fscale > 1 ? (ys / p.fscale) * p.Wf + xs / p.fscale : ys * p.W + xs;
  const float idf = att[2 * p.N + fidx];
  const float gNx = att[3 * p.N + fidx], gNy = att[4 * p.N + fidx];
  const float gnN = att[5 * p.N + fidx];
  const float posNx = att[6 * p.N + fidx], posNy = att[7 * p.N + fidx];
  const int fid = lookup_ok ? (int)idf : -1;
  const float dot = gNx * c.gx + gNy * c.gy;
  const float n2 = gnN * gnN;
  const bool matched = (fid >= 0) && (fabsf(dot - n2) <= p.mthr * n2);
  const float gsafe = gnN > 0.0f ? gnN : 1.0f;
  const float ux = gNx / gsafe, uy = gNy / gsafe;
  const float fi = (p_xc - posNx) * ux + (p_yc - posNy) * uy;
  const float f = (matched ? fi * c.inv_sr : p.R * c.inv_sr) * weight;
  const bool m = matched && c.use;
  if (c.use) v[10] = f * f;
  if (m) {
    const float df_dx = ux * c.inv_sr, df_dy = uy * c.inv_sr;
    const float J[4] = {rho_p * p.fm * df_dx * weight, rho_p * p.fm * df_dy * weight,
                        -rho_p * (p_x * df_dx + p_y * df_dy) * weight, f};
    int j = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a; b < 4; ++b) v[j++] = J[a] * J[b];
  }
  res_new = m ? fabsf(fi) : res;
  mid = m ? fid : -1;
}

// linalg.invert3(M) @ x with M = [[a b c] [b' e f] [g h i]] given in full:
// the adjugate over det, each entry a division, then rows dotted in order.
__device__ __forceinline__ void invert3_times(const float (&M)[9], const float (&x)[3],
                                              float (&out)[3]) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6], h = M[7],
              i = M[8];
  const float adj[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                        f * g - d * i, a * i - c * g, c * d - a * f,
                        d * h - e * g, b * g - a * h, a * e - b * d};
  const float det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 3; ++t) s = s + (adj[r * 3 + t] / det) * x[t];
    out[r] = s;
  }
}

// The six unique entries G00 G01 G02 G11 G12 G22 of the 3x3 block as a full
// row-major matrix.
__device__ __forceinline__ void full3(const float (&J)[6], float (&M)[9]) {
  M[0] = J[0]; M[1] = J[1]; M[2] = J[2];
  M[3] = J[1]; M[4] = J[3]; M[5] = J[4];
  M[6] = J[2]; M[7] = J[4]; M[8] = J[5];
}

// out layout (floats): vel[3] JtJ[9] JtF[3] score[1], then gain[iterations],
// accept[iterations] (1.0 / 0.0) and the trial's score[iterations] of each LM
// iteration.
__global__ void __launch_bounds__(kThreads)
minimize_vel_kernel(const float* __restrict__ pos_img, const float* __restrict__ rho_in,
                    const float* __restrict__ sigma_rho, const float* __restrict__ grad,
                    const float* __restrict__ use_f, const float* __restrict__ res_in,
                    const float* __restrict__ vel0, const float* __restrict__ att, Params p,
                    int iterations, float* partials, float* __restrict__ out,
                    float* __restrict__ res_out, int* __restrict__ mif) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kWarps][kSums];
  __shared__ float tot[kSums];
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblk = gridDim.x;
  const bool active = k < p.K;

  Keyline c{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  float res = 0.0f;
  if (active) {
    const float sr = sigma_rho[k];
    const float rho = rho_in[k];
    c.pxi = pos_img[2 * k];
    c.pyi = pos_img[2 * k + 1];
    c.gx = grad[2 * k];
    c.gy = grad[2 * k + 1];
    c.inv_rho = 1.0f / (rho != 0.0f ? rho : 1e-20f);
    c.inv_sr = 1.0f / (sr > 0.0f ? sr : 1.0f);
    c.use = use_f[k] > 0.5f;
    if (res_in != nullptr) res = res_in[k];
  }

  // LM state, the same in every thread of the grid
  float vel[3] = {vel0[0], vel0[1], vel0[2]};
  float F = 0.0f, JtJ[6], JtF[3], u = 0.0f, vv = 2.0f;
  float trial[3] = {vel[0], vel[1], vel[2]}, h[3] = {0.0f, 0.0f, 0.0f};

  for (int pass = 0; pass <= iterations; ++pass) {
    float v[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
    int mid = -1;
    if (active) {
      float res_new;
      try_vel_keyline(c, res, trial[0], trial[1], trial[2], att, p, v, res_new, mid);
      res = res_new;
      if (pass == iterations) {
        res_out[k] = res;
        mif[k] = mid;
      }
    }
    // block sums: shuffle tree in the warp, then the warps in order
#pragma unroll
    for (int j = 0; j < kSums; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[j] = v[j] + __shfl_down_sync(FULL, v[j], off);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kSums; ++j) sh[warp][j] = v[j];
    }
    __syncthreads();
    float* part = partials + (size_t)(pass & 1) * nblk * kSums;
    if (threadIdx.x < kSums) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = s + sh[w][threadIdx.x];
      __stcg(&part[blockIdx.x * kSums + threadIdx.x], s);
    }
    grid.sync();
    // every block: the partial rows summed in block order.  A warp takes a
    // sum; its lanes fetch 32 rows at once (past L1: another pass wrote this
    // buffer two passes ago) and add them up in order through shuffles.
    for (int j = warp; j < kSums; j += kWarps) {
      float s = 0.0f;
      for (int base = 0; base < nblk; base += 32) {
        const int b = base + lane;
        const float x = b < nblk ? __ldcg(&part[b * kSums + j]) : 0.0f;
        const int cnt = min(32, nblk - base);
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const float y = __shfl_sync(FULL, x, t);
          if (t < cnt) s = s + y;
        }
      }
      if (lane == 0) tot[j] = s;
    }
    __syncthreads();
    // G00 G01 G02 G03 G11 G12 G13 G22 G23 G33 score
    const float J2[6] = {tot[0], tot[1], tot[2], tot[4], tot[5], tot[7]};
    const float g2[3] = {tot[3], tot[6], tot[8]};
    const float score2 = tot[10];
    if (pass == 0) {
      F = score2;
#pragma unroll
      for (int e = 0; e < 6; ++e) JtJ[e] = J2[e];
#pragma unroll
      for (int e = 0; e < 3; ++e) JtF[e] = g2[e];
      float mx = JtJ[0];
#pragma unroll
      for (int e = 1; e < 6; ++e) mx = fmaxf(mx, JtJ[e]);
#pragma unroll
      for (int e = 0; e < 6; ++e) mx = isnan(JtJ[e]) ? JtJ[e] : mx;  // torch.max keeps NaN
      u = 1e-3f * mx;
    } else {
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < 3; ++e) d = d + h[e] * (u * h[e] - JtF[e]);
      const float gain = (F - score2) / (0.5f * d);
      const bool accept = gain > 0.0f;
      if (accept) {
        F = score2;
#pragma unroll
        for (int e = 0; e < 3; ++e) vel[e] = trial[e];
#pragma unroll
        for (int e = 0; e < 6; ++e) JtJ[e] = J2[e];
#pragma unroll
        for (int e = 0; e < 3; ++e) JtF[e] = g2[e];
      }
      const float t = 2.0f * gain - 1.0f;
      const float shrink = 1.0f - t * t * t;
      u = accept ? u * (shrink < 0.33f ? 0.33f : shrink) : u * vv;
      vv = accept ? 2.0f : vv * 2.0f;
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        out[16 + pass - 1] = gain;
        out[16 + iterations + pass - 1] = accept ? 1.0f : 0.0f;
        out[16 + 2 * iterations + pass - 1] = score2;
      }
    }
    if (pass < iterations) {
      // h = invert3(JtJ + eye * u) @ (-JtF); the next trial velocity
      float M[9];
      full3(JtJ, M);
#pragma unroll
      for (int e = 0; e < 9; ++e) M[e] = M[e] + (e % 4 == 0 ? 1.0f : 0.0f) * u;
      const float nF[3] = {-JtF[0], -JtF[1], -JtF[2]};
      invert3_times(M, nF, h);
#pragma unroll
      for (int e = 0; e < 3; ++e) trial[e] = vel[e] + h[e];
    }
    // `tot` is written again only after the next grid sync, which every
    // thread reaches after these reads
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float M[9];
    full3(JtJ, M);
#pragma unroll
    for (int e = 0; e < 3; ++e) out[e] = vel[e];
#pragma unroll
    for (int e = 0; e < 9; ++e) out[3 + e] = M[e];
#pragma unroll
    for (int e = 0; e < 3; ++e) out[12 + e] = JtF[e];
    out[15] = F;
  }
}

}  // namespace

// Blocks of a solve over K keylines, and the most that can be co-resident on
// the current device (the cooperative launch's limit).
extern "C" int rk_minimize_vel_blocks(int K) { return (K + kThreads - 1) / kThreads; }

extern "C" int rk_minimize_vel_max_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minimize_vel_kernel, kThreads, 0) !=
      cudaSuccess)
    return -1;
  return sms * per_sm;
}

// res_in may be null (residuals start at 0, as the LM solve has them);
// partials holds 2 * blocks * 11 floats; out holds 16 + 3 * iterations.
extern "C" int rk_minimize_vel(const float* pos_img, const float* rho, const float* sigma_rho,
                               const float* grad, const float* use_f, const float* res_in,
                               const float* vel0, const float* att, int K, int N, int H, int W,
                               int fscale, float fm, float cx, float cy, float R, float rw,
                               float mthr, int iterations, float* partials, float* out,
                               float* res_out, int* mif, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Params p{K, N, H, W, fscale, (W + fscale - 1) / fscale, fm, cx, cy, R, rw, mthr};
  const int nblk = (K + kThreads - 1) / kThreads;
  void* args[] = {&pos_img, &rho, &sigma_rho, &grad, &use_f, &res_in, &vel0, &att, &p,
                  &iterations, &partials, &out, &res_out, &mif};
  return (int)cudaLaunchCooperativeKernel((const void*)minimize_vel_kernel, dim3(nblk),
                                          dim3(kThreads), args, 0, stream);
}

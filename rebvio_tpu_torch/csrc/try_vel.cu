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
// Design: one cooperative launch over B lanes (the B independent solves
// that torch.func.vmap of the step hands it, as jax.vmap of a pallas_call
// adds a grid axis), one thread per keyline, 256 per block.  The work items
// are the (lane, keyline block) pairs, B * ceil(K / 256) of them (63 a lane
// at K = 16000), numbered lane by lane; the grid is capped at the
// co-resident limit and a block takes items blockIdx.x, + gridDim.x, ...
// (at most kItems).  A thread loads the seven constants of each of its
// keylines once and keeps them, the running residuals and 1/sigma in
// registers over all passes.  Per pass and item: the 11 sums (10 Gram
// entries + score) reduce by warp shuffles in a fixed tree, across the
// block's warps through shared memory in warp order, and go to one partial
// row per item (double-buffered over passes); ONE grid sync for all lanes;
// then every block sums each lane's partial rows in block order (the rows
// staged through shared memory in chunks, thread (lane, sum) adding its
// lane's rows one after another from 0) and thread `lane` runs that lane's
// LM update (damped 3x3 adjugate inverse in linalg.invert3's operation
// order with a true division by det, the step, the gain, accept, u, v).
// Identical arithmetic in every block gives bit-identical trial velocities
// everywhere: no second sync, no float atomics, and a launch repeats bit
// for bit.  A lane's sums, their order and its update do not depend on B
// or on the grid, so each lane gives the bits of a launch of its own.  The
// residuals and the forward ids are written once, by the last pass,
// accepted or not, as the reference has it.  With iterations = 0 the same
// kernel is the single tryVel pass (rk_minimize_vel with a residual plane
// given): one body of pass arithmetic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 11;  // G00 G01 G02 G03 G11 G12 G13 G22 G23 G33 score
constexpr int kItems = 4;       // (lane, keyline block) items a block holds at most
constexpr int kLanesMax = kThreads / kSums;   // 23: a thread for each (lane, sum)
constexpr int kChunk = 256;     // partial rows staged in shared memory at a time
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int B, K, N, H, W, fscale, Wf, nblk, items;
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

// The LM state of one lane, updated from the pass's sums `tot` (G00 G01
// G02 G03 G11 G12 G13 G22 G23 G33 score); its next trial velocity into
// `trial`.  `dbg` (block 0 only): the lane's gain / accept / trial-score rows.
struct Lm {
  float vel[3], F, JtJ[6], JtF[3], u, vv, trial[3], h[3];
};

__device__ __forceinline__ void lm_update(Lm& s, const float* tot, int pass, int iterations,
                                          float* dbg) {
  const float J2[6] = {tot[0], tot[1], tot[2], tot[4], tot[5], tot[7]};
  const float g2[3] = {tot[3], tot[6], tot[8]};
  const float score2 = tot[10];
  if (pass == 0) {
    s.F = score2;
#pragma unroll
    for (int e = 0; e < 6; ++e) s.JtJ[e] = J2[e];
#pragma unroll
    for (int e = 0; e < 3; ++e) s.JtF[e] = g2[e];
    float mx = s.JtJ[0];
#pragma unroll
    for (int e = 1; e < 6; ++e) mx = fmaxf(mx, s.JtJ[e]);
#pragma unroll
    for (int e = 0; e < 6; ++e) mx = isnan(s.JtJ[e]) ? s.JtJ[e] : mx;  // torch.max keeps NaN
    s.u = 1e-3f * mx;
  } else {
    float d = 0.0f;
#pragma unroll
    for (int e = 0; e < 3; ++e) d = d + s.h[e] * (s.u * s.h[e] - s.JtF[e]);
    const float gain = (s.F - score2) / (0.5f * d);
    const bool accept = gain > 0.0f;
    if (accept) {
      s.F = score2;
#pragma unroll
      for (int e = 0; e < 3; ++e) s.vel[e] = s.trial[e];
#pragma unroll
      for (int e = 0; e < 6; ++e) s.JtJ[e] = J2[e];
#pragma unroll
      for (int e = 0; e < 3; ++e) s.JtF[e] = g2[e];
    }
    const float t = 2.0f * gain - 1.0f;
    const float shrink = 1.0f - t * t * t;
    s.u = accept ? s.u * (shrink < 0.33f ? 0.33f : shrink) : s.u * s.vv;
    s.vv = accept ? 2.0f : s.vv * 2.0f;
    if (dbg != nullptr) {
      dbg[16 + pass - 1] = gain;
      dbg[16 + iterations + pass - 1] = accept ? 1.0f : 0.0f;
      dbg[16 + 2 * iterations + pass - 1] = score2;
    }
  }
  if (pass < iterations) {
    // h = invert3(JtJ + eye * u) @ (-JtF); the next trial velocity
    float M[9];
    full3(s.JtJ, M);
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e] = M[e] + (e % 4 == 0 ? 1.0f : 0.0f) * s.u;
    const float nF[3] = {-s.JtF[0], -s.JtF[1], -s.JtF[2]};
    invert3_times(M, nF, s.h);
#pragma unroll
    for (int e = 0; e < 3; ++e) s.trial[e] = s.vel[e] + s.h[e];
  }
}

// Per lane (planes [B, ...], lane after lane) out holds 16 + 3 * iterations
// floats: vel[3] JtJ[9] JtF[3] score[1], then gain[iterations],
// accept[iterations] (1.0 / 0.0) and the trial's score[iterations] of each
// LM iteration.
__global__ void __launch_bounds__(kThreads)
minimize_vel_kernel(const float* __restrict__ pos_img, const float* __restrict__ rho_in,
                    const float* __restrict__ sigma_rho, const float* __restrict__ grad,
                    const float* __restrict__ use_f, const float* __restrict__ res_in,
                    const float* __restrict__ vel0, const float* __restrict__ att, Params p,
                    int iterations, float* partials, float* __restrict__ out,
                    float* __restrict__ res_out, int* __restrict__ mif) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kWarps][kSums];
  __shared__ float rows[kChunk * kSums];
  __shared__ float tot[kLanesMax][kSums];
  __shared__ float trial_s[kLanesMax][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = 16 + 3 * iterations;
  const int K = p.K;

  // this block's items: (lane, keyline block) w = blockIdx.x + i * gridDim.x
  Keyline c[kItems];
  float res[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    c[i] = Keyline{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
    res[i] = 0.0f;
    const int w = blockIdx.x + i * gridDim.x;
    if (w >= p.items) continue;
    const int b = w / p.nblk, k = (w - b * p.nblk) * kThreads + threadIdx.x;
    if (k >= K) continue;
    const size_t bk = (size_t)b * K + k;
    const float sr = sigma_rho[bk];
    const float rho = rho_in[bk];
    c[i].pxi = pos_img[2 * bk];
    c[i].pyi = pos_img[2 * bk + 1];
    c[i].gx = grad[2 * bk];
    c[i].gy = grad[2 * bk + 1];
    c[i].inv_rho = 1.0f / (rho != 0.0f ? rho : 1e-20f);
    c[i].inv_sr = 1.0f / (sr > 0.0f ? sr : 1.0f);
    c[i].use = use_f[bk] > 0.5f;
    if (res_in != nullptr) res[i] = res_in[bk];
  }

  // the LM state of lane threadIdx.x (threads 0..B-1), the same in every block
  Lm lm;
  if (threadIdx.x < p.B) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      lm.vel[e] = vel0[3 * threadIdx.x + e];
      lm.trial[e] = lm.vel[e];
      lm.h[e] = 0.0f;
      trial_s[threadIdx.x][e] = lm.trial[e];
    }
    lm.F = 0.0f;
    lm.u = 0.0f;
    lm.vv = 2.0f;
  }
  __syncthreads();

  for (int pass = 0; pass <= iterations; ++pass) {
    float* part = partials + (size_t)(pass & 1) * p.items * kSums;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int w = blockIdx.x + i * gridDim.x;
      if (w >= p.items) break;                  // uniform over the block
      const int b = w / p.nblk, k = (w - b * p.nblk) * kThreads + threadIdx.x;
      float v[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) v[j] = 0.0f;
      if (k < K) {
        float res_new;
        int mid = -1;
        try_vel_keyline(c[i], res[i], trial_s[b][0], trial_s[b][1], trial_s[b][2],
                        att + (size_t)b * 8 * p.N, p, v, res_new, mid);
        res[i] = res_new;
        if (pass == iterations) {
          res_out[(size_t)b * K + k] = res_new;
          mif[(size_t)b * K + k] = mid;
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
      if (threadIdx.x < kSums) {
        float s = 0.0f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) s = s + sh[wp][threadIdx.x];
        __stcg(&part[(size_t)w * kSums + threadIdx.x], s);
      }
      __syncthreads();                          // before sh is written again
    }
    grid.sync();
    // every block: each lane's partial rows summed in block order.  The rows
    // pass through shared memory kChunk at a time (read past L1: another
    // pass wrote this buffer two passes ago); thread (lane b, sum j) adds
    // lane b's rows of the chunk to its running sum, in order.
    const int pair = threadIdx.x;
    const int pb = pair / kSums, pj = pair - pb * kSums;
    float acc = 0.0f;
    for (int c0 = 0; c0 < p.items; c0 += kChunk) {
      const int nrows = min(kChunk, p.items - c0);
      for (int e = threadIdx.x; e < nrows * kSums; e += kThreads)
        rows[e] = __ldcg(&part[(size_t)c0 * kSums + e]);
      __syncthreads();
      if (pb < p.B) {
        const int lo = max(pb * p.nblk, c0), hi = min((pb + 1) * p.nblk, c0 + nrows);
        for (int r = lo; r < hi; ++r) acc = acc + rows[(r - c0) * kSums + pj];
      }
      __syncthreads();                          // before the next chunk's rows
    }
    if (pb < p.B) tot[pb][pj] = acc;
    __syncthreads();
    if (threadIdx.x < p.B) {
      lm_update(lm, tot[threadIdx.x], pass, iterations,
                blockIdx.x == 0 ? out + (size_t)threadIdx.x * n_out : nullptr);
#pragma unroll
      for (int e = 0; e < 3; ++e) trial_s[threadIdx.x][e] = lm.trial[e];
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x < p.B) {
    float* o = out + (size_t)threadIdx.x * n_out;
    float M[9];
    full3(lm.JtJ, M);
#pragma unroll
    for (int e = 0; e < 3; ++e) o[e] = lm.vel[e];
#pragma unroll
    for (int e = 0; e < 9; ++e) o[3 + e] = M[e];
#pragma unroll
    for (int e = 0; e < 3; ++e) o[12 + e] = lm.JtF[e];
    o[15] = lm.F;
  }
}

}  // namespace

// Blocks (items) of a solve over K keylines, and the most blocks that can be
// co-resident on the current device (the cooperative launch's limit).
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

// The most lanes and work items per block of one launch.
extern "C" int rk_minimize_vel_lanes_max() { return kLanesMax; }
extern "C" int rk_minimize_vel_items_max() { return kItems; }

// B lanes: every plane [B, ...] lane after lane; res_in may be null
// (residuals start at 0, as the LM solve has them); partials holds 2 *
// B * blocks(K) * 11 floats; out holds B rows of 16 + 3 * iterations;
// max_blocks: the co-resident limit (rk_minimize_vel_max_blocks).
extern "C" int rk_minimize_vel(const float* pos_img, const float* rho, const float* sigma_rho,
                               const float* grad, const float* use_f, const float* res_in,
                               const float* vel0, const float* att, int B, int K, int N, int H,
                               int W, int fscale, float fm, float cx, float cy, float R,
                               float rw, float mthr, int iterations, float* partials,
                               float* out, float* res_out, int* mif, int max_blocks,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int nblk = (K + kThreads - 1) / kThreads;
  if (B < 1 || B > kLanesMax || K < 1 || iterations < 0 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int items = B * nblk;
  const int blocks = items < max_blocks ? items : max_blocks;
  if ((items + blocks - 1) / blocks > kItems) return (int)cudaErrorInvalidValue;
  Params p{B, K, N, H, W, fscale, (W + fscale - 1) / fscale, nblk, items,
           fm, cx, cy, R, rw, mthr};
  void* args[] = {&pos_img, &rho, &sigma_rho, &grad, &use_f, &res_in, &vel0, &att, &p,
                  &iterations, &partials, &out, &res_out, &mif};
  return (int)cudaLaunchCooperativeKernel((const void*)minimize_vel_kernel, dim3(blocks),
                                          dim3(kThreads), args, 0, stream);
}

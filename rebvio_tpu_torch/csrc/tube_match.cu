// K4: tube matcher, the directed match of every new keyline into the old
// map along its epipolar tube (edge_map.cpp:101-184, TPU redesign).
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::tube_match_pallas together
// with the XLA work around it in matching._directed_match_tube_impl: the
// P probe positions along the tube, the attribute-row gather from the old
// map's field at each probe, the gather of the candidate's dynamic row
// (rho, sigma_rho, matches, keyframe id), the tube / window / angle / norm
// / depth gates, the priority argmin (first probe wins ties) and the
// winner payload.
//
// Bound on the H100: launch latency.  At 16000 keylines x 8 probes the
// least traffic is 13 [K] f32 planes in, 8 probes x (6 field + 4 dynamic)
// f32 gathered, 12 [K] f32 planes out: ~6.6 MB, ~2 us at 3.35 TB/s, about
// one launch.
//
// Design: one thread per keyline looping over the probes with running
// selects; both gathers happen in the thread, so no [P,K] intermediate
// touches device memory.

#include <cuda_runtime.h>

namespace {

struct Params {
  int K, N, P, H, W, fscale, Wf;
  float pum, cang_min, norm_thr;
};

__global__ void tube_match(const float* __restrict__ kl, const float* __restrict__ att,
                           const float* __restrict__ dyn, const float* __restrict__ M2,
                           Params p, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  const int K = p.K, N = p.N;
  const float tx = kl[k], ty = kl[K + k];
  const float pi0x = kl[2 * K + k], pi0y = kl[3 * K + k];
  const float dq_min = kl[4 * K + k], dq_max = kl[5 * K + k], dq_rho = kl[6 * K + k];
  const float nt_eff = kl[7 * K + k], sigma2_t = kl[8 * K + k];
  const float ngx = kl[9 * K + k], ngy = kl[10 * K + k], ngn = kl[11 * K + k];
  const bool valid = kl[12 * K + k] > 0.5f;
  const float m00 = M2[0], m01 = M2[1], m10 = M2[2], m11 = M2[3];
  const float BIG = 1e9f;

  const float denom_n = ngn > 0.0f ? ngn : 1.0f;
  const float nt2 = nt_eff * nt_eff;
  const float pum2 = p.pum * p.pum;
  float best_prio = BIG;
  float best[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float span = dq_max - dq_min;
  for (int q = 0; q < p.P; ++q) {
    const float lam = (float)q / (float)(p.P - 1);
    const float t_probe = dq_min + span * lam;
    const float px = tx * t_probe + pi0x;
    const float py = ty * t_probe + pi0y;
    const int col = min(max((int)floorf(px + 0.5f), 0), p.W - 1);
    const int row = min(max((int)floorf(py + 0.5f), 0), p.H - 1);
    const bool inb = (px >= -0.5f) && (px < (float)p.W - 0.5f) && (py >= -0.5f) &&
                     (py < (float)p.H - 0.5f);
    const int pidx = p.fscale > 1 ? (row / p.fscale) * p.Wf + col / p.fscale : row * p.W + col;
    const float oid = att[2 * N + pidx];
    const float g0x = att[3 * N + pidx], g0y = att[4 * N + pidx];
    const float gn_old = att[5 * N + pidx];
    const float sx = att[6 * N + pidx], sy = att[7 * N + pidx];
    const float gx_r = g0x * m00 + g0y * m01;
    const float gy_r = g0x * m10 + g0y * m11;
    const int os = min(max(inb ? (int)oid : -1, 0), K - 1);
    const float rho_o = dyn[os], sr_o = dyn[K + os];
    const float m_o = dyn[2 * K + os], kf_o = dyn[3 * K + os];
    const bool has = inb && (oid >= 0.0f);

    const float dxs = sx - pi0x, dys = sy - pi0y;
    const float t_eff = dxs * tx + dys * ty;
    const float perp = fabsf(-dxs * ty + dys * tx);
    const bool g_tube = perp <= p.pum;
    const bool g_win = (t_eff >= dq_min) && (t_eff <= dq_max);
    const float gdot = gx_r * ngx + gy_r * ngy;
    const float den = gn_old * ngn > 0.0f ? gn_old * ngn : 1.0f;
    const bool g_ang = gdot / den >= p.cang_min;
    const bool g_norm = fabsf(gn_old / denom_n - 1.0f) <= p.norm_thr;
    const float v_rho_dr = pum2 + sr_o * sr_o * nt2 + sigma2_t * rho_o * rho_o;
    const float resid = t_eff - nt_eff * rho_o;
    const bool g_depth = !(resid * resid > v_rho_dr);
    const bool ok = valid && has && g_tube && g_win && g_ang && g_norm && g_depth;
    const float prio = ok ? fabsf(t_eff - dq_rho) : BIG;
    if (prio < best_prio) {  // strict: the first probe wins ties
      best_prio = prio;
      best[0] = oid; best[1] = rho_o; best[2] = sr_o; best[3] = gx_r; best[4] = gy_r;
      best[5] = gn_old; best[6] = sx; best[7] = sy; best[8] = m_o; best[9] = kf_o;
    }
  }
  const bool found = best_prio < BIG;
  out[k] = found ? 1.0f : 0.0f;
  out[K + k] = found ? best[0] : -1.0f;
  for (int j = 1; j < 10; ++j) out[(j + 1) * K + k] = best[j];
  out[11 * K + k] = best_prio;
}

}  // namespace

extern "C" int rk_tube_match(const float* kl, const float* att, const float* dyn,
                             const float* M2, int K, int N, int P, int H, int W, int fscale,
                             float pum, float cang_min, float norm_thr, float* out,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Params p{K, N, P, H, W, fscale, (W + fscale - 1) / fscale, pum, cang_min, norm_thr};
  tube_match<<<(K + 127) / 128, 128, 0, stream>>>(kl, att, dyn, M2, p, out);
  return (int)cudaGetLastError();
}

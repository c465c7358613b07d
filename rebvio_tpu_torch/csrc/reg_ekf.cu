// K5: depth regularization + inverse-depth EKF.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::reg_ekf_pallas and the XLA
// neighbour-row gathers that fed it (ops/tracker.py::
// regularize_and_update_depth): regularize_1iter's neighbour tests and
// blend (edge_map.cpp:220-259), then updateInverseDepthARLU on the blended
// depth -- predict, gain, update, clamps, NaN reset (core.cpp:417-456).
//
// Bound on the H100: launch latency.  At 16000 keylines the least traffic
// is ~15 [K] 4-byte planes in and 2 out (~1.1 MB): ~0.3 us at 3.35 TB/s,
// below one launch.
//
// Design: one thread per keyline; it reads its id_next / id_prev
// neighbours' (rho, sigma_rho, grad, grad_norm) itself instead of a packed
// gather, and every update reads only pre-pass values (the reference's
// two-phase Jacobi update), so threads are independent.

#include <cuda_runtime.h>

namespace {

struct Params {
  int K;
  float thr, q_abs2, pu2, fm;
};

__global__ void reg_ekf(const float* __restrict__ rho, const float* __restrict__ sr,
                        const float* __restrict__ grad, const float* __restrict__ gnorm,
                        const int* __restrict__ id_next, const int* __restrict__ id_prev,
                        const unsigned char* __restrict__ valid, const int* __restrict__ match_id,
                        const float* __restrict__ pos_img, const float* __restrict__ mpos_img,
                        const float* __restrict__ mgrad, const float* __restrict__ mgn,
                        const float* __restrict__ vel, Params p, float* __restrict__ rho_out,
                        float* __restrict__ sr_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  const float RHO_MIN = 1e-3f, RHO_MAX = 20.0f, RHO_INIT = 1.0f;
  const bool vk = valid[k] != 0;
  const int inx = id_next[k], ipv = id_prev[k];
  const bool has_nb = vk && inx >= 0 && ipv >= 0;
  const int nx = min(max(inx, 0), p.K - 1);
  const int pv = min(max(ipv, 0), p.K - 1);
  const float rho0 = rho[k], sr0 = sr[k];
  const float rn = rho[nx], sn = sr[nx], gnx = grad[2 * nx], gny = grad[2 * nx + 1];
  const float gnn = gnorm[nx];
  const float rp = rho[pv], sp = sr[pv], gpx = grad[2 * pv], gpy = grad[2 * pv + 1];
  const float gnp = gnorm[pv];

  // --- regularize_1iter ---
  const float drp = rn - rp;
  const bool test1 = drp * drp <= (sn * sn + sp * sp);
  const float denom = gnn * gnp > 0.0f ? gnn * gnp : 1.0f;
  const float alpha = (gnx * gpx + gny * gpy) / denom;
  const bool apply = has_nb && test1 && (alpha >= p.thr);
  float alpha2 = (alpha - p.thr) / (1.0f - p.thr);
  alpha2 = alpha2 / (fabsf(rn - rp) / (sn + sp > 0.0f ? sn + sp : 1.0f) + 1.0f);
  const float sr_safe = sr0 > 0.0f ? sr0 : 1.0f;
  const float wr = 1.0f / (sr_safe * sr_safe);
  const float wrn = alpha2 / (sn > 0.0f ? sn * sn : 1.0f);
  const float wrp = alpha2 / (sp > 0.0f ? sp * sp : 1.0f);
  const float wsum = wr + wrn + wrp;
  const float rho1 = apply ? (rho0 * wr + rn * wrn + rp * wrp) / wsum : rho0;
  const float sr1 = apply ? (sr0 * wr + sn * wrn + sp * wrp) / wsum : sr0;

  // --- updateInverseDepthARLU on the blend ---
  const bool m = vk && match_id[k] >= 0;
  if (!m) {
    rho_out[k] = rho1;
    sr_out[k] = sr1;
    return;
  }
  const float v0 = vel[0], v1 = vel[1], v2 = vel[2];
  const float g = mgn[k] > 0.0f ? mgn[k] : 1.0f;
  const float ux = mgrad[2 * k] / g, uy = mgrad[2 * k + 1] / g;
  const float qx = pos_img[2 * k], qy = pos_img[2 * k + 1];
  const float q0x = mpos_img[2 * k], q0y = mpos_img[2 * k + 1];
  const float Y = ux * (qx - q0x) + uy * (qy - q0y);
  const float Hm = ux * (v0 * p.fm - v2 * q0x) + uy * (v1 * p.fm - v2 * q0y);
  const float v_rho = sr1 * sr1;
  const float rho_safe = rho1 != 0.0f ? rho1 : 1e-20f;
  const float rho_p = 1.0f / (1.0f / rho_safe + v2);
  const float F1 = 1.0f / (1.0f + rho1 * v2);
  const float F2 = F1 * F1;
  const float p_p = F2 * v_rho * F2 + p.q_abs2;
  const float e = Y - Hm * rho_p;
  const float S = Hm * p_p * Hm + p.pu2;
  const float Kk = p_p * Hm / S;
  float rho_new = rho_p + Kk * e;
  const float v_rho_new = (1.0f - Kk * Hm) * p_p;
  float sigma_new = sqrtf(v_rho_new);
  if (rho_new < RHO_MIN) sigma_new = sigma_new + (RHO_MIN - rho_new);
  // clamp that keeps NaN (jnp.clip semantics)
  rho_new = rho_new < RHO_MIN ? RHO_MIN : (rho_new > RHO_MAX ? RHO_MAX : rho_new);
  const bool bad = !isfinite(rho_new) || !isfinite(sigma_new);
  rho_out[k] = bad ? RHO_INIT : rho_new;
  sr_out[k] = bad ? RHO_MAX : sigma_new;
}

}  // namespace

extern "C" int rk_reg_ekf(const float* rho, const float* sr, const float* grad,
                          const float* gnorm, const int* id_next, const int* id_prev,
                          const unsigned char* valid, const int* match_id, const float* pos_img,
                          const float* mpos_img, const float* mgrad, const float* mgn,
                          const float* vel, int K, float thr, float q_abs2, float pu2, float fm,
                          float* rho_out, float* sr_out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Params p{K, thr, q_abs2, pu2, fm};
  reg_ekf<<<(K + 127) / 128, 128, 0, stream>>>(rho, sr, grad, gnorm, id_next, id_prev, valid,
                                               match_id, pos_img, mpos_img, mgrad, mgn, vel, p,
                                               rho_out, sr_out);
  return (int)cudaGetLastError();
}

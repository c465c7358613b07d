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
// Bound on the H100: bytes.  At 16000 keylines x 8 probes the least
// traffic is 13 [K] f32 planes in, 8 probes x (6 field + 4 dynamic) f32
// gathered, 12 [K] f32 planes out: ~6.6 MB, ~2 us at 3.35 TB/s.  What the
// first port lost: one thread per keyline walking its probes one after
// another (16000 threads, under one block per SM), each probe a chain of 6
// field gathers and then 4 `dyn` gathers on the id just read, with nothing
// in flight to hide that latency.
//
// Design: a group of G lanes per keyline (G the power of two >= P, at most
// 32; a lane loops over probes q, q + G, ... when P > 32): 128000 threads
// at the parity profile.  Every lane reads the keyline's planes itself
// (the G lanes of a group hit the same sector), projects its probe, makes
// the six field gathers and the two `dyn` gathers the gates need (rho,
// sigma_rho), with each probe's arithmetic the first port's, operation for
// operation.  The winner is an argmin over the group by __shfl_xor_sync on
// (prio, q): a smaller prio wins, on equal prio the smaller q (the first
// probe, as jnp.argmin); a prio that is not ok or NaN counts as 1e9, as
// tube_match_plain has it.  Only the winning lane gathers `matches` and the
// keyframe id and writes the twelve planes; without a winner it writes
// found 0, id -1, a zero payload and the prio.
//
// Lanes: blockIdx.y is the lane of B independent problems ([B, ...] planes,
// lane after lane; what torch.func.vmap of the step hands it, as jax.vmap
// of a pallas_call adds a grid axis); a lane's arithmetic is that of a
// launch of its own.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int K, N, P, H, W, fscale, Wf, G, log2G;
  float pum, cang_min, norm_thr;
};

__global__ void __launch_bounds__(kThreads)
    tube_match_kernel(const float* __restrict__ kls, const float* __restrict__ atts,
                      const float* __restrict__ dyns, const float* __restrict__ M2s, Params p,
                      float* __restrict__ outs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int K = p.K, N = p.N;
  const size_t ln = blockIdx.y;
  const float* kl = kls + ln * 13 * K;
  const float* att = atts + ln * 8 * N;
  const float* dyn = dyns + ln * 4 * K;
  const float* M2 = M2s + ln * 4;
  float* out = outs + ln * 12 * K;
  // groups past the last keyline repeat its work and write nothing: every
  // lane of a warp takes part in the shuffles
  const bool live = (t >> p.log2G) < K;
  const int k = live ? (t >> p.log2G) : K - 1;
  const int lane = t & (p.G - 1);
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
  const float span = dq_max - dq_min;
  // this lane's best probe: (prio, q) and the payload the gates read
  float best_prio = INFINITY;
  int best_q = INT_MAX;
  float b_oid = 0.f, b_rho = 0.f, b_sr = 0.f, b_gx = 0.f, b_gy = 0.f, b_gn = 0.f, b_sx = 0.f,
        b_sy = 0.f;
  int b_os = 0;
  for (int q = lane; q < p.P; q += p.G) {
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
    const float raw = fabsf(t_eff - dq_rho);
    const float prio = (ok && !isnan(raw)) ? raw : BIG;
    if (best_q == INT_MAX || prio < best_prio) {  // q rises: the first probe wins ties
      best_prio = prio;
      best_q = q;
      b_oid = oid; b_rho = rho_o; b_sr = sr_o; b_gx = gx_r; b_gy = gy_r;
      b_gn = gn_old; b_sx = sx; b_sy = sy; b_os = os;
    }
  }
  // argmin over the group on (prio, q); lanes without a probe hold
  // (inf, INT_MAX) and lose every tie
  const int mine = best_q;
  for (int off = p.G >> 1; off > 0; off >>= 1) {
    const float op = __shfl_xor_sync(kFull, best_prio, off);
    const int oq = __shfl_xor_sync(kFull, best_q, off);
    if (op < best_prio || (op == best_prio && oq < best_q)) {
      best_prio = op;
      best_q = oq;
    }
  }
  if (!live || mine != best_q) return;
  const bool found = best_prio < BIG;
  out[k] = found ? 1.0f : 0.0f;
  out[K + k] = found ? b_oid : -1.0f;
  const float pay[9] = {b_rho, b_sr, b_gx, b_gy, b_gn, b_sx, b_sy,
                        found ? dyn[2 * K + b_os] : 0.0f, found ? dyn[3 * K + b_os] : 0.0f};
#pragma unroll
  for (int j = 0; j < 9; ++j) out[(j + 2) * K + k] = found ? pay[j] : 0.0f;
  out[11 * K + k] = best_prio;
}

}  // namespace

// B lanes: kl [B, 13, K], att [B, 8, N], dyn [B, 4, K], M2 [B, 2, 2] ->
// out [B, 12, K].
extern "C" int rk_tube_match(const float* kl, const float* att, const float* dyn,
                             const float* M2, int B, int K, int N, int P, int H, int W,
                             int fscale, float pum, float cang_min, float norm_thr, float* out,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1 || B > 65535 || K < 1 || P < 2) return (int)cudaErrorInvalidValue;
  int log2G = 0;
  while ((1 << log2G) < P && log2G < 5) ++log2G;
  const int G = 1 << log2G;
  Params p{K, N, P, H, W, fscale, (W + fscale - 1) / fscale, G, log2G,
           pum, cang_min, norm_thr};
  const long long threads = (long long)K * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  tube_match_kernel<<<dim3(blocks, B), kThreads, 0, stream>>>(kl, att, dyn, M2, p, out);
  return (int)cudaGetLastError();
}

// K5: the depth stage -- the tube matcher's tail, the failure gate, depth
// regularization and the inverse-depth EKF -- in one call; and K5 alone
// (regularization and the EKF on a matched map) in one launch.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::reg_ekf_pallas and the XLA
// work the JAX step composes around it (rebvio_tpu/pipeline.py:227-253):
// directed_match_tube's winner write-back (ops/matching.py), the NaN and
// match-count gates with their _tree_where selects, then regularize_1iter
// (edge_map.cpp:220-259) and updateInverseDepthARLU (core.cpp:417-456) on
// the matched map.
//
// From K4's [12, K] output (found, match_id, rho, sigma_rho, grad_x,
// grad_y, grad_norm, seed_x, seed_y, matches, kf, prio) the matched map M
// (found keylines take the winner's fields; match_pos_img is the winner's
// seed through R_tot and the perspective divide); klm = the found count;
// fail_nan (a device flag) selects the unmatched map and klm 0; failed =
// fail_nan | klm < min_matches; then the depth update on M where not
// failed.  Outputs: the eight changed planes, klm, failed.
//
// K5 alone (tracker.regularize_and_update_depth, after the pixel walk of
// the reference-semantics step: rebvio_tpu/ops/tracker.py's reg_ekf_pallas
// with its two neighbour gathers) is one launch of reg_ekf_alone: the same
// per-keyline update (depth_update), its neighbours' depths read from the
// map as given, no count, no gate; 13 planes in, rho and sigma_rho out.
//
// Bound on the H100: launch latency.  At 16000 keylines the least traffic
// is K4's output (0.77 MB) and ~17 map planes read, the eight planes
// written (~2.5 MB in all): ~0.7 us at 3.35 TB/s, below one launch.  What
// the stage cost before was host work around a 3.6 us kernel: ~30 eager
// operations for the tail and two host syncs (the NaN and count gates).
// K5 alone reads 15 float planes and valid and writes two planes (~1.1 MB):
// ~0.33 us.  It ran as the fused call with nothing matched, which
// allocated an all-zero K4 output, eye(3) and a flag and launched both
// phases: two launches and three fills a frame.  Its launch reads only its
// own planes.
//
// Design of the fused stage: two launches from one C entry point, one
// thread per keyline.  Phase A counts the found keylines (a warp ballot,
// then one partial per block: no atomics and no buffer to zero); phase B
// sums the partials in block order (every block, the same sum), applies the
// gate and computes the keyline's outputs.  Regularization reads each neighbour's
// POST-match depth, found[nb] ? tube rho[nb] : rho[nb]: phase B recomputes
// it from K4's planes, so only the count crosses from A to B.  Every update
// reads pre-pass values (the reference's two-phase Jacobi update).  One
// cooperative launch with a grid sync between the phases gave the same
// outputs bit for bit but cost more between events (PERF.md).
// The 3x3 product and divide of the seed are summed in a fixed order, as
// the plain version writes them; --fmad=false keeps every product rounded.
//
// Lanes: blockIdx.y is the lane of B independent stages (what
// torch.func.vmap of the step hands it, as jax.vmap of a pallas_call adds a
// grid axis): each slot's pointer is lane 0's and a byte stride takes it to
// lane b; the partials, klm and failed are the lane's own.  A lane's
// arithmetic and its count's order are those of a launch of its own.  K5
// alone takes its lanes the same way, one launch for all B.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// ptr[] slots, in ops/kernels.py's _MRE_SLOTS order
enum Slot {
  RHO, SR, GRAD, GNORM, ID_NEXT, ID_PREV, VALID, MATCH_ID, POS_IMG, MPOS, MGRAD, MGN, VEL,
  TUBE, MATCHES, MKF, R_TOT, FAIL_NAN,
  RHO_OUT, SR_OUT, MID_OUT, MATCHES_OUT, MPOS_OUT, MGRAD_OUT, MGN_OUT, MKF_OUT, KLM, FAILED,
  PARTIAL, N_SLOTS
};

struct Params {
  const float *rho, *sr, *grad, *gnorm;
  const int *id_next, *id_prev;
  const unsigned char* valid;
  const int* match_id;
  const float *pos_img, *mpos, *mgrad, *mgn, *vel;
  const float* tube;
  const int *matches, *mkf;
  const float* R_tot;
  const unsigned char* fail_nan;
  float *rho_out, *sr_out;
  int *mid_out, *matches_out;
  float *mpos_out, *mgrad_out, *mgn_out;
  int *mkf_out, *klm;
  unsigned char* failed;
  int* partial;
  int K, min_matches;
  float thr, q_abs2, pu2, fm, cx, cy;
};

// A keyline's (rho, sigma_rho) as regularization sees it: with kMatch the
// post-match map's (the winner's where K4 found one), else the map's.
template <bool kMatch>
__device__ __forceinline__ void depth_of(const Params& p, int j, float& r, float& s) {
  if (kMatch && p.tube[j] > 0.5f) {
    r = p.tube[2 * p.K + j];
    s = p.tube[3 * p.K + j];
  } else {
    r = p.rho[j];
    s = p.sr[j];
  }
}

// regularize_1iter then updateInverseDepthARLU for keyline k, whose own
// (post-match) values are given; neighbours are read through depth_of.
template <bool kMatch>
__device__ void depth_update(const Params& p, int k, float rho0, float sr0, int mid,
                             float q0x, float q0y, float mgx, float mgy, float mgn,
                             float& rho_out, float& sr_out) {
  const float RHO_MIN = 1e-3f, RHO_MAX = 20.0f, RHO_INIT = 1.0f;
  const int K = p.K;
  const bool vk = p.valid[k] != 0;
  const int inx = p.id_next[k], ipv = p.id_prev[k];
  const bool has_nb = vk && inx >= 0 && ipv >= 0;
  const int nx = min(max(inx, 0), K - 1);
  const int pv = min(max(ipv, 0), K - 1);
  float rn, sn, rp, sp;
  depth_of<kMatch>(p, nx, rn, sn);
  depth_of<kMatch>(p, pv, rp, sp);
  const float gnx = p.grad[2 * nx], gny = p.grad[2 * nx + 1], gnn = p.gnorm[nx];
  const float gpx = p.grad[2 * pv], gpy = p.grad[2 * pv + 1], gnp = p.gnorm[pv];

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
  if (!(vk && mid >= 0)) {
    rho_out = rho1;
    sr_out = sr1;
    return;
  }
  const float v0 = p.vel[0], v1 = p.vel[1], v2 = p.vel[2];
  const float g = mgn > 0.0f ? mgn : 1.0f;
  const float ux = mgx / g, uy = mgy / g;
  const float qx = p.pos_img[2 * k], qy = p.pos_img[2 * k + 1];
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
  rho_out = bad ? RHO_INIT : rho_new;
  sr_out = bad ? RHO_MAX : sigma_new;
}

// Phase A: this block's found count, one partial per block.
__device__ __forceinline__ void count_found(const Params& p) {
  __shared__ int warp_sum[kThreads / 32];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const bool found = k < p.K && p.tube[k] > 0.5f;
  const int c = __popc(__ballot_sync(0xffffffffu, found));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
    for (int w = 0; w < kThreads / 32; ++w) b += warp_sum[w];
    p.partial[blockIdx.x] = b;
  }
}

// Phase B: the count (the partials summed in block order), the gate, the
// keyline's outputs.
__device__ __forceinline__ void gate_and_depth(const Params& p) {
  __shared__ int total;
  const int K = p.K;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) {
    int t = 0;
    for (int b = 0; b < (int)gridDim.x; ++b) t += p.partial[b];
    total = t;
  }
  __syncthreads();
  const bool fail_nan = *p.fail_nan != 0;
  const int klm = fail_nan ? 0 : total;
  const bool failed = fail_nan || klm < p.min_matches;
  if (k == 0) {
    *p.klm = klm;
    *p.failed = failed ? 1 : 0;
  }
  if (k >= K) return;

  // the matched map M (ops/kernels.py match_tail_plain, op for op)
  float rho = p.rho[k], sr = p.sr[k], mgn = p.mgn[k];
  float mpx = p.mpos[2 * k], mpy = p.mpos[2 * k + 1];
  float mgx = p.mgrad[2 * k], mgy = p.mgrad[2 * k + 1];
  int mid = p.match_id[k], matches = p.matches[k], mkf = p.mkf[k];
  if (p.tube[k] > 0.5f && !fail_nan) {
    const float* o = p.tube;
    rho = o[2 * K + k];
    sr = o[3 * K + k];
    mid = (int)o[K + k];
    matches = (int)o[9 * K + k] + 1;
    mgx = o[4 * K + k];
    mgy = o[5 * K + k];
    mgn = o[6 * K + k];
    mkf = (int)o[10 * K + k];
    const float* R = p.R_tot;
    const float vx = __fdiv_rn(o[7 * K + k] - p.cx, p.fm);
    const float vy = __fdiv_rn(o[8 * K + k] - p.cy, p.fm);
    const float p0x = (vx * R[0] + vy * R[1]) + R[2];
    const float p0y = (vx * R[3] + vy * R[4]) + R[5];
    float p0z = (vx * R[6] + vy * R[7]) + R[8];
    p0z = p0z != 0.0f ? p0z : 1e-20f;
    const float sc = __fdiv_rn(p.fm, p0z);
    mpx = p0x * sc;
    mpy = p0y * sc;
  }
  float rho_o = rho, sr_o = sr;
  if (!failed) depth_update<true>(p, k, rho, sr, mid, mpx, mpy, mgx, mgy, mgn, rho_o, sr_o);
  p.rho_out[k] = rho_o;
  p.sr_out[k] = sr_o;
  p.mid_out[k] = mid;
  p.matches_out[k] = matches;
  p.mpos_out[2 * k] = mpx;
  p.mpos_out[2 * k + 1] = mpy;
  p.mgrad_out[2 * k] = mgx;
  p.mgrad_out[2 * k + 1] = mgy;
  p.mgn_out[k] = mgn;
  p.mkf_out[k] = mkf;
}

// Lane 0's pointers, each slot's byte stride from one lane to the next, and
// the constants.
struct Launch {
  const char* ptr[N_SLOTS];
  long long stride[N_SLOTS];
  int K, min_matches;
  float thr, q_abs2, pu2, fm, cx, cy;
};

// The Params of lane blockIdx.y (each slot's pointer computed in place: no
// pointer array in local memory).
__device__ __forceinline__ Params lane_params(const Launch& L) {
  const long long b = blockIdx.y;
#define RK_SLOT(T, s) ((T)(L.ptr[s] + b * L.stride[s]))
  return Params{RK_SLOT(const float*, RHO), RK_SLOT(const float*, SR),
                RK_SLOT(const float*, GRAD), RK_SLOT(const float*, GNORM),
                RK_SLOT(const int*, ID_NEXT), RK_SLOT(const int*, ID_PREV),
                RK_SLOT(const unsigned char*, VALID), RK_SLOT(const int*, MATCH_ID),
                RK_SLOT(const float*, POS_IMG), RK_SLOT(const float*, MPOS),
                RK_SLOT(const float*, MGRAD), RK_SLOT(const float*, MGN),
                RK_SLOT(const float*, VEL), RK_SLOT(const float*, TUBE),
                RK_SLOT(const int*, MATCHES), RK_SLOT(const int*, MKF),
                RK_SLOT(const float*, R_TOT), RK_SLOT(const unsigned char*, FAIL_NAN),
                RK_SLOT(float*, RHO_OUT), RK_SLOT(float*, SR_OUT), RK_SLOT(int*, MID_OUT),
                RK_SLOT(int*, MATCHES_OUT), RK_SLOT(float*, MPOS_OUT),
                RK_SLOT(float*, MGRAD_OUT), RK_SLOT(float*, MGN_OUT), RK_SLOT(int*, MKF_OUT),
                RK_SLOT(int*, KLM), RK_SLOT(unsigned char*, FAILED), RK_SLOT(int*, PARTIAL),
                L.K, L.min_matches, L.thr, L.q_abs2, L.pu2, L.fm, L.cx, L.cy};
#undef RK_SLOT
}

// The two phases as two launches, the second ordered after the first by
// the stream.
__global__ void __launch_bounds__(kThreads) match_reg_ekf_count(Launch L) {
  count_found(lane_params(L));
}
__global__ void __launch_bounds__(kThreads) match_reg_ekf_gate(Launch L) {
  gate_and_depth(lane_params(L));
}

// K5 alone: only the depth update's slots and rho_out, sr_out are set.
__global__ void __launch_bounds__(kThreads) reg_ekf_alone(Launch L) {
  const Params p = lane_params(L);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  float r, s;
  depth_update<false>(p, k, p.rho[k], p.sr[k], p.match_id[k], p.mpos[2 * k],
                      p.mpos[2 * k + 1], p.mgrad[2 * k], p.mgrad[2 * k + 1], p.mgn[k], r, s);
  p.rho_out[k] = r;
  p.sr_out[k] = s;
}

}  // namespace

// ptr: N_SLOTS device pointers in Slot order, of lane 0 of B; stride: the
// byte stride of each slot from one lane to the next; partial holds one int
// per block of kThreads keylines, per lane.
extern "C" int rk_match_reg_ekf(void* const* ptr, const long long* stride, int B, int K,
                                int min_matches, float thr, float q_abs2, float pu2, float fm,
                                float cx, float cy, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (K < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < N_SLOTS; ++s)
    if (ptr[s] == nullptr) return (int)cudaErrorInvalidValue;
  Launch L;
  for (int s = 0; s < N_SLOTS; ++s) {
    L.ptr[s] = (const char*)ptr[s];
    L.stride[s] = stride[s];
  }
  L.K = K;
  L.min_matches = min_matches;
  L.thr = thr;
  L.q_abs2 = q_abs2;
  L.pu2 = pu2;
  L.fm = fm;
  L.cx = cx;
  L.cy = cy;
  const int blocks = (K + kThreads - 1) / kThreads;
  match_reg_ekf_count<<<dim3(blocks, B), kThreads, 0, stream>>>(L);
  match_reg_ekf_gate<<<dim3(blocks, B), kThreads, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

// K5 alone.  ptr: the 13 inputs (rho .. vel, the first 13 slots of Slot
// order) then rho_out and sigma_rho_out, of lane 0 of B; stride: each one's
// byte stride from one lane to the next.  One launch.
extern "C" int rk_reg_ekf(void* const* ptr, const long long* stride, int B, int K, float thr,
                          float q_abs2, float pu2, float fm, void* stream_ptr) {
  constexpr int kIn = VEL + 1, kArgs = kIn + 2;
  if (K < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < kArgs; ++s)
    if (ptr[s] == nullptr) return (int)cudaErrorInvalidValue;
  Launch L{};                                   // every other slot null
  for (int s = 0; s < kIn; ++s) {
    L.ptr[s] = (const char*)ptr[s];
    L.stride[s] = stride[s];
  }
  L.ptr[RHO_OUT] = (const char*)ptr[kIn];
  L.stride[RHO_OUT] = stride[kIn];
  L.ptr[SR_OUT] = (const char*)ptr[kIn + 1];
  L.stride[SR_OUT] = stride[kIn + 1];
  L.K = K;
  L.thr = thr;
  L.q_abs2 = q_abs2;
  L.pu2 = pu2;
  L.fm = fm;
  const int blocks = (K + kThreads - 1) / kThreads;
  reg_ekf_alone<<<dim3(blocks, B), kThreads, 0, (cudaStream_t)stream_ptr>>>(L);
  return (int)cudaGetLastError();
}

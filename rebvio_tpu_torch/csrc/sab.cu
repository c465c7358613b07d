// K3: the SAB filter's Gauss-Newton solve, posterior and re-fusion.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::estimate_bias_pallas (with
// _gj_inverse_mosaic): from the KF-predicted prior x_p, `iters`
// Gauss-Newton steps on the 11-D weighted residual of the scale / attitude
// / bias state X = [alpha, g(3), b(3)] with angle wrap and bias
// saturation (sab_estimator.cpp:21-165), then the posterior P = JtJ^-1,
// K = sin(alpha) / cos(alpha) clamped to 0 when negative or not finite,
// and the re-fusion of the rigid transform with the bias information
// (core.cpp:376-405).  The KF predict stays in PyTorch (ops/sab.py).
//
// Bound on the H100: latency.  The work is ~0.8 KB in and ~0.3 KB out and
// a few 1e4 float32 operations per call: far under a microsecond at the
// card's memory rate or its float32 peak.  What sets the time is the
// launch and the serial chain: every Gauss-Newton step depends on the
// last, and inside a step the products and the 7x7 elimination depend on
// each other.
//
// Design: one block of one warp, and as few dependent stages as the
// arithmetic allows (three __syncwarp() per Gauss-Newton step):
//  - everything 3x3 (the sines, the Rodrigues exponential, Pz, dP0, the
//    3x3 Gauss-Jordan inverse W0, dWda0, dWPdW0, d3, e3), the residual F,
//    dFda, the step's update, wrap and clamps are computed by every lane
//    for itself in registers: straight-line code, no lane-0 section;
//  - the products that do not depend on each other are one stage each: W @
//    [F | dFda | dFdx1] (88 outputs, one per lane-slot), then dFdx1^T @ [WF
//    | v | Wd] (48 outputs).  Only these operands live in shared memory,
//    because a lane picks its row and column by its index; the constant
//    zeros and ones of dFda and dFdx1 are written once;
//  - the 7x7 and 6x6 Gauss-Jordan inverses hold the [n, 2n] system one
//    column per lane in registers; a pivot step is n shuffles from the
//    pivot column's lane (the pivot among them), no shared memory, no sync;
//    inverse @ vector reads the inverse's columns by shuffles.
// The arithmetic is the Pallas body's, in its order, every output element
// the same chain of float32 operations as before the redesign: the
// Gauss-Jordan pivot row is multiplied by 1/piv, the step has the finite
// guard of gj_solve, the angle wrap is a - 2pi*rint(a/2pi) (jnp.round
// rounds half to even, as rintf does), clamps keep NaN, and K is sin/cos.
// Dot products sum in index order, structural zeros included (dense sums:
// 0 * inf stays NaN as in the plain version).  The Pallas body reads JtJ's
// bias block through 0/1 selector products, which equal the plain block
// reads used here for finite values.
//
// Lanes: block b (of B, one warp each) solves lane b of B independent
// problems, every input and output [B, ...] lane after lane (what
// torch.func.vmap of the step hands it, as jax.vmap of a pallas_call adds a
// grid axis); a lane's arithmetic is that of a launch of its own.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float INV_TWO_PI_F = 0.159154943091895335769f;
constexpr float BIAS_SAT = 0.02f;  // 5e-1 / 25, sab_estimator.cpp:34

// The operands that lanes index by their own row and column.
struct Smem {
  float W[11 * 11];   // rows 0-2: [W0 | 0], rows 3-10: W_rest
  float B[11 * 8];    // [F | dFda | dFdx1]
  float C[11 * 8];    // W @ B = [WF | WdFda | Wd]
  float JtJ[49], g6[6];
  float Wvw[36];
};

// What every lane holds of the inputs.
struct Inputs {
  float as[3], av[3], xp[7], Rs[9], Rv[9], G;
};

// C[3,3] = A @ B, each output summed in k order.
__device__ __forceinline__ void mm3(float (&C)[9], const float (&A)[9], const float (&B)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < 3; ++t) s = s + A[i * 3 + t] * B[t * 3 + j];
      C[i * 3 + j] = s;
    }
}

__device__ __forceinline__ void mv3(float (&c)[3], const float (&A)[9], const float* b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 3; ++t) s = s + A[i * 3 + t] * b[t];
    c[i] = s;
  }
}

// out = _gj_inverse_mosaic(m) for a 3x3 in registers: pivot-free
// Gauss-Jordan on [m | I], the pivot row multiplied by 1/piv, every other
// row minus fac * pivot row.
__device__ __forceinline__ void gj_inverse3(float (&out)[9], const float (&m)[9]) {
  float a[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) a[r][c] = c < 3 ? m[r * 3 + c] : (c - 3 == r ? 1.0f : 0.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float rp = 1.0f / a[i][i];
    float prow[6], fcol[3];
#pragma unroll
    for (int c = 0; c < 6; ++c) prow[c] = a[i][c] * rp;
#pragma unroll
    for (int r = 0; r < 3; ++r) fcol[r] = a[r][i];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) a[r][c] = r == i ? prow[c] : a[r][c] - fcol[r] * prow[c];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r * 3 + c] = a[r][3 + c];
}

// The same elimination on an [N, 2N] system held one column per lane: lane
// c < 2N owns a[0..N) = column c (lanes >= 2N run along on zeros).  The
// pivot and the factor column come from lane i by shuffles, read before any
// update of the step.  Afterwards lane N + c holds column c of the inverse.
template <int N>
__device__ __forceinline__ void gj_columns(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float f[N];
#pragma unroll
    for (int r = 0; r < N; ++r) f[r] = __shfl_sync(FULL, a[r], i);
    const float rp = 1.0f / f[i];
    const float prow = a[i] * rp;
#pragma unroll
    for (int r = 0; r < N; ++r) a[r] = r == i ? prow : a[r] - f[r] * prow;
  }
}

// out = inverse @ x, the inverse as gj_columns leaves it; every lane gets
// the whole vector, each entry summed in column order.
template <int N>
__device__ __forceinline__ void inverse_times(float (&out)[N], const float (&a)[N],
                                              const float (&x)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) s = s + __shfl_sync(FULL, a[r], N + t) * x[t];
    out[r] = s;
  }
}

// Rodrigues exponential with the Taylor guard (so3.exp semantics).
__device__ __forceinline__ void exp3(const float* w, float (&R)[9]) {
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float t = sqrtf(t2);
  const bool small = t2 < 1e-8f;
  const float ts = small ? 1.0f : t;
  const float a = small ? 1.0f - t2 / 6.0f : sinf(t) / ts;
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(t)) / (small ? 1.0f : t2);
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float ww = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) ww = ww + W[i * 3 + k] * W[k * 3 + j];
      R[i * 3 + j] = ((i == j ? 1.0f : 0.0f) + a * W[i * 3 + j]) + b * ww;
    }
}

template <int N>
__device__ __forceinline__ bool all_finite(const float (&a)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) ok = ok && isfinite(a[i]);
  return ok;
}

// (JtJ, JtF) of the weighted residual at Xc (the Pallas body's
// sab_problem).  JtJ goes to s.JtJ; JtF comes back in every lane.
__device__ __forceinline__ void sab_problem(Smem& s, const Inputs& in, const float (&Xc)[7],
                                            int lane, float (&JtF)[7]) {
  // --- every lane for itself: residual, its derivatives, the 3x3 block ---
  const float a = Xc[0];
  const float* g = Xc + 1;
  const float* b = Xc + 4;
  const float sa = sinf(a), ca = cosf(a);
  float da = a - in.xp[0];
  da = da > PI_F ? da - TWO_PI_F : (da < -PI_F ? da + TWO_PI_F : da);
  float Rb[9], Rg[3];
  exp3(b, Rb);
  mv3(Rg, Rb, g);
  float F[11], dFda[11];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    F[i] = (in.as[i] + g[i]) * ca - in.av[i] * sa;
    dFda[i] = -(in.as[i] + g[i]) * sa - in.av[i] * ca;
    F[5 + i] = Rg[i] - in.xp[1 + i];
    F[8 + i] = b[i] - in.xp[4 + i];
  }
  {
    float gg = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) gg = gg + g[i] * g[i];
    F[3] = gg - in.G * in.G;
  }
  F[4] = da;
  dFda[3] = 0.0f;
  dFda[4] = 1.0f;
#pragma unroll
  for (int i = 5; i < 11; ++i) dFda[i] = 0.0f;
  // B = [F | dFda | dFdx1], dF/d[g, b] = [ca*I 0; 2g^T 0; 0; Rb -[Rg]x; 0 I]:
  // the entries that change (every lane stores the same values)
#pragma unroll
  for (int t = 0; t < 11; ++t) s.B[t * 8] = F[t];
  const float Gx[9] = {0.0f, Rg[2], -Rg[1], -Rg[2], 0.0f, Rg[0], Rg[1], -Rg[0], 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.B[i * 8 + 1] = dFda[i];
    s.B[i * 8 + 2 + i] = ca;
    s.B[3 * 8 + 2 + i] = 2.0f * g[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s.B[(5 + i) * 8 + 2 + j] = Rb[i * 3 + j];
      if (i != j) s.B[(5 + i) * 8 + 5 + j] = Gx[i * 3 + j];
    }
  }
  const float sa2 = sa * sa, ca2 = ca * ca, sc2 = 2.0f * sa * ca;
  float Pz[9], dP0[9], W0[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    Pz[e] = sa2 * in.Rv[e] + ca2 * in.Rs[e];
    dP0[e] = sc2 * (in.Rv[e] - in.Rs[e]);
  }
  gj_inverse3(W0, Pz);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) s.W[r * 11 + c] = W0[r * 3 + c];
  __syncwarp();

  // --- stage 1: C = W @ B, 88 outputs over the lanes ---
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    const int e = lane + WARP * slot;
    if (e < 88) {
      const int r = e >> 3, c = e & 7;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 11; ++t) acc = acc + s.W[r * 11 + t] * s.B[t * 8 + c];
      s.C[e] = acc;
    }
  }
  // meanwhile, in registers: dWda0 = -(W0 dP0 W0), dWPdW0 = dWda0 Pz dWda0
  float t33[9], dWda0[9], dWPdW0[9], d3[3], e3[3];
  mm3(t33, W0, dP0);
  mm3(dWda0, t33, W0);
#pragma unroll
  for (int e = 0; e < 9; ++e) dWda0[e] = -dWda0[e];
  mm3(t33, dWda0, Pz);
  mm3(dWPdW0, t33, dWda0);
  mv3(d3, dWda0, F);       // dWda0 @ F0
  mv3(e3, dWPdW0, F);      // dWPdW0 @ F0
  __syncwarp();

  // --- stage 2: dFdx1^T @ [WF | v | Wd], 48 outputs over the lanes ---
  float WF[11], WdFda[11], v[11];
#pragma unroll
  for (int t = 0; t < 11; ++t) {
    WF[t] = s.C[t * 8];
    WdFda[t] = s.C[t * 8 + 1];
    v[t] = 0.5f * (t < 3 ? d3[t] : 0.0f) + WdFda[t];
  }
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int e = lane + WARP * slot;
    if (e < 48) {
      const int i = e >> 3, c = e & 7;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 11; ++t)
        acc = acc + s.B[t * 8 + 2 + i] * (c == 1 ? v[t] : s.C[t * 8 + c]);
      if (c == 0) {
        s.g6[i] = acc;                       // dFdx1^T @ WF
      } else if (c == 1) {
        s.JtJ[1 + i] = acc;                  // col: first row and first column
        s.JtJ[(1 + i) * 7] = acc;
      } else {
        s.JtJ[(1 + i) * 7 + c - 1] = acc;    // blk = dFdx1^T @ W @ dFdx1
      }
    }
  }
  {
    float F0e3 = 0.0f, dd3 = 0.0f, dWd = 0.0f, F0d3 = 0.0f, dWF = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      F0e3 = F0e3 + F[i] * e3[i];
      dd3 = dd3 + dFda[i] * d3[i];
      F0d3 = F0d3 + F[i] * d3[i];
    }
#pragma unroll
    for (int t = 0; t < 11; ++t) {
      dWd = dWd + dFda[t] * WdFda[t];
      dWF = dWF + dFda[t] * WF[t];
    }
    s.JtJ[0] = (0.25f * F0e3 + dd3) + dWd;
    JtF[0] = 0.5f * F0d3 + dWF;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 6; ++i) JtF[1 + i] = s.g6[i];
}

// Column `lane` of [m | I] for an [N, N] matrix m in shared memory.
template <int N>
__device__ __forceinline__ void load_columns(float (&a)[N], const float* m, int lane) {
#pragma unroll
  for (int r = 0; r < N; ++r)
    a[r] = lane < N ? m[r * N + lane] : (lane - N == r ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(WARP)
estimate_bias_kernel(const float* __restrict__ a_s, const float* __restrict__ a_v,
                     const float* __restrict__ x_p, const float* __restrict__ W_rest,
                     const float* __restrict__ Rs, const float* __restrict__ Rv,
                     const float* __restrict__ Wvw, const float* __restrict__ Xvw_in,
                     const float* __restrict__ g_gravit, int iters,
                     float* __restrict__ K_out, float* __restrict__ X_out,
                     float* __restrict__ P_out, float* __restrict__ Xvw_out) {
  __shared__ Smem s;
  const int lane = threadIdx.x;
  {  // this block's problem
    const size_t b = blockIdx.x;
    a_s += 3 * b;
    a_v += 3 * b;
    x_p += 7 * b;
    W_rest += 88 * b;
    Rs += 9 * b;
    Rv += 9 * b;
    Wvw += 36 * b;
    Xvw_in += 6 * b;
    g_gravit += b;
    K_out += b;
    X_out += 7 * b;
    P_out += 49 * b;
    Xvw_out += 6 * b;
  }
  // shared operands: W_rest, the zeros beside W0, the constant part of B
  for (int e = lane; e < 121; e += WARP) s.W[e] = e < 33 ? 0.0f : W_rest[e - 33];
  for (int e = lane; e < 88; e += WARP) s.B[e] = 0.0f;
  for (int e = lane; e < 36; e += WARP) s.Wvw[e] = Wvw[e];
  __syncwarp();
  if (lane == 0) {
    s.B[4 * 8 + 1] = 1.0f;                                             // dFda[4]
    for (int i = 0; i < 3; ++i) s.B[(8 + i) * 8 + 5 + i] = 1.0f;       // dF/db of b - x_p
  }
  Inputs in;
  float Xc[7], Xvw[6];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    in.as[e] = a_s[e];
    in.av[e] = a_v[e];
  }
#pragma unroll
  for (int e = 0; e < 7; ++e) {
    in.xp[e] = x_p[e];
    Xc[e] = in.xp[e];
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    in.Rs[e] = Rs[e];
    in.Rv[e] = Rv[e];
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) Xvw[e] = Xvw_in[e];
  in.G = g_gravit[0];
  __syncwarp();

  float JtF[7], col[7];
  // --- Gauss-Newton with wrap and saturation (sab_gauss_newton) ---
  for (int it = 0; it < iters; ++it) {
    sab_problem(s, in, Xc, lane, JtF);
    load_columns<7>(col, s.JtJ, lane);
    // gj_solve semantics: finite input with a non-finite step -> zero step
    const bool fin = __all_sync(FULL, lane >= 7 || all_finite(col)) && all_finite(JtF);
    gj_columns<7>(col);
    float negF[7], hx[7];
#pragma unroll
    for (int e = 0; e < 7; ++e) negF[e] = -JtF[e];
    inverse_times<7>(hx, col, negF);
    const bool zero = fin && !all_finite(hx);
#pragma unroll
    for (int e = 0; e < 7; ++e) Xc[e] = Xc[e] + (zero ? 0.0f : hx[e]);
    Xc[0] = Xc[0] - TWO_PI_F * rintf(Xc[0] * INV_TWO_PI_F);
#pragma unroll
    for (int e = 4; e < 7; ++e) {
      const float x = Xc[e];
      Xc[e] = x < -BIAS_SAT ? -BIAS_SAT : (x > BIAS_SAT ? BIAS_SAT : x);  // keeps NaN
    }
    __syncwarp();   // the step's reads of shared memory end before the next one's writes
  }

  // --- posterior ---
  sab_problem(s, in, Xc, lane, JtF);
  load_columns<7>(col, s.JtJ, lane);
  gj_columns<7>(col);
  if (lane >= 7 && lane < 14) {
#pragma unroll
    for (int r = 0; r < 7; ++r) P_out[r * 7 + lane - 7] = col[r];
  }

  // --- re-fuse the rigid transform with the bias information (core.cpp:394-405) ---
  float m6[6], rhs[6], wc[3], Xcor[6];
  load_columns<6>(m6, s.Wvw, lane);
#pragma unroll
  for (int r = 3; r < 6; ++r)
    if (lane >= 3 && lane < 6) m6[r] += s.JtJ[(1 + r) * 7 + 1 + lane];
#pragma unroll
  for (int i = 0; i < 3; ++i) wc[i] = Xvw[3 + i] - Xc[4 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) t = t + s.Wvw[6 * i + j] * Xvw[j];
    rhs[i] = t;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) t = t + s.JtJ[(4 + i) * 7 + 4 + j] * wc[j];
    rhs[3 + i] = rhs[3 + i] + t;
  }
  gj_columns<6>(m6);
  inverse_times<6>(Xcor, m6, rhs);
  if (lane == 0) {
    const float k = sinf(Xc[0]) / cosf(Xc[0]);
    K_out[0] = (k < 0.0f || !isfinite(k)) ? 0.0f : k;
#pragma unroll
    for (int e = 0; e < 7; ++e) X_out[e] = Xc[e];
#pragma unroll
    for (int e = 0; e < 6; ++e) Xvw_out[e] = Xcor[e];
  }
}

}  // namespace

extern "C" int rk_estimate_bias(const float* a_s, const float* a_v, const float* x_p,
                                const float* W_rest, const float* Rs, const float* Rv,
                                const float* Wvw, const float* Xvw, const float* g_gravit,
                                int iters, float* K_out, float* X_out, float* P_out,
                                float* Xvw_out, int B, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1) return (int)cudaErrorInvalidValue;
  estimate_bias_kernel<<<B, WARP, 0, stream>>>(a_s, a_v, x_p, W_rest, Rs, Rv, Wvw, Xvw,
                                               g_gravit, iters, K_out, X_out, P_out, Xvw_out);
  return (int)cudaGetLastError();
}

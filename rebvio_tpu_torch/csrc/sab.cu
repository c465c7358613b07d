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
// last, and inside a step the products and the 7x7 elimination are
// dependent stages.
//
// Design: one block of one warp.  Every matrix lives in shared memory
// (the [7,14] augmented system, the 11x11 weight and the 11x6 Jacobian
// products); each product or elimination stage spreads its output
// elements over the 32 lanes and ends with __syncwarp(); the scalar set-up
// of a stage (sines, the Rodrigues exponential, the residual) runs on
// lane 0.  The arithmetic is the Pallas body's, in its order: the
// Gauss-Jordan pivot row is multiplied by 1/piv, the step has the finite
// guard of gj_solve, the angle wrap is a - 2pi*rint(a/2pi) (jnp.round
// rounds half to even, as rintf does), clamps keep NaN, and K is sin/cos.
// Dot products sum in index order.  The Pallas body reads JtJ's bias block
// through 0/1 selector products, which equal the plain block reads used
// here for finite values.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float INV_TWO_PI_F = 0.159154943091895335769f;
constexpr float BIAS_SAT = 0.02f;  // 5e-1 / 25, sab_estimator.cpp:34

struct Smem {
  // inputs
  float as[3], av[3], xp[7], wrest[8 * 11], Rs[9], Rv[9], Wvw[36], Xvw[6], G;
  // state and problem
  float Xc[7], Rb[9], F[11], dFda[11], dFdx1[11 * 6], Pz[9], dP0[9];
  float W0[9], W[11 * 11], t33[9], dWda0[9], dWPdW0[9], d3[3], e3[3];
  float WF[11], WdFda[11], Wd[11 * 6], v[11], col[6], blk[36], g6[6];
  float JtJ[49], JtF[7], negF[7], inv[49], hx[7];
  // Gauss-Jordan workspace
  float aug[7 * 14], prow[14], fcol[7];
  // re-fusion
  float M6[36], rhs[6], Xcor[6];
};

// C[n,m] = A[n,k] @ B[k,m]; each output sums in k order.  C aliases neither.
__device__ void mm(float* C, const float* A, const float* B, int n, int k, int m, int lane) {
  for (int e = lane; e < n * m; e += WARP) {
    const int i = e / m, j = e % m;
    float s = 0.0f;
    for (int t = 0; t < k; ++t) s = s + A[i * k + t] * B[t * m + j];
    C[e] = s;
  }
  __syncwarp();
}

// C[n,m] = A^T @ B with A stored [k,n].
__device__ void mmT(float* C, const float* A, const float* B, int n, int k, int m, int lane) {
  for (int e = lane; e < n * m; e += WARP) {
    const int i = e / m, j = e % m;
    float s = 0.0f;
    for (int t = 0; t < k; ++t) s = s + A[t * n + i] * B[t * m + j];
    C[e] = s;
  }
  __syncwarp();
}

// out[n,n] = _gj_inverse_mosaic(m): pivot-free Gauss-Jordan on [m | I],
// the pivot row multiplied by 1/piv, every other row minus fac * pivot row.
__device__ void gj_inverse(float* out, const float* m, int n, Smem& s, int lane) {
  const int w = 2 * n;
  float* a = s.aug;
  for (int e = lane; e < n * w; e += WARP) {
    const int r = e / w, c = e % w;
    a[e] = c < n ? m[r * n + c] : (c - n == r ? 1.0f : 0.0f);
  }
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const float rp = 1.0f / a[i * w + i];
    for (int c = lane; c < w; c += WARP) s.prow[c] = a[i * w + c] * rp;
    for (int r = lane; r < n; r += WARP) s.fcol[r] = a[r * w + i];
    __syncwarp();
    for (int e = lane; e < n * w; e += WARP) {
      const int r = e / w, c = e % w;
      a[e] = r == i ? s.prow[c] : a[e] - s.fcol[r] * s.prow[c];
    }
    __syncwarp();
  }
  for (int e = lane; e < n * n; e += WARP) out[e] = a[(e / n) * w + n + e % n];
  __syncwarp();
}

// Rodrigues exponential with the Taylor guard (so3.exp semantics).
__device__ void exp3(const float* w, float* R) {
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float t = sqrtf(t2);
  const bool small = t2 < 1e-8f;
  const float ts = small ? 1.0f : t;
  const float a = small ? 1.0f - t2 / 6.0f : sinf(t) / ts;
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(t)) / (small ? 1.0f : t2);
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float ww = 0.0f;
      for (int k = 0; k < 3; ++k) ww = ww + W[i * 3 + k] * W[k * 3 + j];
      R[i * 3 + j] = ((i == j ? 1.0f : 0.0f) + a * W[i * 3 + j]) + b * ww;
    }
}

__device__ float dot(const float* a, const float* b, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s = s + a[i] * b[i];
  return s;
}

__device__ bool all_finite(const float* a, int n) {
  for (int i = 0; i < n; ++i)
    if (!isfinite(a[i])) return false;
  return true;
}

// (JtJ, JtF) of the weighted residual at s.Xc (the Pallas body's sab_problem).
__device__ void sab_problem(Smem& s, int lane) {
  if (lane == 0) {
    const float a = s.Xc[0];
    const float* g = s.Xc + 1;
    const float* b = s.Xc + 4;
    const float sa = sinf(a), ca = cosf(a);
    float da = a - s.xp[0];
    da = da > PI_F ? da - TWO_PI_F : (da < -PI_F ? da + TWO_PI_F : da);
    exp3(b, s.Rb);
    float Rg[3];
    for (int i = 0; i < 3; ++i) Rg[i] = dot(s.Rb + 3 * i, g, 3);
    for (int i = 0; i < 3; ++i) {
      s.F[i] = (s.as[i] + g[i]) * ca - s.av[i] * sa;
      s.dFda[i] = -(s.as[i] + g[i]) * sa - s.av[i] * ca;
      s.F[5 + i] = Rg[i] - s.xp[1 + i];
      s.F[8 + i] = b[i] - s.xp[4 + i];
    }
    s.F[3] = dot(g, g, 3) - s.G * s.G;
    s.F[4] = da;
    s.dFda[3] = 0.0f;
    s.dFda[4] = 1.0f;
    for (int i = 5; i < 11; ++i) s.dFda[i] = 0.0f;
    // dF/d[g, b] (11x6): [ca*I 0; 2g^T 0; 0; Rb -[Rg]x; 0 I]
    for (int e = 0; e < 66; ++e) s.dFdx1[e] = 0.0f;
    for (int i = 0; i < 3; ++i) {
      s.dFdx1[i * 6 + i] = ca;
      s.dFdx1[3 * 6 + i] = 2.0f * g[i];
      for (int j = 0; j < 3; ++j) s.dFdx1[(5 + i) * 6 + j] = s.Rb[i * 3 + j];
      s.dFdx1[(8 + i) * 6 + 3 + i] = 1.0f;
    }
    const float Gx[9] = {0.0f, Rg[2], -Rg[1], -Rg[2], 0.0f, Rg[0], Rg[1], -Rg[0], 0.0f};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) s.dFdx1[(5 + i) * 6 + 3 + j] = Gx[i * 3 + j];
    const float sa2 = sa * sa, ca2 = ca * ca, sc2 = 2.0f * sa * ca;
    for (int e = 0; e < 9; ++e) {
      s.Pz[e] = sa2 * s.Rv[e] + ca2 * s.Rs[e];
      s.dP0[e] = sc2 * (s.Rv[e] - s.Rs[e]);
    }
  }
  __syncwarp();
  gj_inverse(s.W0, s.Pz, 3, s, lane);
  for (int e = lane; e < 121; e += WARP) {
    const int r = e / 11, c = e % 11;
    s.W[e] = r < 3 ? (c < 3 ? s.W0[r * 3 + c] : 0.0f) : s.wrest[(r - 3) * 11 + c];
  }
  __syncwarp();
  mm(s.t33, s.W0, s.dP0, 3, 3, 3, lane);
  mm(s.dWda0, s.t33, s.W0, 3, 3, 3, lane);
  for (int e = lane; e < 9; e += WARP) s.dWda0[e] = -s.dWda0[e];
  __syncwarp();
  mm(s.t33, s.dWda0, s.Pz, 3, 3, 3, lane);
  mm(s.dWPdW0, s.t33, s.dWda0, 3, 3, 3, lane);
  mm(s.d3, s.dWda0, s.F, 3, 3, 1, lane);       // dWda0 @ F0
  mm(s.e3, s.dWPdW0, s.F, 3, 3, 1, lane);      // dWPdW0 @ F0
  mm(s.WF, s.W, s.F, 11, 11, 1, lane);
  mm(s.WdFda, s.W, s.dFda, 11, 11, 1, lane);
  mm(s.Wd, s.W, s.dFdx1, 11, 11, 6, lane);
  for (int e = lane; e < 11; e += WARP) s.v[e] = 0.5f * (e < 3 ? s.d3[e] : 0.0f) + s.WdFda[e];
  __syncwarp();
  mmT(s.col, s.dFdx1, s.v, 6, 11, 1, lane);
  mmT(s.blk, s.dFdx1, s.Wd, 6, 11, 6, lane);
  mmT(s.g6, s.dFdx1, s.WF, 6, 11, 1, lane);
  if (lane == 0) {
    const float F0d3 = dot(s.F, s.d3, 3);
    s.JtJ[0] = (0.25f * dot(s.F, s.e3, 3) + dot(s.dFda, s.d3, 3)) + dot(s.dFda, s.WdFda, 11);
    s.JtF[0] = 0.5f * F0d3 + dot(s.dFda, s.WF, 11);
  }
  for (int e = lane; e < 49; e += WARP) {
    const int r = e / 7, c = e % 7;
    if (r == 0 && c == 0) continue;
    s.JtJ[e] = r == 0 ? s.col[c - 1] : (c == 0 ? s.col[r - 1] : s.blk[(r - 1) * 6 + c - 1]);
  }
  for (int e = lane; e < 6; e += WARP) s.JtF[1 + e] = s.g6[e];
  __syncwarp();
}

__global__ void estimate_bias_kernel(const float* __restrict__ a_s, const float* __restrict__ a_v,
                                     const float* __restrict__ x_p,
                                     const float* __restrict__ W_rest,
                                     const float* __restrict__ Rs, const float* __restrict__ Rv,
                                     const float* __restrict__ Wvw,
                                     const float* __restrict__ Xvw,
                                     const float* __restrict__ g_gravit, int iters,
                                     float* __restrict__ K_out, float* __restrict__ X_out,
                                     float* __restrict__ P_out, float* __restrict__ Xvw_out) {
  __shared__ Smem s;
  const int lane = threadIdx.x;
  for (int e = lane; e < 88; e += WARP) s.wrest[e] = W_rest[e];
  for (int e = lane; e < 36; e += WARP) s.Wvw[e] = Wvw[e];
  for (int e = lane; e < 9; e += WARP) {
    s.Rs[e] = Rs[e];
    s.Rv[e] = Rv[e];
  }
  for (int e = lane; e < 7; e += WARP) {
    s.xp[e] = x_p[e];
    s.Xc[e] = x_p[e];
  }
  for (int e = lane; e < 6; e += WARP) s.Xvw[e] = Xvw[e];
  for (int e = lane; e < 3; e += WARP) {
    s.as[e] = a_s[e];
    s.av[e] = a_v[e];
  }
  if (lane == 0) s.G = g_gravit[0];
  __syncwarp();

  // --- Gauss-Newton with wrap and saturation (sab_gauss_newton) ---
  for (int it = 0; it < iters; ++it) {
    sab_problem(s, lane);
    gj_inverse(s.inv, s.JtJ, 7, s, lane);
    for (int e = lane; e < 7; e += WARP) s.negF[e] = -s.JtF[e];
    __syncwarp();
    mm(s.hx, s.inv, s.negF, 7, 7, 1, lane);
    if (lane == 0) {
      // gj_solve semantics: finite input with a non-finite step -> zero step
      const bool fin = all_finite(s.JtJ, 49) && all_finite(s.JtF, 7);
      const bool zero = fin && !all_finite(s.hx, 7);
      for (int e = 0; e < 7; ++e) s.Xc[e] = s.Xc[e] + (zero ? 0.0f : s.hx[e]);
      const float a = s.Xc[0];
      s.Xc[0] = a - TWO_PI_F * rintf(a * INV_TWO_PI_F);
      for (int e = 4; e < 7; ++e) {
        const float x = s.Xc[e];
        s.Xc[e] = x < -BIAS_SAT ? -BIAS_SAT : (x > BIAS_SAT ? BIAS_SAT : x);  // keeps NaN
      }
    }
    __syncwarp();
  }

  // --- posterior ---
  sab_problem(s, lane);
  gj_inverse(s.inv, s.JtJ, 7, s, lane);
  for (int e = lane; e < 49; e += WARP) P_out[e] = s.inv[e];

  // --- re-fuse the rigid transform with the bias information (core.cpp:394-405) ---
  if (lane == 0) {
    const float af = s.Xc[0];
    float k = sinf(af) / cosf(af);
    K_out[0] = (k < 0.0f || !isfinite(k)) ? 0.0f : k;
    for (int e = 0; e < 7; ++e) X_out[e] = s.Xc[e];
    for (int e = 0; e < 36; ++e) s.M6[e] = s.Wvw[e];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) s.M6[(3 + i) * 6 + 3 + j] += s.JtJ[(4 + i) * 7 + 4 + j];
    float wc[3];
    for (int i = 0; i < 3; ++i) wc[i] = s.Xvw[3 + i] - s.Xc[4 + i];
    for (int i = 0; i < 6; ++i) s.rhs[i] = dot(s.Wvw + 6 * i, s.Xvw, 6);
    for (int i = 0; i < 3; ++i) {
      float t = 0.0f;
      for (int j = 0; j < 3; ++j) t = t + s.JtJ[(4 + i) * 7 + 4 + j] * wc[j];
      s.rhs[3 + i] = s.rhs[3 + i] + t;
    }
  }
  __syncwarp();
  gj_inverse(s.inv, s.M6, 6, s, lane);
  mm(s.Xcor, s.inv, s.rhs, 6, 6, 1, lane);
  for (int e = lane; e < 6; e += WARP) Xvw_out[e] = s.Xcor[e];
}

}  // namespace

extern "C" int rk_estimate_bias(const float* a_s, const float* a_v, const float* x_p,
                                const float* W_rest, const float* Rs, const float* Rv,
                                const float* Wvw, const float* Xvw, const float* g_gravit,
                                int iters, float* K_out, float* X_out, float* P_out,
                                float* Xvw_out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  estimate_bias_kernel<<<1, WARP, 0, stream>>>(a_s, a_v, x_p, W_rest, Rs, Rv, Wvw, Xvw,
                                               g_gravit, iters, K_out, X_out, P_out, Xvw_out);
  return (int)cudaGetLastError();
}

// The field cell a keyline seeds (K1b's and K7's scatters: flood.cu and
// seed_scatter.cu), as the Pallas wrappers compute it: p = pos * inv_s with
// one rounded multiply (inv_s is float32(1/scale)), cell = floor(p + 0.5);
// false for a cell outside the field.  The comparisons are in float, so NaN
// and far-out coordinates fail them.
#pragma once

__device__ __forceinline__ bool seed_cell(const float* p, float inv_s, int rows, int cols,
                                          int& cell) {
  const float px = __fmul_rn(p[0], inv_s);
  const float py = __fmul_rn(p[1], inv_s);
  const float fc = floorf(__fadd_rn(px, 0.5f));
  const float fr = floorf(__fadd_rn(py, 0.5f));
  if (!(fr >= 0.0f && fr < (float)rows && fc >= 0.0f && fc < (float)cols)) return false;
  cell = (int)fr * cols + (int)fc;
  return true;
}

// Per-cell arithmetic of one TE leapfrog step on a row-major float32 layout.
//
// Ez, Hx and Hy share one layout whose row stride is `stride`: the padded
// (N, M) fields in device memory (K1, stride M) or a window of them in
// shared memory (K2, the window's row stride). Hx's last column and Hy's
// last row are phantom cells that no function here reads or writes. The
// update coefficients are passed by value, so the caller reads ce and ch
// from wherever it keeps them. The staging (which stage reads which stage's
// output) is the caller's job; see fdtd_fused.cu and fdtd_ttiled.cu.
//
// Semantics: fdtd2d_tpu_torch/fdtd/step.py::fdtd_step (the plain path), itself
// held against the float64 NumPy oracle fdtd2d_tpu/fdtd/reference.py.
#pragma once

namespace fdtd {

constexpr int kBand = 5;            // Mur band width (MUR_BAND)
constexpr int kStrip = kBand + 1;   // pre-step Ez values a band cell chain reads

// The cell updates on values, for callers that keep the fields in registers
// (fdtd_ttiled.cu's interior body, fdtd_fused.cu's resident kernel and band
// chains). The memory forms below are
// written with them, so every kernel computes each cell with one expression
// and nvcc contracts it into the same FMAs: a cell's value does not depend
// on which body or tile computed it. c is ch (H) or ce (Ez) at the cell.
__device__ __forceinline__ float hx_next(float hx, float c, float e_down, float e) {
  return hx - c * (e_down - e);
}
__device__ __forceinline__ float hy_next(float hy, float c, float e_right, float e) {
  return hy + c * (e_right - e);
}
__device__ __forceinline__ float ez_next(float ez, float c, float hy, float hy_left,
                                         float hx, float hx_up) {
  const float curl = (hy - hy_left) - (hx - hx_up);
  return ez + curl * c;
}

// One Mur band cell on values: p_in and c_in are the pre-step and current Ez
// of the next cell inward, p_self the pre-step Ez of the cell itself.
__device__ __forceinline__ float mur_next(float p_in, float c_in, float p_self, float coef) {
  return p_in + coef * (c_in - p_self);
}
// One corner cell on values: the mean of its two inward neighbours.
__device__ __forceinline__ float corner_mean(float a, float b) { return (a + b) * 0.5f; }

// H update of the cell at index k, which has a row below it and a column to
// its right (domain 0 <= i < N-1, 0 <= j < M-1); c is ch at the cell.
__device__ __forceinline__ void h_update(const float* __restrict__ ez, float c,
                                         float* __restrict__ hx,
                                         float* __restrict__ hy, int k,
                                         int stride) {
  const float e00 = ez[k];
  hx[k] = hx_next(hx[k], c, ez[k + stride], e00);
  hy[k] = hy_next(hy[k], c, ez[k + 1], e00);
}

// Interior Ez update of the cell at index k, which has a row above it and a
// column to its left (domain 1 <= i < N-1, 1 <= j < M-1); c is ce at the cell.
__device__ __forceinline__ void e_interior(float* __restrict__ ez,
                                          const float* __restrict__ hx,
                                          const float* __restrict__ hy,
                                          float c, int k, int stride) {
  ez[k] = ez_next(ez[k], c, hy[k], hy[k - 1], hx[k], hx[k - stride]);
}

// One Mur band chain: e[0] is the edge cell and e[s*es], s = 1..5, step
// inward; p[s*ps] holds the pre-step Ez of the same cells. Cell s reads cell
// s+1, which this chain also writes, so all six current values are loaded
// before any store. Left band: e = &ez[i][0], es = +1; right band:
// e = &ez[i][M-1], es = -1; top: e = &ez[0][j], es = +stride; bottom:
// e = &ez[N-1][j], es = -stride. Seen from its edge, each band is the same
// update.
__device__ __forceinline__ void mur_chain(float* e, int es, const float* p,
                                          int ps, float coef) {
  float cur[kStrip];
  float prev[kStrip];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    cur[s] = e[s * es];
    prev[s] = p[s * ps];
  }
#pragma unroll
  for (int s = 0; s < kBand; ++s) {
    e[s * es] = mur_next(prev[s + 1], cur[s + 1], prev[s], coef);
  }
}

// Corner averaging value for cell (a, b), 0 <= a, b < 5, of one corner:
// c points at the corner cell, rs and cs step inward along rows and columns.
// Value = (c[a][b+1] + c[a+1][b]) / 2 in the corner's own frame. The
// reference's four index patterns (pallas_fdtd.py:99-106) are this one
// stencil seen from each corner: top-left (rs, cs) = (+stride, +1), top-right
// (+stride, -1), bottom-left (-stride, +1), bottom-right (-stride, -1). Reads
// must all happen before any cell of the corner is written.
__device__ __forceinline__ float corner_value(const float* c, int rs, int cs,
                                              int a, int b) {
  return corner_mean(c[a * rs + (b + 1) * cs], c[(a + 1) * rs + b * cs]);
}

}  // namespace fdtd

// The complex128 work of an FDFD refinement round (fdtd2d_tpu_torch/fdfd/refine.py):
// the residual r = b - A x of the outrigger Helmholtz operator, its overflow-safe
// 2-norm per sample, the complex64 right-hand side r / ||r|| of the inner solve,
// and the update x += ||r|| d.
//
// It replaces no TPU kernel. The JAX package leaves the residual of its
// split-complex HelmholtzF64 to XLA (fdtd2d_tpu/fdfd/refine.py); the port ran it
// as torch's elementwise chain: the stencil's shifts, pads and products, then
// abs, amax, where, divide, square, sum, divide and cast, about 35 passes over a
// (B, Nx, Ny) complex128 field with a new temporary for most of them.
//
// What bounds it: one residual pass must read x and b (16 bytes a point each)
// and write the complex64 right-hand side (8 bytes): 40 bytes a point, 2.68 GB
// at 2048^2 with 16 sources, 0.80 ms at 3.35 TB/s. Its float64 arithmetic,
// about 50 operations a point, is a tenth of that on the card. The norm has to
// be whole before a single value of r / ||r|| can be written, so a pass is two
// sweeps over the grid with a small combine between them:
//
// - Sweep A (`residual_sweep<kPartials>`): a CTA owns a tile of kRows rows x
//   kCols columns of one sample, a thread a column, and walks down its
//   rows, loading each row's operands a row ahead. Each thread keeps x and the
//   row-direction terms of rows i-2 .. i+2 in registers; the column-direction
//   neighbours j-2 .. j+2 come through a row buffer in shared memory (two, by
//   row parity: one barrier a row). It computes r and folds |re r| and |im r|
//   into a running (max, sum of squares scaled by it), and the CTA writes one
//   such partial a (sample, tile). The CTAs of one tile's samples are
//   neighbours in the grid, so eps and 1 / mu come from L2 after the first.
// - Combine (`residual_combine`): one CTA a sample folds its tiles' partials
//   in a fixed order, with no atomics, into ||r|| = max * sqrt(sum): the same
//   input gives the same norms on every run.
// - Sweep B (`residual_sweep<kScale>`): the same walk recomputes r, bit for
//   bit as in sweep A, and writes r * (1 / ||r||) in complex64. Recomputing
//   costs what storing r in complex128 and reading it back would (72 bytes a
//   point in all), without the temporary.
//
// The norm of b alone (`residual_norm_sweep`, then the combine) takes the
// same tiles and partials. The update (`refine_update`) reads x and d once
// and writes x once.
//
// On an H100 at 2048^2 with 16 sources a pass takes 2.25 ms, 64% of the
// two-sweep floor (1.44 ms), and the update 0.88 ms, 91% of its floor: sweep
// A holds 128 registers a thread, so two CTAs an SM (16 warps) keep the rows'
// loads in flight. Capped at 80 registers for three CTAs an SM, it spills and
// runs 1.6x slower; without the row-ahead loads, 10% slower.
//
// Rounding: every operation of the stencil is the one torch's chain makes
// (ops/helmholtz.py, HelmholtzOperator.apply), in its order, rounded where the
// chain rounds each intermediate tensor, so no product is fused into an add
// that the chain rounds apart: r is the chain's r bit for bit. Only a complex
// product is one fused expression, and cmul() below makes it as c10::complex's
// operator* compiles into torch's kernels. The norms sum in another order than
// torch's reduction (the plain version ops/fdfd_residual.py emulates the tiles).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 256;   // columns a tile: one a thread
constexpr int kRows = 64;    // rows a tile: a CTA walks down them
constexpr int kPartials = 0;
constexpr int kScale = 1;

struct Pass {
  const double2* x;        // (B, Nx, Ny) complex128
  const double2* b;        // (B, Nx, Ny) complex128
  const double* eps;       // (Nx, Ny)
  const double* imu;       // (Nx, Ny): 1 / mu
  const double2* isr;      // (Nx,): 1 / s along the row axis
  const double2* isc;      // (Ny,): 1 / s along the column axis
  const double* omega;     // 0-d, on the device
  const double* inv_2dx;   // 0-d: 1 / (2 dx), column-axis spacing
  const double* inv_2dy;   // 0-d: 1 / (2 dy), row-axis spacing
  double2* partials;       // (B, tiles): (max of |re|, |im|; sum of squares over it)
  const double* norms;     // (B,): ||r|| (sweep B)
  float2* out;             // (B, Nx, Ny): r / ||r|| in complex64 (sweep B)
  int B, Nx, Ny, tiles_c, tiles;
};

__device__ __forceinline__ double2 zero2() { return make_double2(0.0, 0.0); }

// c10::complex<double>'s (a c - b d, a d + b c) as nvcc contracts it in torch's
// elementwise kernels: the second product rounded, the first fused with it.
__device__ __forceinline__ double2 cmul(double2 p, double2 q) {
  return make_double2(__fma_rn(p.x, q.x, -__dmul_rn(p.y, q.y)),
                      __fma_rn(p.x, q.y, __dmul_rn(p.y, q.x)));
}

// A complex times a real (torch promotes the real to complex with a zero
// imaginary part, whose products are exact zeros): each part rounded once.
__device__ __forceinline__ double2 rmul(double2 p, double s) {
  return make_double2(__dmul_rn(p.x, s), __dmul_rn(p.y, s));
}

__device__ __forceinline__ double2 csub(double2 p, double2 q) {
  return make_double2(__dsub_rn(p.x, q.x), __dsub_rn(p.y, q.y));
}

// _dcol / _drow's inner difference then its scale by 1 / mu: v_k = ((f_{k+1} - f_{k-1}) a) / mu_k
__device__ __forceinline__ double2 first_diff(double2 plus, double2 minus, double a, double imu) {
  return rmul(rmul(csub(plus, minus), a), imu);
}

// The outer difference and the stretch: ((v_{k+1} - v_{k-1}) a) (1 / s_k)
__device__ __forceinline__ double2 second_diff(double2 plus, double2 minus, double a, double2 is) {
  return cmul(rmul(csub(plus, minus), a), is);
}

// Running overflow-safe sum of squares: m the largest |v| so far, s the sum of
// (v / m)^2, inv = 1 / m.
struct Sumsq {
  double m = 0.0, s = 0.0, inv = 0.0;

  __device__ __forceinline__ void add(double v) {
    v = fabs(v);
    if (v > m) {
      const double q = m / v;
      s = s * (q * q) + 1.0;
      m = v;
      inv = 1.0 / v;
    } else {
      const double q = v * inv;
      s += q * q;
    }
  }

  __device__ __forceinline__ void merge(double m2, double s2) {
    if (m2 > m) {
      const double t = m; m = m2; m2 = t;
      const double u = s; s = s2; s2 = u;
    }
    if (m > 0.0) {
      const double q = m2 / m;
      s += s2 * (q * q);
    } else {
      s += s2;
    }
  }
};

// The CTA's (max, sum) into partials[slot], by a fixed tree: deterministic.
__device__ void write_partial(Sumsq acc, double2* partials, size_t slot) {
  __shared__ double2 warp_part[kCols / 32];
  for (int off = 16; off > 0; off >>= 1) {
    const double m2 = __shfl_down_sync(0xffffffffu, acc.m, off);
    const double s2 = __shfl_down_sync(0xffffffffu, acc.s, off);
    acc.merge(m2, s2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = make_double2(acc.m, acc.s);
  __syncthreads();
  if (warp == 0) {
    Sumsq w;
    if (lane < kCols / 32) { w.m = warp_part[lane].x; w.s = warp_part[lane].y; }
    for (int off = 16; off > 0; off >>= 1) {
      const double m2 = __shfl_down_sync(0xffffffffu, w.m, off);
      const double s2 = __shfl_down_sync(0xffffffffu, w.s, off);
      w.merge(m2, s2);
    }
    if (lane == 0) partials[slot] = make_double2(w.m, w.s);
  }
}

__device__ __forceinline__ double2 load2(const double2* p, bool ok) {
  return ok ? __ldg(p) : zero2();
}
__device__ __forceinline__ double load1(const double* p, bool ok) { return ok ? __ldg(p) : 0.0; }

// One row's loads, issued a row ahead of their use.
struct RowIn {
  double2 x2;      // x at (i + 2, j)
  double2 bij;     // b at (i, j)
  double eps;      // eps at (i, j)
  double imu1;     // 1 / mu at (i + 1, j)
  double2 isr2;    // 1 / s_row at i + 2
  double2 isr;     // 1 / s_row at i
  double2 hx;      // halo threads: x at (i, their column)
  double himu;     // halo threads: 1 / mu at (i, their column)
};

template <int kMode>
__global__ void __launch_bounds__(kCols) residual_sweep(Pass p) {
  __shared__ double2 u_row[2][kCols + 4];    // x (1 / s_col) at columns c0 - 2 .. c0 + kCols + 1
  __shared__ double imu_row[2][kCols + 2];   // 1 / mu at columns c0 - 1 .. c0 + kCols

  const int s = blockIdx.x % p.B;
  const int tile = blockIdx.x / p.B;
  const int r0 = (tile / p.tiles_c) * kRows;
  const int c0 = (tile % p.tiles_c) * kCols;
  const int r1 = min(r0 + kRows, p.Nx);
  const int t = threadIdx.x;
  const int j = c0 + t;
  const int Nx = p.Nx, Ny = p.Ny;
  const bool col_ok = j < Ny;
  const size_t plane = static_cast<size_t>(Nx) * Ny;
  const double2* xs = p.x + s * plane;
  const double2* bs = p.b + s * plane;

  // halo threads: 0..3 carry u at columns c0 - 2, c0 - 1, c0 + kCols, c0 + kCols + 1;
  // 4..5 carry 1 / mu at columns c0 - 1 and c0 + kCols
  int hcol = -1, hslot = 0;
  if (t < 4) {
    hcol = t < 2 ? c0 - 2 + t : c0 + kCols + (t - 2);
    hslot = t < 2 ? t : kCols + t;
  } else if (t < 6) {
    hcol = t == 4 ? c0 - 1 : c0 + kCols;
    hslot = t == 4 ? 0 : kCols + 1;
  }
  const bool hok = hcol >= 0 && hcol < Ny;
  const double2 hisc = (t < 4) ? load2(p.isc + hcol, hok) : zero2();
  const double2 isc_j = load2(p.isc + j, col_ok);

  const double om = __ldg(p.omega);
  const double w2 = __dmul_rn(om, om);
  const double ax = __ldg(p.inv_2dx), ay = __ldg(p.inv_2dy);
  const double inv = kMode == kScale ? 1.0 / (p.norms[s] == 0.0 ? 1.0 : p.norms[s]) : 0.0;

  auto load_row = [&](int i) {
    RowIn in;
    const bool i2 = i + 2 < Nx;
    in.x2 = load2(xs + static_cast<size_t>(i + 2) * Ny + j, col_ok && i2);
    in.isr2 = load2(p.isr + (i + 2), i2);
    in.isr = __ldg(p.isr + i);
    in.bij = load2(bs + static_cast<size_t>(i) * Ny + j, col_ok);
    in.eps = load1(p.eps + static_cast<size_t>(i) * Ny + j, col_ok);
    in.imu1 = load1(p.imu + static_cast<size_t>(i + 1) * Ny + j, col_ok && i + 1 < Nx);
    in.hx = (t < 4) ? load2(xs + static_cast<size_t>(i) * Ny + hcol, hok) : zero2();
    in.himu = (t >= 4 && t < 6) ? load1(p.imu + static_cast<size_t>(i) * Ny + hcol, hok) : 0.0;
    return in;
  };

  // the row window at i = r0: x and w = x (1 / s_row) at rows i - 2 .. i + 1,
  // vr = first_diff(w) at rows i - 1 and i (zero outside the grid)
  auto inside = [&](int i) { return i >= 0 && i < Nx; };
  auto x_at = [&](int i) {
    return load2(xs + static_cast<size_t>(i) * Ny + j, col_ok && inside(i));
  };
  auto w_of = [&](double2 xv, int i) { return inside(i) ? cmul(xv, __ldg(p.isr + i)) : zero2(); };
  auto imu_at = [&](int i) {
    return load1(p.imu + static_cast<size_t>(i) * Ny + j, col_ok && inside(i));
  };
  const double2 xm2 = x_at(r0 - 2), xm1 = x_at(r0 - 1);
  double2 x0 = x_at(r0), x1 = x_at(r0 + 1);
  const double2 wm2 = w_of(xm2, r0 - 2), wm1 = w_of(xm1, r0 - 1);
  double2 w0 = w_of(x0, r0), w1 = w_of(x1, r0 + 1);
  double2 vr_m = r0 >= 1 ? first_diff(w0, wm2, ay, imu_at(r0 - 1)) : zero2();   // vr at i - 1
  double imu0 = imu_at(r0);
  double2 vr_0 = first_diff(w1, wm1, ay, imu0);                                   // vr at i

  Sumsq acc;
  RowIn cur = load_row(r0);
  for (int i = r0; i < r1; ++i) {
    RowIn nxt;
    if (i + 1 < r1) nxt = load_row(i + 1);
    const int buf = (i - r0) & 1;
    // the column direction: u = x (1 / s_col) of this row into shared memory
    u_row[buf][t + 2] = col_ok ? cmul(x0, isc_j) : zero2();
    imu_row[buf][t + 1] = imu0;
    if (t < 4) u_row[buf][hslot] = hok ? cmul(cur.hx, hisc) : zero2();
    else if (t < 6) imu_row[buf][hslot] = cur.himu;
    // the row direction: vr at i + 1 from w at i + 2 and i
    const double2 w2v = (i + 2 < Nx) ? cmul(cur.x2, cur.isr2) : zero2();
    const double2 vr_p = (i + 1 < Nx) ? first_diff(w2v, w0, ay, cur.imu1) : zero2();
    __syncthreads();
    if (col_ok) {
      const double2 u_m2 = u_row[buf][t], u_0 = u_row[buf][t + 2], u_p2 = u_row[buf][t + 4];
      const double2 vc_m = j >= 1 ? first_diff(u_0, u_m2, ax, imu_row[buf][t]) : zero2();
      const double2 vc_p = j + 1 < Ny ? first_diff(u_p2, u_0, ax, imu_row[buf][t + 2]) : zero2();
      const double2 tc = second_diff(vc_p, vc_m, ax, isc_j);
      const double2 tr = second_diff(vr_p, vr_m, ay, cur.isr);
      // A x = -(tc + tr) - (omega^2 eps) x;  r = b - A x
      const double2 neg = make_double2(-__dadd_rn(tc.x, tr.x), -__dadd_rn(tc.y, tr.y));
      const double we = __dmul_rn(w2, cur.eps);
      const double2 Ax = csub(neg, rmul(x0, we));
      const double2 r = csub(cur.bij, Ax);
      if (kMode == kPartials) {
        acc.add(r.x);
        acc.add(r.y);
      } else {
        p.out[s * plane + static_cast<size_t>(i) * Ny + j] = make_float2(
            __double2float_rn(__dmul_rn(r.x, inv)), __double2float_rn(__dmul_rn(r.y, inv)));
      }
    }
    // slide the window one row down
    vr_m = vr_0; vr_0 = vr_p;
    w0 = w1; w1 = w2v;
    x0 = x1; x1 = cur.x2;
    imu0 = cur.imu1;
    cur = nxt;
  }
  if (kMode == kPartials) write_partial(acc, p.partials, static_cast<size_t>(s) * p.tiles + tile);
}

// The partials of b alone, on the same tiles.
__global__ void __launch_bounds__(kCols) residual_norm_sweep(const double2* b, double2* partials,
                                                             int B, int Nx, int Ny, int tiles_c,
                                                             int tiles) {
  const int s = blockIdx.x % B;
  const int tile = blockIdx.x / B;
  const int r0 = (tile / tiles_c) * kRows;
  const int j = (tile % tiles_c) * kCols + threadIdx.x;
  const int r1 = min(r0 + kRows, Nx);
  const double2* bs = b + s * static_cast<size_t>(Nx) * Ny;
  Sumsq acc;
  if (j < Ny) {
    for (int i = r0; i < r1; ++i) {
      const double2 v = __ldg(bs + static_cast<size_t>(i) * Ny + j);
      acc.add(v.x);
      acc.add(v.y);
    }
  }
  write_partial(acc, partials, static_cast<size_t>(s) * tiles + tile);
}

// ||.|| of sample blockIdx.x from its tiles' partials, in a fixed order: the
// largest max first, then each tile's sum rescaled to it.
__global__ void __launch_bounds__(kCols) residual_combine(const double2* partials, int tiles,
                                                          double* norms) {
  __shared__ double part[kCols / 32];
  __shared__ double big;
  const double2* ps = partials + static_cast<size_t>(blockIdx.x) * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double m = 0.0;
  for (int k = threadIdx.x; k < tiles; k += kCols) m = fmax(m, ps[k].x);
  for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_down_sync(0xffffffffu, m, off));
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    double mm = 0.0;
    for (int w = 0; w < kCols / 32; ++w) mm = fmax(mm, part[w]);
    big = mm;
  }
  __syncthreads();
  const double M = big;
  double sum = 0.0;
  for (int k = threadIdx.x; k < tiles; k += kCols) {
    const double2 v = ps[k];
    if (M > 0.0) {
      const double q = v.x / M;
      sum += v.y * (q * q);
    } else {
      sum += v.y;
    }
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  __syncthreads();
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kCols / 32; ++w) total += part[w];
    norms[blockIdx.x] = M * sqrt(total);
  }
}

// x += norms[sample] d, d complex64: x + (||r|| d) rounded as torch's chain rounds it.
// The index is a size_t: a sample of up to 2^31 - 1 points plus the grid's
// stride passes INT_MAX.
__global__ void refine_update(double2* x, const float2* d, const double* norms, int per_sample) {
  const double rn = norms[blockIdx.y];
  const size_t base = static_cast<size_t>(blockIdx.y) * per_sample;
  const size_t n = static_cast<size_t>(per_sample);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n; k += stride) {
    const float2 dv = d[base + k];
    double2 xv = x[base + k];
    xv.x = __dadd_rn(xv.x, __dmul_rn(rn, static_cast<double>(dv.x)));
    xv.y = __dadd_rn(xv.y, __dmul_rn(rn, static_cast<double>(dv.y)));
    x[base + k] = xv;
  }
}

}  // namespace

extern "C" {

// One residual pass on `stream` (a cudaStream_t of the current device, which
// holds every pointer): sweep A, the combine, and sweep B.
// partials holds B x tiles (max, sum) pairs, tiles = ceil(Nx / 64) x
// ceil(Ny / 256) (kRows x kCols a tile); norms B values. Returns
// cudaErrorInvalidValue for an empty field, else the first launch error.
int fdfd_residual_pass(const void* x, const void* b, const void* eps, const void* imu,
                       const void* isr, const void* isc, const void* omega, const void* inv_2dx,
                       const void* inv_2dy, void* partials, void* norms, void* out, int B, int Nx,
                       int Ny, void* stream) {
  if (B < 1 || Nx < 1 || Ny < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_c = (Ny + kCols - 1) / kCols;
  const int tiles = ((Nx + kRows - 1) / kRows) * tiles_c;
  Pass p{static_cast<const double2*>(x),     static_cast<const double2*>(b),
         static_cast<const double*>(eps),    static_cast<const double*>(imu),
         static_cast<const double2*>(isr),   static_cast<const double2*>(isc),
         static_cast<const double*>(omega),  static_cast<const double*>(inv_2dx),
         static_cast<const double*>(inv_2dy), static_cast<double2*>(partials),
         static_cast<const double*>(norms),  static_cast<float2*>(out),
         B, Nx, Ny, tiles_c, tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(tiles) * B;
  residual_sweep<kPartials><<<grid, kCols, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_combine<<<B, kCols, 0, st>>>(static_cast<const double2*>(partials), tiles,
                                        static_cast<double*>(norms));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_sweep<kScale><<<grid, kCols, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ||b|| per sample of a (B, Nx, Ny) complex128 b into norms, through the same
// tiles, partials and combine as a residual pass.
int fdfd_residual_norms(const void* b, void* partials, void* norms, int B, int Nx, int Ny,
                        void* stream) {
  if (B < 1 || Nx < 1 || Ny < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_c = (Ny + kCols - 1) / kCols;
  const int tiles = ((Nx + kRows - 1) / kRows) * tiles_c;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  residual_norm_sweep<<<static_cast<unsigned>(tiles) * B, kCols, 0, st>>>(
      static_cast<const double2*>(b), static_cast<double2*>(partials), B, Nx, Ny, tiles_c, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_combine<<<B, kCols, 0, st>>>(static_cast<const double2*>(partials), tiles,
                                        static_cast<double*>(norms));
  return static_cast<int>(cudaGetLastError());
}

// x += norms[s] d for each sample s of B, per_sample points each: x complex128
// and d complex64, both (B, per_sample) contiguous, updated in place.
int fdfd_refine_update(void* x, const void* d, const void* norms, int B, int per_sample,
                       void* stream) {
  if (B < 1 || B > 65535 || per_sample < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int want = (per_sample + threads - 1) / threads;
  const int blocks = want < 4096 ? want : 4096;
  refine_update<<<dim3(blocks, B), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double2*>(x), static_cast<const float2*>(d), static_cast<const double*>(norms),
      per_sample);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// K2: temporally tiled TE leapfrog, `steps` <= K steps per pass over HBM,
// on 2D tiles of the padded (N, M) float32 layout. Run with K = 1 it is K3.
//
// Replaces the Pallas TPU kernels fdtd2d_tpu/ops/pallas_fdtd_ttiled.py::_kernel
// (one pallas_call per sweep in _ttiled_sweep, looped by _ttiled_run) and,
// as its K = 1 mode, fdtd2d_tpu/ops/pallas_fdtd_blocked.py::_kernel (one
// step per pass, the halo H recomputed in the tile). The TPU kernel walks
// full-width row panels; a 4096-wide panel of three fields does not fit the
// 227 KB of shared memory a block may use here, so this kernel cuts 2D tiles.
//
// Scheme. One block per tile of TH x TW owned cells. The block loads its
// window -- the owned cells plus a halo of K cells on each side, clipped at
// the domain -- of Ez, Hx and Hy into shared memory, runs the steps there,
// and writes its owned cells to three other buffers: a neighbour still reads
// its halo from the inputs, so nothing is updated in place, and the host
// swaps inputs and outputs between sweeps. ce and ch are not staged: each
// step reads them through the read-only data path (__ldg), which leaves the
// shared memory to the three fields and so allows larger windows.
//
// Each step runs the staging of fdtd_fused.cu on the window, with the cell
// bodies of fdtd_step.cuh at the window's row stride and __syncthreads()
// between stages: (1) save the pre-step Mur strips, with (2) the H update;
// (3) interior Ez; (4) left/right bands; (5) top/bottom bands; (6) corners,
// all reads before any store; (7) the source. Stages 4-7 are skipped, with
// their barriers, by blocks whose window holds no band, corner or source
// (the conditions are uniform over the block).
//
// Validity. A step reads one cell away in each axis, so the wrong values
// outside a window eat one cell per step into it, and after K steps the
// owned cells are exact. Windows are clipped at the domain, not ghost-padded;
// the domain guards (i < N-1, 1 <= j < M-1, ...) of fdtd_fused.cu then give
// the boundary its treatment. Every Mur band, corner and the source is
// applied wherever it lies in a window, in every tile: a neighbour's halo
// holds band cells too (applying them in the edge tiles only is the fault
// of the JAX kernel in ROADMAP Queue 3). Two rules of the tiling, which
// fdtd2d_tpu_torch/ops/fdtd_ttiled.py::tile_spans mirrors and checks:
//   - a window starts at the domain edge or at least S = 6 cells inside it
//     (and ends likewise), so a Mur chain or corner block is whole in a
//     window or not in it at all;
//   - every tile owns at least S cells a side. Within one step a band or
//     corner cell reads inward up to two cells past its neighbour (a chain
//     reads the post-interior Ez of the next cell, a corner the post-band
//     Ez), so invalidity crosses the band region faster than one cell a
//     step; with S owned cells it never gets that far before step K.
//
// Bound on this card: HBM bytes per cell per step,
//   (5 reads x window / owned + 3 writes) x 4 B / K,
// counting ce and ch once per sweep (their re-reads inside a sweep hit L1
// or L2). The planner's shape at 4096^2 and 8192^2 is K = 6 with 80 x 96
// windows over 68 x 84 owned cells: (5 x 1.345 + 3) x 4 / 6 = 6.5 B/cell/step,
// 517 GCells/s at the data sheet's 3.35 TB/s (700 W), against K1's 44 B
// (76 GCells/s). At K = 1 (K3) it is 33 B with 80 x 96 windows over 78 x 94
// (102 GCells/s). With HBM that far off, K2 is bound inside the SM: about 13
// shared-memory accesses and two ce/ch loads per cell per step, and 2 to 7
// barriers a step with only two 512-thread blocks an SM to hide them (one
// block an SM, with 128 x 128 windows, ran half as fast). Later work: more
// blocks an SM, TMA loads of the next window while this one steps, clusters
// sharing halos, a persistent grid.
//
// The source amplitudes amp[0..steps) of the sweep are computed by the caller
// on the device, so chunked runs inject exactly what one run does.
#include <cuda_runtime.h>

#include "fdtd_step.cuh"

namespace {

using fdtd::kBand;
using fdtd::kStrip;

constexpr int kThreadsX = 32;   // threads along a window row
constexpr int kThreadsY = 16;   // threads down a window column
constexpr int kThreads = kThreadsX * kThreadsY;

// Owned range [own0, own1) and window [win0, win1) of tile t along one axis
// of n cells, tiles of T cells, halo K. Mirrored by ops/fdtd_ttiled.py.
struct Span {
  int own0, own1, win0, win1;
};

__device__ __forceinline__ Span tile_span(int t, int T, int K, int n) {
  Span s;
  s.own0 = t * T;
  s.own1 = min(s.own0 + T, n);
  s.win0 = s.own0 - K >= kStrip ? s.own0 - K : 0;
  s.win1 = s.own1 + K <= n - kStrip ? s.own1 + K : n;
  return s;
}

// f(wi, wj) over window rows [i0, i1) and columns [j0, j1), the block's
// threads spread over the rows and, within a row, over consecutive columns.
template <typename F>
__device__ __forceinline__ void for_cells(int i0, int i1, int j0, int j1, F f) {
  for (int wi = i0 + threadIdx.y; wi < i1; wi += kThreadsY) {
    for (int wj = j0 + threadIdx.x; wj < j1; wj += kThreadsX) f(wi, wj);
  }
}

// Shared memory: Ez, Hx, Hy windows (wh x ld each), then the pre-step Mur
// strips: left and right (wh x 6), top and bottom (6 x ld). ld is odd, so
// the row-per-thread band chains hit 32 different banks.
__global__ void __launch_bounds__(kThreads, 2)
ttiled_sweep(const float* __restrict__ ez_in, const float* __restrict__ hx_in,
             const float* __restrict__ hy_in, float* __restrict__ ez_out,
             float* __restrict__ hx_out, float* __restrict__ hy_out,
             const float* __restrict__ ce, const float* __restrict__ ch,
             const float* __restrict__ amp, int N, int M, int TH, int TW,
             int K, int steps, int ld, int sx, int sy, float coef) {
  extern __shared__ float smem[];
  const Span rs = tile_span(blockIdx.y, TH, K, N);
  const Span cs = tile_span(blockIdx.x, TW, K, M);
  const int r0 = rs.win0, c0 = cs.win0;
  const int wh = rs.win1 - r0, ww = cs.win1 - c0;
  float* ez = smem;
  float* hx = ez + wh * ld;
  float* hy = hx + wh * ld;
  float* p_l = hy + wh * ld;
  float* p_r = p_l + wh * kStrip;
  float* p_t = p_r + wh * kStrip;
  float* p_b = p_t + kStrip * ld;

  const bool top = rs.win0 == 0, bot = rs.win1 == N;
  const bool left = cs.win0 == 0, right = cs.win1 == M;
  const bool corners = (top || bot) && (left || right);
  const bool source = r0 <= sx && sx < rs.win1 && c0 <= sy && sy < cs.win1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  for_cells(0, wh, 0, ww, [&](int wi, int wj) {
    const int g = (r0 + wi) * M + c0 + wj, k = wi * ld + wj;
    ez[k] = ez_in[g];
    hx[k] = hx_in[g];
    hy[k] = hy_in[g];
  });
  __syncthreads();

  for (int n = 0; n < steps; ++n) {
    // (1) pre-step Mur strips and (2) H update: neither writes Ez.
    for_cells(0, wh, 0, ww, [&](int wi, int wj) {
      const int k = wi * ld + wj, i = r0 + wi, j = c0 + wj;
      const float e = ez[k];
      if (left && wj < kStrip) p_l[wi * kStrip + wj] = e;
      if (right && wj >= ww - kStrip) p_r[wi * kStrip + wj - (ww - kStrip)] = e;
      if (top && wi < kStrip) p_t[wi * ld + wj] = e;
      if (bot && wi >= wh - kStrip) p_b[(wi - (wh - kStrip)) * ld + wj] = e;
      if (i < N - 1 && j < M - 1 && wi + 1 < wh && wj + 1 < ww) {
        fdtd::h_update(ez, __ldg(ch + i * M + j), hx, hy, k, ld);
      }
    });
    __syncthreads();

    // (3) interior Ez; wi, wj >= 1 keeps the stencil inside the window.
    for_cells(1, wh, 1, ww, [&](int wi, int wj) {
      const int i = r0 + wi, j = c0 + wj;
      if (i < N - 1 && j < M - 1) {
        fdtd::e_interior(ez, hx, hy, __ldg(ce + i * M + j), wi * ld + wj, ld);
      }
    });
    __syncthreads();

    // (4) Mur left/right bands, domain rows 1..N-2 (read post-interior Ez).
    if (left || right) {
      for (int wi = tid; wi < wh; wi += kThreads) {
        const int i = r0 + wi;
        if (i < 1 || i > N - 2) continue;
        if (left) fdtd::mur_chain(ez + wi * ld, 1, p_l + wi * kStrip, 1, coef);
        if (right) {
          fdtd::mur_chain(ez + wi * ld + ww - 1, -1,
                          p_r + wi * kStrip + kStrip - 1, -1, coef);
        }
      }
      __syncthreads();
    }

    // (5) Mur top/bottom bands, domain columns 1..M-2 (read post-left/right).
    if (top || bot) {
      for (int wj = tid; wj < ww; wj += kThreads) {
        const int j = c0 + wj;
        if (j < 1 || j > M - 2) continue;
        if (top) fdtd::mur_chain(ez + wj, ld, p_t + wj, ld, coef);
        if (bot) {
          fdtd::mur_chain(ez + (wh - 1) * ld + wj, -ld,
                          p_b + (kStrip - 1) * ld + wj, -ld, coef);
        }
      }
      __syncthreads();
    }

    // (6) the 5x5 corners this window holds (read post-top/bottom Ez).
    if (corners) {
      const int corner = tid / (kBand * kBand);
      const bool lower = corner >= 2, rightc = corner % 2 == 1;
      const bool mine = tid < 4 * kBand * kBand && (lower ? bot : top) &&
                        (rightc ? right : left);
      float* cell = nullptr;
      float value = 0.0f;
      if (mine) {
        const int a = (tid % (kBand * kBand)) / kBand;
        const int b = tid % kBand;
        const int rstep = lower ? -ld : ld;
        const int cstep = rightc ? -1 : 1;
        float* c = ez + (lower ? (wh - 1) * ld : 0) + (rightc ? ww - 1 : 0);
        value = fdtd::corner_value(c, rstep, cstep, a, b);
        cell = c + a * rstep + b * cstep;
      }
      __syncthreads();
      if (mine) *cell = value;
      __syncthreads();
    }

    // (7) additive point source, in every window that holds it.
    if (source) {
      if (tid == 0) ez[(sx - r0) * ld + sy - c0] += amp[n];
      __syncthreads();
    }
  }

  const int oi0 = rs.own0 - r0, oi1 = rs.own1 - r0;
  const int oj0 = cs.own0 - c0, oj1 = cs.own1 - c0;
  for_cells(oi0, oi1, oj0, oj1, [&](int wi, int wj) {
    const int g = (r0 + wi) * M + c0 + wj, k = wi * ld + wj;
    ez_out[g] = ez[k];
    hx_out[g] = hx[k];
    hy_out[g] = hy[k];
  });
}

}  // namespace

extern "C" {

// Advance the padded state nsteps steps on `stream` (a cudaStream_t of the
// current device, which holds every pointer): ceil(nsteps / K) sweeps, the
// last of depth nsteps % K where that is not 0. Sweep s reads buffer set
// (s even ? a : b) and writes the other, so the result is in b when the
// number of sweeps is odd, else in a. Tiles are TH x TW owned cells with a
// halo of K; WH x WW is the largest window of the tiling, which sizes the
// dynamic shared memory. `amp` holds nsteps source amplitudes. Returns the
// first CUDA error seen (cudaSuccess = 0); launches asynchronously, so
// faults during the run surface at the caller's next synchronisation.
int fdtd_ttiled_run(float* ez_a, float* hx_a, float* hy_a, float* ez_b,
                    float* hx_b, float* hy_b, const float* ce, const float* ch,
                    const float* amp, int N, int M, int TH, int TW, int K,
                    int nsteps, int WH, int WW, int sx, int sy, float coef,
                    void* stream) {
  const int ld = WW | 1;
  const size_t smem =
      sizeof(float) * (3 * WH * ld + 2 * WH * kStrip + 2 * kStrip * ld);
  cudaError_t err = cudaFuncSetAttribute(
      ttiled_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((M + TW - 1) / TW, (N + TH - 1) / TH);
  int sweep = 0;
  for (int done = 0; done < nsteps; done += K, ++sweep) {
    const int steps = nsteps - done < K ? nsteps - done : K;
    const bool even = sweep % 2 == 0;
    ttiled_sweep<<<grid, block, smem, s>>>(
        even ? ez_a : ez_b, even ? hx_a : hx_b, even ? hy_a : hy_b,
        even ? ez_b : ez_a, even ? hx_b : hx_a, even ? hy_b : hy_a, ce, ch,
        amp + done, N, M, TH, TW, K, steps, ld, sx, sy, coef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"

// K2: temporally tiled TE leapfrog, `steps` <= K steps per pass over HBM,
// on 2D tiles of the padded float32 fields. Run with K = 1 it is K3.
//
// Replaces the Pallas TPU kernels fdtd2d_tpu/ops/pallas_fdtd_ttiled.py::_kernel
// (one pallas_call per sweep in _ttiled_sweep, looped by _ttiled_run) and,
// as its K = 1 mode, fdtd2d_tpu/ops/pallas_fdtd_blocked.py::_kernel (one
// step per pass, the halo H recomputed in the tile). The TPU kernel walks
// full-width row panels; a 4096-wide panel of five fields does not fit the
// 227 KB of shared memory a block may use here, so this kernel cuts 2D tiles.
//
// Scheme. A tile owns TH x TW cells; its window adds a halo of K cells on
// each side, clipped at the domain. A sweep steps every window K times and
// keeps its owned cells, written to a second set of buffers (a neighbour
// still reads its halo from the inputs); the host swaps the sets between
// sweeps. Every array is (N, ldg) floats, ldg = M rounded up to 4, so that
// every row starts on 16 bytes, as TMA needs.
//
// What bounds it. Once ce and ch are no longer re-read every step (stage 2
// of the redesign), the step's arithmetic -- 11 float operations a cell --
// is cheap; the costs are the instructions and barriers that move a cell's
// neighbours around, and the window load and owned-cell store, which the
// plan's HBM traffic bounds: (5 reads x window / owned + 3 writes) x 4 B /
// K a cell a step, 5.25 B at the planner's 4096^2 shape (K = 8, 80 x 96
// windows over 64 x 80 owned cells), 0.0263 ms a step at 3.35 TB/s. The
// design, one stage at a time (PERF.md section 6 has each stage's time):
//
//   - A persistent grid, one 480-thread block an SM (registers allow one).
//     A block takes tiles b and b + gridDim.x of the host's list, then
//     claims more from a per-sweep counter, one ahead, so that blocks that
//     drew slow tiles take fewer. The host lists the edge tiles first.
//   - Interior tiles -- a window at least S = 6 cells inside the domain on
//     every side, so no Mur band, corner or domain guard lies in it -- run
//     a body with none of that work. The fields live in registers: warp
//     (wx, wy) of 3 x 5 steps window column 32 wx + lane, rows 16 wy ..
//     16 wy + 15, with their ce and ch read once a sweep. Vertical
//     neighbours are the thread's own registers, horizontal ones come by
//     __shfl_down/up_sync; only run ends and warp edges pass through a
//     small exchange buffer, with two barriers a step. The window is at
//     most 80 x 96 cells (ops/fdtd_ttiled.py::WINDOW).
//   - Window loads overlap the stepping: once every thread has read its
//     cells, one thread starts the TMA loads of the block's next interior
//     window (five 80 x 100 boxes, cp.async.bulk.tensor.2d, completing on
//     an mbarrier) into shared memory, and the current tile steps from
//     registers and stores its owned cells while they land. A box must
//     start on a 16-byte column: it starts at the window's first column
//     rounded down to 4, and the window lies win0 % 4 floats into each row.
//   - Edge tiles keep the staged body of the first version, with ce and ch
//     now staged beside the fields (the last stage; re-reading them
//     through __ldg each step cost 13% of the whole sweep at 4096^2): Ez,
//     Hx, Hy, ce, ch in shared memory, per step (1) save the pre-step Mur
//     strips, with (2) the H update; (3) interior Ez; (4) left/right bands;
//     (5) top/bottom bands; (6) corners, all reads before any store; (7)
//     the source, with __syncthreads() between stages. They are about 7% of
//     the tiles at 4096^2.
//
// Both bodies compute each cell with the same expressions (fdtd_step.cuh),
// so a cell's value does not depend on which tile or body computed it, and
// chunked runs equal single runs bit for bit.
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
// The source amplitudes amp[0..steps) of the sweep are computed by the caller
// on the device, so chunked runs inject exactly what one run does.
//
// Block mode (the TPU kernel's sharded mode: GW > 0 and device-varying
// is_top/is_bot/is_left/is_right, src_g, src_c). The arrays need not hold
// the whole N x M domain: they hold a sub-rectangle of it, rows
// [ar, ar + AN) and columns [ac, ac + AM), of which this call owns
// [r_lo, r_hi) x [c_lo, c_hi); the rest are ghost cells that hold a
// neighbouring block's values (ops/fdtd_ttiled.py::Block). Tiles cut the
// owned cells only. Everything else stays in domain coordinates: a window
// is placed by the same rule (at the domain's edge, or at least S inside
// it), so at a side of the owned cells that is not a domain edge it reaches
// K cells into the ghost cells, whose validity recedes a cell a step like
// any halo's; a side of the array is a domain edge exactly when a window
// reaches coordinate 0, N or M there, and only then does it get bands,
// corners and guards, in every window that holds them, ghost cells
// included; the source (sx, sy) is a domain coordinate, and a window that
// does not hold it injects nothing. So a window at a ghost boundary holds
// no band or corner and runs the register body. Only the memory index
// differs from the single-device call, which is the block with ar = ac = 0
// that owns everything: cell (i, j) lies at (i - ar) * ldg + (j - ac).
// Alignment: each array's base is 16-byte aligned and ldg is a multiple of
// 4, whatever ar, ac and the ghost depth are; a TMA box starts at the
// window's first column *in the array*, (win0 - ac), rounded down to 4, so
// it starts on 16 bytes for any origin and ghost depth, and the part of a
// box outside the array is zero-filled. Ghost cells of the output buffers
// are never written here: the caller fills all of them (a halo exchange)
// before the sweep that reads them.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fdtd_step.cuh"

namespace {

using fdtd::kBand;
using fdtd::kStrip;

constexpr int kR = 16;                        // window rows a thread holds
constexpr int kWarpsX = 3;                    // warps across a window
constexpr int kWarpsY = 5;                    // warps down a window
constexpr int kWinW = 32 * kWarpsX;           // interior window columns: 96
constexpr int kWinH = kR * kWarpsY;           // interior window rows: 80
constexpr int kThreadsX = 32;                 // a warp is one row of threads
constexpr int kThreadsY = kWarpsX * kWarpsY;  // 15
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kLd = kWinW + 4;                // TMA box width: window + alignment
constexpr unsigned kFull = 0xffffffffu;

// Owned range [own0, own1) and window [win0, win1) of tile t along one axis
// of a domain of n cells, in domain coordinates: tiles of T cells over the
// owned cells [lo, hi), halo K. Mirrored by ops/fdtd_ttiled.py.
struct Span {
  int own0, own1, win0, win1;
};

__device__ __forceinline__ Span tile_span(int t, int T, int K, int n, int lo, int hi) {
  Span s;
  s.own0 = lo + t * T;
  s.own1 = min(s.own0 + T, hi);
  s.win0 = s.own0 - K >= kStrip ? s.own0 - K : 0;
  s.win1 = s.own1 + K <= n - kStrip ? s.own1 + K : n;
  return s;
}

struct Fields {
  const float* __restrict__ ez_in;
  const float* __restrict__ hx_in;
  const float* __restrict__ hy_in;
  float* __restrict__ ez_out;
  float* __restrict__ hx_out;
  float* __restrict__ hy_out;
  const float* __restrict__ ce;
  const float* __restrict__ ch;
  const float* __restrict__ amp;
};

// Tile geometry of one sweep, and the list the persistent blocks walk. N x M
// is the domain; the arrays hold its rows from ar and columns from ac on,
// ldg floats a row, and the tiles cut the owned cells [r_lo, r_hi) x
// [c_lo, c_hi) (domain coordinates).
struct Plan {
  const int* __restrict__ tiles;  // (row tile, column tile) pairs, edge tiles first
  int n_tiles, N, M, ldg, TH, TW, K;
  int r_lo, r_hi, c_lo, c_hi, ar, ac;
};

__device__ __forceinline__ void spans_of(const Plan& p, int item, Span& rs, Span& cs) {
  rs = tile_span(p.tiles[2 * item], p.TH, p.K, p.N, p.r_lo, p.r_hi);
  cs = tile_span(p.tiles[2 * item + 1], p.TW, p.K, p.M, p.c_lo, p.c_hi);
}

// Index in the arrays of the domain's cell (i, j).
__device__ __forceinline__ int cell_index(const Plan& p, int i, int j) {
  return (i - p.ar) * p.ldg + (j - p.ac);
}

// f(wi, wj) over window rows [i0, i1) and columns [j0, j1), the block's
// threads spread over the rows and, within a row, over consecutive columns.
template <typename F>
__device__ __forceinline__ void for_cells(int i0, int i1, int j0, int j1, F f) {
  for (int wi = i0 + threadIdx.y; wi < i1; wi += kThreadsY) {
    for (int wj = j0 + threadIdx.x; wj < j1; wj += kThreadsX) f(wi, wj);
  }
}

// Edge tiles: the window holds a Mur band, a corner or the domain's edge.
// Shared memory: Ez, Hx, Hy, ce, ch windows (wh x ld each), then the
// pre-step Mur strips: left and right (wh x 6), top and bottom (6 x ld).
__device__ __forceinline__ void edge_sweep(const Fields& f, float* smem, const Span& rs,
                                           const Span& cs, const Plan& p, int steps,
                                           int ld, int sx, int sy, float coef) {
  const int N = p.N, M = p.M, ldg = p.ldg;
  const int r0 = rs.win0, c0 = cs.win0;
  const int g0 = cell_index(p, r0, c0);  // the window's first cell in the arrays
  const int wh = rs.win1 - r0, ww = cs.win1 - c0;
  float* ez = smem;
  float* hx = ez + wh * ld;
  float* hy = hx + wh * ld;
  float* ce = hy + wh * ld;
  float* ch = ce + wh * ld;
  float* p_l = ch + wh * ld;
  float* p_r = p_l + wh * kStrip;
  float* p_t = p_r + wh * kStrip;
  float* p_b = p_t + kStrip * ld;

  const bool top = rs.win0 == 0, bot = rs.win1 == N;
  const bool left = cs.win0 == 0, right = cs.win1 == M;
  const bool corners = (top || bot) && (left || right);
  const bool source = r0 <= sx && sx < rs.win1 && c0 <= sy && sy < cs.win1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  for_cells(0, wh, 0, ww, [&](int wi, int wj) {
    const int g = g0 + wi * ldg + wj, k = wi * ld + wj;
    ez[k] = f.ez_in[g];
    hx[k] = f.hx_in[g];
    hy[k] = f.hy_in[g];
    ce[k] = f.ce[g];
    ch[k] = f.ch[g];
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
        fdtd::h_update(ez, ch[k], hx, hy, k, ld);
      }
    });
    __syncthreads();

    // (3) interior Ez; wi, wj >= 1 keeps the stencil inside the window.
    for_cells(1, wh, 1, ww, [&](int wi, int wj) {
      const int i = r0 + wi, j = c0 + wj;
      if (i < N - 1 && j < M - 1) {
        fdtd::e_interior(ez, hx, hy, ce[wi * ld + wj], wi * ld + wj, ld);
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
      if (tid == 0) ez[(sx - r0) * ld + sy - c0] += f.amp[n];
      __syncthreads();
    }
  }

  const int oi0 = rs.own0 - r0, oi1 = rs.own1 - r0;
  const int oj0 = cs.own0 - c0, oj1 = cs.own1 - c0;
  for_cells(oi0, oi1, oj0, oj1, [&](int wi, int wj) {
    const int g = g0 + wi * ldg + wj, k = wi * ld + wj;
    f.ez_out[g] = ez[k];
    f.hx_out[g] = hx[k];
    f.hy_out[g] = hy[k];
  });
}

// Edge exchange between the warps of the interior body. Warp (wx, wy) holds
// window rows [kR wy, kR wy + kR) of column 32 wx + lane. Slots that no warp
// writes (below the last warp row, right of the last warp column, above
// the first, left of the first) hold 0: the cells that read them lie on the
// window's edge, where the values are invalid anyway.
struct Exchange {
  float ez_row[kWarpsY + 1][kWinW];  // [wy]: Ez of warp row wy's first row
  float hx_row[kWarpsY + 1][kWinW];  // [wy + 1]: Hx of warp row wy's last row
  float ez_col[kWarpsX + 1][kWinH];  // [wx]: Ez of warp column wx's lane 0
  float hy_col[kWarpsX + 1][kWinH];  // [wx + 1]: Hy of warp column wx's lane 31
};

__device__ __forceinline__ void clear_exchange(Exchange& x) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int k = tid; k < kWinW; k += kThreads) {
    x.ez_row[kWarpsY][k] = 0.0f;
    x.hx_row[0][k] = 0.0f;
  }
  for (int k = tid; k < kWinH; k += kThreads) {
    x.ez_col[kWarpsX][k] = 0.0f;
    x.hy_col[0][k] = 0.0f;
  }
}

__device__ __forceinline__ bool is_interior(const Span& rs, const Span& cs, int N, int M) {
  return rs.win0 > 0 && rs.win1 < N && cs.win0 > 0 && cs.win1 < M;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// TMA descriptors of the five fields a sweep reads: boxes of kWinH rows x
// kLd columns of the (N, ldg) float arrays (ldg a multiple of 4: rows start
// on 16 bytes, as TMA requires).
struct Maps {
  CUtensorMap ez, hx, hy, ce, ch;
};

// One thread starts the TMA loads of an interior window -- Ez, Hx, Hy, ce,
// ch, one kWinH x kLd box each -- into `win` ([5][kWinH][kLd], 128-byte
// aligned); they complete on `bar`. A box must start on a 16-byte column,
// so it starts at the window's first column in the array rounded down to
// 4, and the window lies `shift` = (win0 - ac) % 4 floats into each row.
// Cells of the box outside the window act as its invalid surround; parts of
// the box outside the array are zero-filled.
__device__ __forceinline__ void load_window(const Maps& maps, float* win, uint64_t* bar,
                                            const Plan& p, const Span& rs, const Span& cs) {
  constexpr unsigned kBytes = 5u * kWinH * kLd * sizeof(float);
  const unsigned b = smem_addr(bar);
  // order earlier generic accesses of `win` before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(kBytes)
               : "memory");
  const CUtensorMap* m[5] = {&maps.ez, &maps.hx, &maps.hy, &maps.ce, &maps.ch};
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(win + a * kWinH * kLd)),
        "l"(reinterpret_cast<uint64_t>(m[a])), "r"((cs.win0 - p.ac) & ~3),
        "r"(rs.win0 - p.ar), "r"(b)
        : "memory");
  }
}

// Wait until the phase of `bar` with parity `phase` completes. A load that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void wait_window(uint64_t* bar, unsigned phase) {
  const unsigned b = smem_addr(bar);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(phase)
        : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();
  }
}

// Interior tiles: the window lies at least S cells inside the domain on
// every side, so it holds no Mur band and no corner and every cell has
// 1 <= i < N-1, 1 <= j < M-1 (a window at a block's ghost boundary is such
// a window). The fields live in registers: each thread
// steps kR cells of one window column, with their ce and ch read once, from
// the window that load_window brought into `win`. Once every thread has
// read its cells, the window of item `next` (interior; -1 for none) is
// loaded into `win` while this one steps.
__device__ __forceinline__ void interior_sweep(const Fields& f, const Plan& p,
                                               const Maps& maps, Exchange& x, float* win,
                                               uint64_t* bar, const Span& rs,
                                               const Span& cs, int next, int steps, int sx,
                                               int sy) {
  const int lane = threadIdx.x;
  const int wx = threadIdx.y % kWarpsX, wy = threadIdx.y / kWarpsX;
  const int wj = wx * 32 + lane, wi0 = wy * kR;  // window column and first row
  const int r0 = rs.win0, c0 = cs.win0;
  float ez[kR], hx[kR], hy[kR], ce[kR], ch[kR];
  const int shift = (c0 - p.ac) & 3;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int k = (wi0 + r) * kLd + shift + wj;
    ez[r] = win[k];
    hx[r] = win[kWinH * kLd + k];
    hy[r] = win[2 * kWinH * kLd + k];
    ce[r] = win[3 * kWinH * kLd + k];
    ch[r] = win[4 * kWinH * kLd + k];
  }
  __syncthreads();  // every thread has read its cells
  if (next >= 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    Span nr, nc;
    spans_of(p, next, nr, nc);
    load_window(maps, win, bar, p, nr, nc);
  }

  const bool source = r0 <= sx && sx < rs.win1 && c0 <= sy && sy < cs.win1;
  const int src_r = sx - r0 - wi0;  // the source's row in this thread's run
  const bool src_mine = source && wj == sy - c0 && 0 <= src_r && src_r < kR;

  for (int n = 0; n < steps; ++n) {
    // H update: Ez one row down (own registers; the warp below's first row)
    // and one column right (the next lane; the next warp's lane 0).
    x.ez_row[wy][wj] = ez[0];
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) x.ez_col[wx][wi0 + r] = ez[r];
    }
    __syncthreads();
    const float ez_below = x.ez_row[wy + 1][wj];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float e_down = r + 1 < kR ? ez[r + 1] : ez_below;
      float e_right = __shfl_down_sync(kFull, ez[r], 1);
      if (lane == 31) e_right = x.ez_col[wx + 1][wi0 + r];
      hx[r] = fdtd::hx_next(hx[r], ch[r], e_down, ez[r]);
      hy[r] = fdtd::hy_next(hy[r], ch[r], e_right, ez[r]);
    }

    // Ez update: Hx one row up, Hy one column left, as above mirrored.
    x.hx_row[wy + 1][wj] = hx[kR - 1];
    if (lane == 31) {
#pragma unroll
      for (int r = 0; r < kR; ++r) x.hy_col[wx + 1][wi0 + r] = hy[r];
    }
    __syncthreads();
    const float hx_above = x.hx_row[wy][wj];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float hx_up = r > 0 ? hx[r - 1] : hx_above;
      float hy_left = __shfl_up_sync(kFull, hy[r], 1);
      if (lane == 0) hy_left = x.hy_col[wx][wi0 + r];
      ez[r] = fdtd::ez_next(ez[r], ce[r], hy[r], hy_left, hx[r], hx_up);
    }
    if (src_mine) {
      const float a = f.amp[n];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r == src_r) ez[r] += a;
      }
    }
  }

  const int oi0 = rs.own0 - r0, oi1 = rs.own1 - r0;
  const int oj0 = cs.own0 - c0, oj1 = cs.own1 - c0;
  if (oj0 <= wj && wj < oj1) {
    const int g0 = cell_index(p, r0 + wi0, c0 + wj);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (oi0 <= wi0 + r && wi0 + r < oi1) {
        const int g = g0 + r * p.ldg;
        f.ez_out[g] = ez[r];
        f.hx_out[g] = hx[r];
        f.hy_out[g] = hy[r];
      }
    }
  }
}

// One sweep. A persistent grid: block b takes items b and b + gridDim.x of
// p.tiles, then claims further items from the sweep's counter, one item
// ahead, so that the next interior window is loaded by TMA into shared
// memory while the current one steps from registers (the host lists edge
// tiles first, so the slow staged bodies start first and the claimed
// interior tiles even out the blocks' ends). Shared memory holds that
// window, or an edge tile's staged window.
__global__ void __launch_bounds__(kThreads, 1)
ttiled_sweep(Fields f, Plan p, const __grid_constant__ Maps maps, int* __restrict__ counter,
             int steps, int ld, int sx, int sy, float coef) {
  extern __shared__ __align__(128) float smem[];
  __shared__ Exchange x;
  __shared__ uint64_t bar;
  __shared__ int claimed[2];
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;
  const int grid = static_cast<int>(gridDim.x);
  if (leader) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bar)), "r"(1u)
                 : "memory");
  }
  clear_exchange(x);
  __syncthreads();
  int item = blockIdx.x, next = item + grid, slot = 0;
  unsigned loads = 0;    // windows loaded so far: the parity of the next wait
  bool pending = false;  // the current item's window is already on its way
  while (item < p.n_tiles) {
    int after = 0;  // the item after next, claimed now, used at the next item
    if (leader) after = 2 * grid + atomicAdd(counter, 1);
    Span rs, cs;
    spans_of(p, item, rs, cs);
    if (is_interior(rs, cs, p.N, p.M)) {
      if (!pending && leader) load_window(maps, smem, &bar, p, rs, cs);
      bool ahead = false;
      if (next < p.n_tiles) {
        Span nr, nc;
        spans_of(p, next, nr, nc);
        ahead = is_interior(nr, nc, p.N, p.M);
      }
      wait_window(&bar, loads & 1u);
      ++loads;
      interior_sweep(f, p, maps, x, smem, &bar, rs, cs, ahead ? next : -1, steps, sx, sy);
      pending = ahead;
    } else {
      edge_sweep(f, smem, rs, cs, p, steps, ld, sx, sy, coef);
      pending = false;
    }
    if (leader) claimed[slot] = after;
    __syncthreads();  // publishes `after`; this item is done with shared memory
    item = next;
    next = claimed[slot];
    slot ^= 1;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A TMA descriptor of kWinH x kLd boxes of an (N, ldg) float array whose
// first M columns are the cells (N x M: the array's extent, not the domain's).
cudaError_t encode_map(EncodeTiled encode, CUtensorMap* map, const float* base, int N,
                       int M, int ldg) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(M), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldg) * sizeof(float)};
  const cuuint32_t box[2] = {kLd, kWinH};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Dynamic shared memory of a block when the largest window is WH x WW: the
// edge body's staged window (Ez, Hx, Hy, ce, ch at the odd stride WW | 1,
// and the four pre-step Mur strips) or an interior window's five TMA
// boxes, whichever is larger.
size_t dynamic_smem(int WH, int WW) {
  const int ld = WW | 1;
  const size_t staged =
      sizeof(float) * (5 * WH * ld + 2 * WH * kStrip + 2 * kStrip * ld);
  const size_t window = sizeof(float) * 5 * kWinH * kLd;
  return staged > window ? staged : window;
}

}  // namespace

extern "C" {

// The kernel's layout, which the host's planner copies
// (ops/fdtd_ttiled.py: STATIC_SMEM_BYTES, smem_bytes, WINDOW): out[0] the
// static shared memory of ttiled_sweep, out[1] its dynamic shared memory for
// a largest window of WH x WW, out[2] and out[3] the rows and columns of the
// interior window. Returns the CUDA error of the attribute query.
int fdtd_ttiled_layout(int WH, int WW, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ttiled_sweep);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(attr.sharedSizeBytes);
  out[1] = static_cast<int>(dynamic_smem(WH, WW));
  out[2] = kWinH;
  out[3] = kWinW;
  return static_cast<int>(cudaSuccess);
}

// Advance the padded state nsteps steps on `stream` (a cudaStream_t of the
// current device, which holds every pointer): ceil(nsteps / K) sweeps, the
// last of depth nsteps % K where that is not 0. The domain is N x M cells;
// every array is (AN, ldg) floats, 16-byte aligned, ldg >= AM a multiple of
// 4, and holds the domain's rows [ar, ar + AN) and columns [ac, ac + AM) in
// its first AM columns. The sweeps write the owned cells [r_lo, r_hi) x
// [c_lo, c_hi) (domain coordinates) and no other; the single-device call
// owns the whole domain in arrays of the domain's extent. Sweep s reads
// buffer set (s even ? a : b) and writes the other, so the result is in b
// when the number of sweeps is odd, else in a. Tiles are TH x TW owned cells
// with a halo of K; `tiles` lists the n_tiles (row tile, column tile) pairs,
// edge tiles first; WH x WW is the largest window of the tiling, which sizes
// the edge body's shared memory. `amp` holds nsteps source amplitudes and
// `counters` a zero a sweep; (sx, sy) is the source in domain coordinates,
// and a window that does not hold it injects nothing. Returns the first CUDA
// error seen (cudaSuccess = 0); launches asynchronously, so faults during
// the run surface at the caller's next synchronisation.
int fdtd_ttiled_run(float* ez_a, float* hx_a, float* hy_a, float* ez_b,
                    float* hx_b, float* hy_b, const float* ce, const float* ch,
                    const float* amp, const int* tiles, int n_tiles, int* counters,
                    int N, int M, int ldg, int r_lo, int r_hi, int c_lo, int c_hi,
                    int ar, int ac, int AN, int AM,
                    int TH, int TW, int K, int nsteps, int WH, int WW, int sx, int sy,
                    float coef, void* stream) {
  const int ld = WW | 1;
  const size_t smem = dynamic_smem(WH, WW);
  cudaError_t err = cudaFuncSetAttribute(
      ttiled_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ttiled_sweep, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  EncodeTiled encode = nullptr;
  err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  Maps maps[2];  // the fields read by even and by odd sweeps
  const float* read[2][3] = {{ez_a, hx_a, hy_a}, {ez_b, hx_b, hy_b}};
  // a one-sweep call (a caller that exchanges halos between sweeps) reads set a only
  const int sets = nsteps > K ? 2 : 1;
  for (int set = 0; set < sets && err == cudaSuccess; ++set) {
    err = encode_map(encode, &maps[set].ez, read[set][0], AN, AM, ldg);
    if (err == cudaSuccess) err = encode_map(encode, &maps[set].hx, read[set][1], AN, AM, ldg);
    if (err == cudaSuccess) err = encode_map(encode, &maps[set].hy, read[set][2], AN, AM, ldg);
    if (err == cudaSuccess) err = encode_map(encode, &maps[set].ce, ce, AN, AM, ldg);
    if (err == cudaSuccess) err = encode_map(encode, &maps[set].ch, ch, AN, AM, ldg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  const Plan p{tiles, n_tiles, N, M, ldg, TH, TW, K, r_lo, r_hi, c_lo, c_hi, ar, ac};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreadsX, kThreadsY);
  int sweep = 0;
  for (int done = 0; done < nsteps; done += K, ++sweep) {
    const int steps = nsteps - done < K ? nsteps - done : K;
    const bool even = sweep % 2 == 0;
    Fields f{even ? ez_a : ez_b, even ? hx_a : hx_b, even ? hy_a : hy_b,
             even ? ez_b : ez_a, even ? hx_b : hx_a, even ? hy_b : hy_a,
             ce, ch, amp + done};
    ttiled_sweep<<<blocks, block, smem, s>>>(f, p, maps[sweep % 2], counters + sweep, steps,
                                             ld, sx, sy, coef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"

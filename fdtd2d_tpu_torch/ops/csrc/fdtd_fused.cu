// K1: nsteps fused TE leapfrog steps on the padded (N, M) float32 layout.
//
// Replaces the Pallas TPU kernel fdtd2d_tpu/ops/pallas_fdtd.py::_kernel
// (called through _padded_multistep and fdtd_multistep_pallas). That kernel
// keeps the whole state in the TPU's on-chip memory for all nsteps of a
// call. This file has two modes; ops/fdtd_fused.py picks one per call.
//
// Resident mode (resident_steps): the Hopper form of the same idea. The
// 50 MB L2 does not hold a 2048^2 state, but the 132 SMs hold 132 x 256 KB
// of registers and 132 x 227 KB of shared memory. One cooperative launch
// runs all nsteps; each block owns one tile of the grid for the whole call:
//   - Ez, Hx, Hy (and ce, ch) of the tile are read from HBM once, stepped in
//     registers, and Ez, Hx, Hy written once at the end, to output arrays of
//     their own (a neighbour may still be loading its ring from the inputs).
//     The register layout is fdtd_ttiled.cu's interior body: warps 3
//     across and some down, a thread holds R rows of one window column, its
//     vertical neighbours are its own registers, horizontal ones come by
//     __shfl_*_sync, run ends and warp edges pass through a small exchange
//     buffer with two block barriers a step. A step's time grows with R
//     (about 0.23 us a row) and falls with the warps that hide its
//     latencies, while an SM sub-partition's 16,384 registers cap a thread
//     at 16384 / (32 ceil(warps / 4)); so three variants are built, the
//     fastest one that holds the grid is used: R = 8 with ce and ch in
//     registers, 15 warps (windows of 40 x 96); R = 8, 27 warps (72 x 96)
//     and R = 15, 18 warps (90 x 96), both with each thread's ce and ch
//     parked in shared memory. Each was chosen as the largest of its shape
//     that ptxas builds without a spill.
//   - A window is the tile's owned cells plus a one-cell ring of its
//     neighbours' Ez on every side that has a neighbour. The ring cells keep
//     Hx, Hy and ch too: the ring row above recomputes the neighbour's last
//     Hx row and the ring column to the left its last Hy column, from the
//     same inputs with the same expression, so one Ez exchange a step is
//     all the tiles need. After a step (Mur, corners and source included) a
//     block publishes its first and last owned rows and columns into a
//     small scratch in device memory (it lives in L2), double-buffered by
//     the step's parity, each value in one 64-bit word with the step's tag;
//     then it reads its ring, polling each word until the tag is the
//     step's. No grid barrier: a block waits for its four neighbours only
//     (the cooperative launch guarantees that they are resident, and a wait
//     that never ends traps instead of hanging the card).
//   - Tiles own at least 6 cells a side, so a Mur chain and a 5x5 corner
//     lie in one tile, and there are at least two tiles each way, so no tile
//     touches two opposite edges. The window of a tile on the domain's last
//     row (column) ends there, so every chain starts at the end of a
//     thread's run or at a warp's first or last lane: left/right chains
//     run along the lanes of one warp by shuffles, top/bottom chains and
//     the corners in a thread's own registers, in that order, with no block
//     barrier and no shared memory but the thread's parked pre-step Ez. The
//     source is added in the register of the thread that holds (sx, sy).
//   What bounds it: not HBM (a 200-step call at 1024^2 moves 32 B a cell
//   once, 0.16 B a cell a step) but the instructions of the register body
//   and the latency of one exchange through L2 a step.
//
// Streaming mode (fdtd_fused_run), for any grid: the fields live in HBM and
// a step is two launches.
//   (A) h_update: Hx, Hy over [0, N-1) x [0, M-1). 24 B a cell.
//   (B) e_update: blocks of 32 x 8 cells update the interior Ez of
//       [6, N-6) x [6, M-6), 20 B a cell; further blocks of the same launch,
//       placed first so that they do not trail the others, hold one thread
//       per Mur chain of the middle of each band (rows and columns
//       6 .. n-7) and one block per corner region. Nothing in (B)
//       reads an Ez cell that another thread of (B) writes: a chain thread
//       owns its six cells, reads their pre-step Ez from the array itself,
//       computes their post-interior values in registers, applies the Mur
//       update to five of them and writes all six; a corner block does the
//       same for its 6 x 6 region (left/right chains of rows 1..5, then
//       top/bottom chains of columns 1..5, then the 5 x 5 corner, the only
//       place where one stage reads another's output) in shared memory.
//       Whoever writes (sx, sy) adds the source.
//   44 B a cell a step against 3.35 TB/s. (A) and (B) are not fused into one
//   32-byte pass here: that kernel exists, it is fdtd_ttiled.cu at K = 1.
//
// All arithmetic goes through the forms of fdtd_step.cuh, so a cell's value
// does not depend on the mode, tile or chunking that computed it. The source
// amplitudes amp[0..nsteps) are computed by the caller on the device (same
// function as the plain path), so chunked runs at any step offset inject
// exactly what one run does.
#include <cuda_runtime.h>

#include "fdtd_step.cuh"

namespace {

using fdtd::kBand;
using fdtd::kStrip;

// ---------------------------------------------------------------------------
// Streaming mode
// ---------------------------------------------------------------------------

constexpr int kTileX = 32;   // columns per block of (A) and (B)
constexpr int kTileY = 8;    // rows per block of (A) and (B)
constexpr int kTileThreads = kTileX * kTileY;
constexpr int kCornerCells = kStrip * kStrip;

__global__ void h_update(const float* __restrict__ ez, const float* __restrict__ ch,
                         float* __restrict__ hx, float* __restrict__ hy, int N, int M) {
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  if (i < N - 1 && j < M - 1) fdtd::h_update(ez, ch[i * M + j], hx, hy, i * M + j, M);
}

struct Source {
  const float* amp;
  int sx, sy;
};

// The post-interior Ez of interior cell k = i * M + j, from its pre-step value.
__device__ __forceinline__ float interior_value(float pre, const float* __restrict__ hx,
                                                const float* __restrict__ hy,
                                                const float* __restrict__ ce, int k, int M) {
  return fdtd::ez_next(pre, ce[k], hy[k], hy[k - 1], hx[k], hx[k - M]);
}

// One Mur chain of the middle of a band: the edge cell (i, j) and five cells
// inward by (di, dj). The thread owns all six cells.
__device__ __forceinline__ void band_chain(float* ez, const float* __restrict__ hx,
                                           const float* __restrict__ hy,
                                           const float* __restrict__ ce, int i, int j, int di,
                                           int dj, int M, float coef, const Source& src) {
  float prev[kStrip], cur[kStrip];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int k = (i + s * di) * M + j + s * dj;
    prev[s] = ez[k];
    cur[s] = s == 0 ? prev[s] : interior_value(prev[s], hx, hy, ce, k, M);
  }
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int ii = i + s * di, jj = j + s * dj;
    float v = s < kBand ? fdtd::mur_next(prev[s + 1], cur[s + 1], prev[s], coef) : cur[s];
    if (ii == src.sx && jj == src.sy) v += *src.amp;
    ez[ii * M + jj] = v;
  }
}

// One corner region: the 6 x 6 cells from corner cell (ci, cj) inward by
// (rs, cs) a row and a column, in the corner's own frame in shared memory.
__device__ __forceinline__ void corner_region(float* ez, const float* __restrict__ hx,
                                              const float* __restrict__ hy,
                                              const float* __restrict__ ce, int ci, int cj,
                                              int rs, int cs, int M, float coef,
                                              const Source& src) {
  __shared__ float pre[kCornerCells], cur[kCornerCells];
  const int t = threadIdx.y * kTileX + threadIdx.x;
  const int a = t / kStrip, b = t % kStrip;
  const int k = (ci + a * rs) * M + cj + b * cs;
  if (t < kCornerCells) {
    pre[t] = ez[k];
    cur[t] = a >= 1 && b >= 1 ? interior_value(pre[t], hx, hy, ce, k, M) : pre[t];
  }
  __syncthreads();
  if (t < kBand) fdtd::mur_chain(cur + (t + 1) * kStrip, 1, pre + (t + 1) * kStrip, 1, coef);
  __syncthreads();
  if (t < kBand) fdtd::mur_chain(cur + t + 1, kStrip, pre + t + 1, kStrip, coef);
  __syncthreads();
  float value = 0.0f;
  if (t < kBand * kBand) value = fdtd::corner_value(cur, kStrip, 1, t / kBand, t % kBand);
  __syncthreads();
  if (t < kBand * kBand) cur[(t / kBand) * kStrip + t % kBand] = value;
  __syncthreads();
  if (t < kCornerCells) {
    float v = cur[t];
    if (ci + a * rs == src.sx && cj + b * cs == src.sy) v += *src.amp;
    ez[k] = v;
  }
}

// (B). Blocks [0, chains): one thread per middle chain, left, right, top,
// bottom in that order. The next four blocks: the corner regions. The rest:
// interior Ez of [6, N-6) x [6, M-6).
__global__ void __launch_bounds__(kTileThreads)
e_update(float* ez, const float* __restrict__ hx, const float* __restrict__ hy,
         const float* __restrict__ ce, Source src, int N, int M, int tiles_x, int tiles,
         int chain_blocks, float coef) {
  // The chain and corner blocks come first: each of their threads walks six
  // cells in turn, so they start while the interior blocks fill the card
  // instead of trailing them.
  const int edge_blocks = chain_blocks + 4;
  if (blockIdx.x >= edge_blocks) {
    const int block = blockIdx.x - edge_blocks;
    const int j = (block % tiles_x) * kTileX + threadIdx.x;
    const int i = (block / tiles_x) * kTileY + threadIdx.y;
    if (i < kStrip || i >= N - kStrip || j < kStrip || j >= M - kStrip) return;
    const int k = i * M + j;
    float v = interior_value(ez[k], hx, hy, ce, k, M);
    if (i == src.sx && j == src.sy) v += *src.amp;
    ez[k] = v;
    return;
  }
  if (blockIdx.x < chain_blocks) {
    const int rows = N - 2 * kStrip, cols = M - 2 * kStrip;
    int c = blockIdx.x * kTileThreads + threadIdx.y * kTileX + threadIdx.x;
    if (c < rows) {
      band_chain(ez, hx, hy, ce, kStrip + c, 0, 0, 1, M, coef, src);
    } else if ((c -= rows) < rows) {
      band_chain(ez, hx, hy, ce, kStrip + c, M - 1, 0, -1, M, coef, src);
    } else if ((c -= rows) < cols) {
      band_chain(ez, hx, hy, ce, 0, kStrip + c, 1, 0, M, coef, src);
    } else if ((c -= cols) < cols) {
      band_chain(ez, hx, hy, ce, N - 1, kStrip + c, -1, 0, M, coef, src);
    }
    return;
  }
  const int corner = blockIdx.x - chain_blocks;
  const bool lower = corner >= 2, rightc = corner % 2 == 1;
  corner_region(ez, hx, hy, ce, lower ? N - 1 : 0, rightc ? M - 1 : 0, lower ? -1 : 1,
                rightc ? -1 : 1, M, coef, src);
}

// ---------------------------------------------------------------------------
// Resident mode
// ---------------------------------------------------------------------------

constexpr int kWarpsX = 3;           // warps across a window
constexpr int kWinW = 32 * kWarpsX;  // window columns: 96
constexpr unsigned kFull = 0xffffffffu;

struct Resident {
  const float* __restrict__ ez_in;
  const float* __restrict__ hx_in;
  const float* __restrict__ hy_in;
  const float* __restrict__ ce;
  const float* __restrict__ ch;
  const float* __restrict__ amp;
  float* __restrict__ ez_out;
  float* __restrict__ hx_out;
  float* __restrict__ hy_out;
  unsigned long long* rows;  // [2][2 nth][M]: first and last owned row of each tile row
  unsigned long long* cols;  // [2][2 ntw][N]: first and last owned column of each tile column
  unsigned base;             // steps this scratch has carried before this launch
  int N, M, nth, ntw, nsteps, sx, sy;
  float coef;
};

// What a block knows of its tile. It lives in shared memory, so that the
// step loop reads a value where it needs it (in branches that few warps
// take) instead of holding some twenty integers in registers throughout.
struct Tile {
  int own_r0, own_r1, own_c0, own_c1;  // the owned cells
  int v_r0, v_r1, v_c0, v_c1;          // the valid cells: owned cells and ring
  int r_org, c_org;                    // the domain row and column of window cell (0, 0)
  int ta, tb;                          // the tile's row and column in the tile grid
  int top, bot, left, right;           // whether it touches that edge of the domain
};

// Edge exchange between the warps of a block, as in fdtd_ttiled.cu: warp
// (wx, wy) holds window rows [R wy, R wy + R) of column 32 wx + lane. Slots
// that no warp writes hold 0; the cells that read them lie on the window's
// edge, which is a ring cell or a cell of the domain's edge.
template <int R, int kWarpsY>
struct Exchange {
  float ez_row[kWarpsY + 1][kWinW];
  float hx_row[kWarpsY + 1][kWinW];
  float ez_col[kWarpsX + 1][R * kWarpsY];
  float hy_col[kWarpsX + 1][R * kWarpsY];
};

// The exchange between blocks: a published Ez value travels with the tag of
// its step in one 64-bit word, so a reader needs no fence and no barrier: it
// polls the word until the tag is the step's. The launch is cooperative, so
// the block it waits for is resident; a wait that never ends traps.
__device__ __forceinline__ void publish(unsigned long long* slot, float v, unsigned tag) {
  const unsigned long long w = (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(slot), "l"(w) : "memory");
}

__device__ __forceinline__ float await(const unsigned long long* slot, unsigned tag) {
  for (int spin = 0;; ++spin) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(slot) : "memory");
    if (static_cast<unsigned>(w >> 32) == tag) return __uint_as_float(static_cast<unsigned>(w));
    if (spin > (1 << 24)) __trap();
  }
}

// Dynamic shared memory, private to each thread: the pre-step Ez of its R
// cells (read by the Mur stages of the warps on the domain's edge), then,
// where ce and ch do not live in registers, 2 R floats more.
template <int R, bool kCoefShared, int kWarpsY>
constexpr size_t resident_smem() {
  return sizeof(float) * R * 32 * kWarpsX * kWarpsY * (kCoefShared ? 3 : 1);
}

// What a thread is, as bits of one register.
enum Role : unsigned {
  kColIn = 1, kColOwn = 2, kLeft = 4, kRight = 8, kTop = 16, kBot = 32, kColBand = 64, kSource = 128
};

template <int R, bool kCoefShared, int kWarpsY, int kBlocksPerSM>
__global__ void __launch_bounds__(32 * kWarpsX * kWarpsY, kBlocksPerSM)
resident_steps(const Resident p) {
  constexpr int kWinH = R * kWarpsY;
  constexpr int T = 32 * kWarpsX * kWarpsY;
  extern __shared__ __align__(16) float smem[];
  __shared__ Exchange<R, kWarpsY> x;
  __shared__ Tile t;

  const int lane = threadIdx.x;
  const int tid = threadIdx.y * 32 + lane;
  const int wx = threadIdx.y % kWarpsX, wy = threadIdx.y / kWarpsX;
  float* const park = smem + tid;  // park[r * T]: pre-step Ez of row r;
                                   // park[(R + 2 r) * T], park[(R + 2 r + 1) * T]: ce, ch
  const int N = p.N, M = p.M;
  if (tid == 0) {
    const int ta = blockIdx.x / p.ntw, tb = blockIdx.x % p.ntw;
    // nth, ntw >= 2: no tile touches two opposite edges of the domain
    t.ta = ta, t.tb = tb;
    t.top = ta == 0, t.bot = ta == p.nth - 1, t.left = tb == 0, t.right = tb == p.ntw - 1;
    t.own_r0 = ta * N / p.nth, t.own_r1 = (ta + 1) * N / p.nth;
    t.own_c0 = tb * M / p.ntw, t.own_c1 = (tb + 1) * M / p.ntw;
    t.v_r0 = t.own_r0 - (t.top ? 0 : 1), t.v_r1 = t.own_r1 + (t.bot ? 0 : 1);
    t.v_c0 = t.own_c0 - (t.left ? 0 : 1), t.v_c1 = t.own_c1 + (t.right ? 0 : 1);
    // The window starts at the first valid cell, except that a bottom
    // (right) tile's window ends at the domain's last row (column), so that
    // the Mur chains of every edge start at a run's end (a warp's first or
    // last lane).
    t.r_org = t.bot ? N - kWinH : t.v_r0;
    t.c_org = t.right ? M - kWinW : t.v_c0;
  }
  for (int k = tid; k < kWinW; k += T) {
    x.ez_row[kWarpsY][k] = 0.0f;
    x.hx_row[0][k] = 0.0f;
  }
  for (int k = tid; k < kWinH; k += T) {
    x.ez_col[kWarpsX][k] = 0.0f;
    x.hy_col[0][k] = 0.0f;
  }
  __syncthreads();

  const int gi0 = t.r_org + wy * R;           // the domain row of this thread's first cell
  const int gj = t.c_org + wx * 32 + lane;    // its domain column
  unsigned role = 0;
  if (t.v_c0 <= gj && gj < t.v_c1) role |= kColIn;
  if (t.own_c0 <= gj && gj < t.own_c1) role |= kColOwn;
  if (t.left && wx == 0) role |= kLeft | (lane < kBand ? kColBand : 0);
  if (t.right && wx == kWarpsX - 1) role |= kRight | (lane >= 32 - kBand ? kColBand : 0);
  if (t.top && wy == 0) role |= kTop;
  if (t.bot && wy == kWarpsY - 1) role |= kBot;
  if ((role & kColOwn) && gj == p.sy && t.own_r0 <= p.sx && p.sx < t.own_r1 && gi0 <= p.sx &&
      p.sx < gi0 + R) {
    role |= kSource;
  }

  float ez[R], hx[R], hy[R], ce[kCoefShared ? 1 : R], ch[kCoefShared ? 1 : R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gi = gi0 + r;
    const bool in = (role & kColIn) && t.v_r0 <= gi && gi < t.v_r1;
    const int k = in ? gi * M + gj : 0;
    ez[r] = in ? p.ez_in[k] : 0.0f;
    hx[r] = in ? p.hx_in[k] : 0.0f;
    hy[r] = in ? p.hy_in[k] : 0.0f;
    const float e = in ? p.ce[k] : 0.0f, h = in ? p.ch[k] : 0.0f;
    if constexpr (kCoefShared) {
      park[(R + 2 * r) * T] = e;
      park[(R + 2 * r + 1) * T] = h;
    } else {
      ce[r] = e;
      ch[r] = h;
    }
  }
  auto ce_at = [&](int r) {
    if constexpr (kCoefShared) return park[(R + 2 * r) * T];
    else return ce[r];
  };
  auto ch_at = [&](int r) {
    if constexpr (kCoefShared) return park[(R + 2 * r + 1) * T];
    else return ch[r];
  };
  auto from_side = [&](float v) {  // the value one column inward, in an edge warp
    return (role & kLeft) ? __shfl_down_sync(kFull, v, 1) : __shfl_up_sync(kFull, v, 1);
  };

  // Every branch below on a warp's role or rows is uniform over the warp.
  for (int n = 0; n < p.nsteps; ++n) {
    // Pre-step Ez of the warps on the domain's edge, for their Mur chains.
    if (role & (kLeft | kRight | kTop | kBot)) {
#pragma unroll
      for (int r = 0; r < R; ++r) park[r * T] = ez[r];
    }

    // H update: Ez one row down (own registers; the warp below's first row)
    // and one column right (the next lane; the next warp's lane 0).
    x.ez_row[wy][wx * 32 + lane] = ez[0];
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) x.ez_col[wx][wy * R + r] = ez[r];
    }
    __syncthreads();
    const float ez_below = x.ez_row[wy + 1][wx * 32 + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float e_down = r + 1 < R ? ez[r + 1] : ez_below;
      float e_right = __shfl_down_sync(kFull, ez[r], 1);
      if (lane == 31) e_right = x.ez_col[wx + 1][wy * R + r];
      if (gi0 + r < N - 1 && gj < M - 1) {
        const float c = ch_at(r);
        hx[r] = fdtd::hx_next(hx[r], c, e_down, ez[r]);
        hy[r] = fdtd::hy_next(hy[r], c, e_right, ez[r]);
      }
    }

    // Interior Ez: Hx one row up, Hy one column left, as above mirrored.
    x.hx_row[wy + 1][wx * 32 + lane] = hx[R - 1];
    if (lane == 31) {
#pragma unroll
      for (int r = 0; r < R; ++r) x.hy_col[wx + 1][wy * R + r] = hy[r];
    }
    __syncthreads();
    const float hx_above = x.hx_row[wy][wx * 32 + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hx_up = r > 0 ? hx[r - 1] : hx_above;
      float hy_left = __shfl_up_sync(kFull, hy[r], 1);
      if (lane == 0) hy_left = x.hy_col[wx][wy * R + r];
      const int gi = gi0 + r;
      if (gi >= 1 && gi < N - 1 && gj >= 1 && gj < M - 1) {
        ez[r] = fdtd::ez_next(ez[r], ce_at(r), hy[r], hy_left, hx[r], hx_up);
      }
    }

    // Mur bands and corners, in the registers of the warps on the domain's
    // edge. Left/right chains run along a row: cell s of a chain is lane s
    // (31 - s) of the first (last) warp column, its inward neighbour one
    // shuffle away.
    if (role & (kLeft | kRight)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pv = park[r * T];
        const float c_in = from_side(ez[r]), p_in = from_side(pv);
        const int gi = gi0 + r;
        if ((role & kColBand) && gi >= 1 && gi <= N - 2) {
          ez[r] = fdtd::mur_next(p_in, c_in, pv, p.coef);
        }
      }
    }
    // Top/bottom chains run down a column: the thread's first (last) six
    // rows, after the left/right stage; cell s reads cell s + 1 before that
    // is overwritten.
    if ((role & kTop) && gj >= 1 && gj <= M - 2) {
#pragma unroll
      for (int s = 0; s < kBand; ++s) {
        ez[s] = fdtd::mur_next(park[(s + 1) * T], ez[s + 1], park[s * T], p.coef);
      }
    }
    if ((role & kBot) && gj >= 1 && gj <= M - 2) {
#pragma unroll
      for (int s = 0; s < kBand; ++s) {
        ez[R - 1 - s] = fdtd::mur_next(park[(R - 2 - s) * T], ez[R - 2 - s],
                                       park[(R - 1 - s) * T], p.coef);
      }
    }
    // The 5x5 corner: every value from the post-band Ez, then the stores.
    if ((role & (kTop | kBot)) && (role & (kLeft | kRight))) {
      float v[kBand];
#pragma unroll
      for (int a = 0; a < kBand; ++a) {
        const float own = (role & kTop) ? ez[a] : ez[R - 1 - a];
        const float inward = (role & kTop) ? ez[a + 1] : ez[R - 2 - a];
        v[a] = fdtd::corner_mean(from_side(own), inward);
      }
      if (role & kColBand) {
#pragma unroll
        for (int a = 0; a < kBand; ++a) {
          if (role & kTop) ez[a] = v[a];
          else ez[R - 1 - a] = v[a];
        }
      }
    }

    // Additive point source, in the tile that owns it.
    if (role & kSource) {
      const float a = p.amp[n];
      const int src_r = p.sx - gi0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r == src_r) ez[r] += a;
      }
    }

    if (n + 1 == p.nsteps) break;

    // Publish the owned edge rows and columns under this step's tag, then
    // read the ring as the neighbours publish theirs. The buffers alternate
    // with the step: a neighbour publishes step n + 1 only after it has read
    // this block's step n, which this block published after reading the
    // neighbour's step n - 1, so a slot is never overwritten unread.
    const unsigned tag = p.base + static_cast<unsigned>(n) + 1u;
    unsigned long long* rows = p.rows + ((n & 1) * 2 * p.nth + 2 * t.ta) * M + gj;
    unsigned long long* cols = p.cols + ((n & 1) * 2 * p.ntw + 2 * t.tb) * N + gi0;
    {
      const int first = t.own_r0 - gi0, last = t.own_r1 - 1 - gi0;
      if (0 <= first && first < R && (role & kColOwn)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == first) publish(rows, ez[r], tag);
        }
      }
      if (0 <= last && last < R && (role & kColOwn)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == last) publish(rows + M, ez[r], tag);
        }
      }
      const int slot = gj == t.own_c0 ? 0 : gj == t.own_c1 - 1 ? 1 : -1;
      if (__any_sync(kFull, slot >= 0)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (slot >= 0 && first <= r && r <= last) publish(cols + slot * N + r, ez[r], tag);
        }
      }
    }
    // Ring rows: one word a thread. Ring columns: lane r of the warp awaits
    // row r, and a shuffle hands it to the lane that holds the column, so
    // that no thread waits for R words in turn.
    {
      const int up = t.top ? -1 : t.v_r0 - gi0, down = t.bot ? -1 : t.v_r1 - 1 - gi0;
      if (0 <= up && up < R && (role & kColIn)) {
        const float v = await(rows - M, tag);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == up) ez[r] = v;
        }
      }
      if (0 <= down && down < R && (role & kColIn)) {
        const float v = await(rows + 2 * M, tag);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == down) ez[r] = v;
        }
      }
      const int lo = t.v_r0 - gi0, hi = t.v_r1 - gi0;  // this thread's valid rows [lo, hi)
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        // the window column of the ring's left (right) column, if there is one
        const int wc = side == 0 ? (t.left ? -1 : t.v_c0 - t.c_org)
                                 : (t.right ? -1 : t.v_c1 - 1 - t.c_org);
        if (wc < 0 || wx != wc / 32) continue;
        float mine = 0.0f;
        if (lane < R && lo <= lane && lane < hi) {
          mine = await(cols + (side == 0 ? -N : 2 * N) + lane, tag);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = __shfl_sync(kFull, mine, r);
          if (lane == wc % 32 && lo <= r && r < hi) ez[r] = v;
        }
      }
    }
  }

  if (role & kColOwn) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gi = gi0 + r;
      if (t.own_r0 <= gi && gi < t.own_r1) {
        const int k = gi * M + gj;
        p.ez_out[k] = ez[r];
        p.hx_out[k] = hx[r];
        p.hy_out[k] = hy[r];
      }
    }
  }
}

// The variants that are built: rows a thread holds, whether its ce and ch
// are parked in shared memory, warps down a window, blocks an SM. Mirrored
// by ops/fdtd_fused.py::VARIANTS.
constexpr int kVariants = 3;

struct Variant {
  const void* kernel;
  int rows, warps_y;
  size_t smem;
};

template <int R, bool kCoefShared, int kWarpsY, int kBlocksPerSM>
Variant make_variant() {
  return {reinterpret_cast<const void*>(&resident_steps<R, kCoefShared, kWarpsY, kBlocksPerSM>),
          R, kWarpsY, resident_smem<R, kCoefShared, kWarpsY>()};
}

Variant variant_of(int v) {
  switch (v) {
    case 0: return make_variant<8, false, 5, 1>();   // 15 warps, windows of 40 x 96
    case 1: return make_variant<8, true, 9, 1>();    // 27 warps, windows of 72 x 96
    default: return make_variant<15, true, 6, 1>();  // 18 warps, windows of 90 x 96
  }
}

// Blocks of `v` that can be resident on the current device at once.
cudaError_t coresident_blocks(const Variant& v, int* blocks) {
  int device = 0, sms = 0, per_sm = 0, cooperative = 0;
  cudaError_t err = cudaFuncSetAttribute(v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(v.smem));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  }
  if (err == cudaSuccess && !cooperative) err = cudaErrorNotSupported;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.kernel,
                                                        32 * kWarpsX * v.warps_y, v.smem);
  }
  *blocks = sms * per_sm;
  return err;
}

}  // namespace

extern "C" {

// Streaming mode: advance the padded state nsteps steps in place on `stream`
// (a cudaStream_t of the current device, which holds every pointer; null is
// the legacy default stream), two launches a step. `amp` holds nsteps source
// amplitudes. Returns the first CUDA error seen (cudaSuccess = 0). Launches
// asynchronously; faults during the run surface at the caller's next
// synchronisation.
int fdtd_fused_run(float* ez, float* hx, float* hy, const float* ce, const float* ch,
                   const float* amp, int N, int M, int nsteps, int sx, int sy, float coef,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTileX, kTileY);
  const int tiles_x = (M + kTileX - 1) / kTileX, tiles_y = (N + kTileY - 1) / kTileY;
  const int chains = 2 * (N - 2 * kStrip) + 2 * (M - 2 * kStrip);
  const int chain_blocks = (chains + kTileThreads - 1) / kTileThreads;
  const int tiles = tiles_x * tiles_y;
  for (int n = 0; n < nsteps; ++n) {
    h_update<<<dim3(tiles_x, tiles_y), block, 0, s>>>(ez, ch, hx, hy, N, M);
    e_update<<<tiles + chain_blocks + 4, block, 0, s>>>(ez, hx, hy, ce, Source{amp + n, sx, sy},
                                                        N, M, tiles_x, tiles, chain_blocks, coef);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The resident kernel's layout, which the host's planner copies
// (ops/fdtd_fused.py::VARIANTS): for variant v, out[0] the static and out[1]
// the dynamic shared memory of a block, out[2] and out[3] the rows and
// columns of its window, out[4] its threads, out[5] its registers a thread,
// out[6] the blocks that the current device can hold resident at once. Returns the CUDA error of the
// queries; cudaErrorInvalidValue for a variant that is not built.
int fdtd_fused_resident_layout(int v, int* out) {
  if (v < 0 || v >= kVariants) return static_cast<int>(cudaErrorInvalidValue);
  const Variant var = variant_of(v);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, var.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(attr.sharedSizeBytes);
  out[1] = static_cast<int>(var.smem);
  out[2] = var.rows * var.warps_y;
  out[3] = kWinW;
  out[4] = 32 * kWarpsX * var.warps_y;
  out[5] = attr.numRegs;
  err = coresident_blocks(var, &out[6]);
  return static_cast<int>(err);
}

// Resident mode: nsteps >= 1 steps in one cooperative launch of nth x ntw
// blocks on `stream`, tile (a, b) owning rows [a N / nth, (a + 1) N / nth)
// and columns [b M / ntw, (b + 1) M / ntw). Reads the padded (N, M) inputs,
// writes the padded outputs (other arrays). `rows` holds 2 * 2 nth * M 64-bit
// words and `cols` 2 * 2 ntw * N of scratch, zero when first used; `base` is
// the number of steps the scratch has carried so far (the tags of this
// launch are base + 1 .. base + nsteps - 1). Returns the first CUDA error: cudaErrorInvalidValue when a
// tile does not fit the variant's window, and the runtime's error when it
// refuses the launch (more blocks than can be resident).
int fdtd_fused_resident_run(const float* ez_in, const float* hx_in, const float* hy_in,
                            const float* ce, const float* ch, const float* amp, float* ez_out,
                            float* hx_out, float* hy_out, unsigned long long* rows,
                            unsigned long long* cols, unsigned base, int N, int M, int nth, int ntw,
                            int v, int nsteps, int sx, int sy, float coef, void* stream) {
  if (v < 0 || v >= kVariants || nth < 2 || ntw < 2 || nsteps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Variant var = variant_of(v);
  // the largest window: the largest tile and its ring (an edge tile has one side less)
  const int tile_h = (N + nth - 1) / nth + (nth > 2 ? 2 : nth - 1);
  const int tile_w = (M + ntw - 1) / ntw + (ntw > 2 ? 2 : ntw - 1);
  if (tile_h > var.rows * var.warps_y || tile_w > kWinW || N / nth < kStrip || M / ntw < kStrip) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  cudaError_t err = coresident_blocks(var, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  Resident p{ez_in, hx_in, hy_in, ce, ch, amp, ez_out, hx_out, hy_out, rows, cols,
             base, N, M, nth, ntw, nsteps, sx, sy, coef};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(var.kernel, dim3(nth * ntw), dim3(32, kWarpsX * var.warps_y),
                                    args, var.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0] the SMs of the current device, out[1] the 32-bit registers of an SM,
// out[2] the bytes of shared memory a block may use: what the host's
// planner sizes the resident tile grid with.
int fdtd_device_numbers(int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMultiProcessorCount,
                                   cudaDevAttrMaxRegistersPerMultiprocessor,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin};
  for (int a = 0; a < 3 && err == cudaSuccess; ++a) {
    err = cudaDeviceGetAttribute(&out[a], attrs[a], device);
  }
  return static_cast<int>(err);
}

const char* fdtd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

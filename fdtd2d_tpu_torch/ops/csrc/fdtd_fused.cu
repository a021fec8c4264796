// K1: nsteps fused TE leapfrog steps on the padded (N, M) float32 layout.
//
// Replaces the Pallas TPU kernel fdtd2d_tpu/ops/pallas_fdtd.py::_kernel
// (called through _padded_multistep and fdtd_multistep_pallas). That kernel
// keeps the whole state in the TPU's on-chip memory for all nsteps. On this
// card the 2048^2 state (five float32 arrays, 84 MB) is larger than the 50 MB
// L2, so here the fields live in HBM and every step is a pass over them.
//
// Bound on this card: HBM bytes per cell per step. Launch (A) reads Ez, ch,
// Hx, Hy and writes Hx, Hy: 24 B. Launch (B) reads Ez, Hx, Hy, ce and writes
// Ez: 20 B. So 44 B/cell/step against the data sheet's 3.35 TB/s at 700 W,
// about 76 Gcell-steps/s at best; (C) touches only the boundary strips. One
// fused pass would move 32 B (5 reads, 3 writes): the temporally tiled
// kernel fdtd_ttiled.cu is such a pass at K = 1 (the halo H recomputed in
// the tile) and divides the traffic by about K beyond. Later work here: run
// several steps per launch while the state fits in L2.
//
// Per step, three launches on the caller's stream:
//   (A) H update over [0, N-1) x [0, M-1), and a copy of the pre-step Ez
//       strips (left/right N x 6, top/bottom 6 x M) into `strips`. Safe in
//       the same launch because (A) does not write Ez.
//   (B) interior Ez update over [1, N-1) x [1, M-1).
//   (C) one block: Mur left/right (rows 1..N-2), then Mur top/bottom
//       (columns 1..M-2), then the four 5x5 corners, then the point source,
//       with __syncthreads() between the stages so that each stage reads the
//       previous stage's output, as fdtd2d_tpu/fdtd/step.py does.
//
// The source amplitudes amp[0..nsteps) are computed by the caller on the
// device (same function as the plain path), so chunked runs at any step
// offset inject exactly what one run does.
#include <cuda_runtime.h>

#include "fdtd_step.cuh"

namespace {

using fdtd::kBand;
using fdtd::kStrip;

constexpr int kTileX = 32;   // columns per block of (A) and (B)
constexpr int kTileY = 8;    // rows per block of (A) and (B)
constexpr int kBoundaryThreads = 1024;

// Strip buffer layout: left (N x 6), right (N x 6), top (6 x M), bottom (6 x M).
struct Strips {
  float* left;
  float* right;
  float* top;
  float* bottom;
};

__device__ __forceinline__ Strips split_strips(float* base, int N, int M) {
  Strips s;
  s.left = base;
  s.right = s.left + N * kStrip;
  s.top = s.right + N * kStrip;
  s.bottom = s.top + kStrip * M;
  return s;
}

__global__ void h_update_and_save_strips(const float* __restrict__ ez,
                                         const float* __restrict__ ch,
                                         float* __restrict__ hx,
                                         float* __restrict__ hy,
                                         float* __restrict__ strips,
                                         int N, int M) {
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  if (i >= N || j >= M) return;
  if (i < N - 1 && j < M - 1) {
    fdtd::h_update(ez, ch[i * M + j], hx, hy, i * M + j, M);
  }

  const Strips s = split_strips(strips, N, M);
  const float e = ez[i * M + j];
  if (j < kStrip) s.left[i * kStrip + j] = e;
  if (j >= M - kStrip) s.right[i * kStrip + (j - (M - kStrip))] = e;
  if (i < kStrip) s.top[i * M + j] = e;
  if (i >= N - kStrip) s.bottom[(i - (N - kStrip)) * M + j] = e;
}

__global__ void e_interior_update(float* __restrict__ ez,
                                  const float* __restrict__ hx,
                                  const float* __restrict__ hy,
                                  const float* __restrict__ ce, int N, int M) {
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  if (i < 1 || i >= N - 1 || j < 1 || j >= M - 1) return;
  fdtd::e_interior(ez, hx, hy, ce[i * M + j], i * M + j, M);
}

// Single block. Every thread reaches every __syncthreads(): the stage loops
// and the corner branch only guard the work, never a barrier.
__global__ void __launch_bounds__(kBoundaryThreads)
boundary_update(float* ez, float* strips, const float* amp, int N, int M,
                int sx, int sy, float coef) {
  const Strips s = split_strips(strips, N, M);
  const int tid = threadIdx.x;

  // Stage 1: Mur left/right bands, rows 1..N-2 (read post-interior Ez).
  for (int i = 1 + tid; i < N - 1; i += blockDim.x) {
    fdtd::mur_chain(ez + i * M, 1, s.left + i * kStrip, 1, coef);
    fdtd::mur_chain(ez + i * M + (M - 1), -1,
                    s.right + i * kStrip + (kStrip - 1), -1, coef);
  }
  __syncthreads();

  // Stage 2: Mur top/bottom bands, columns 1..M-2 (read post-left/right Ez).
  for (int j = 1 + tid; j < M - 1; j += blockDim.x) {
    fdtd::mur_chain(ez + j, M, s.top + j, M, coef);
    fdtd::mur_chain(ez + (N - 1) * M + j, -M,
                    s.bottom + (kStrip - 1) * M + j, -M, coef);
  }
  __syncthreads();

  // Stage 3: the four 5x5 corners (read post-top/bottom Ez). Cells of one
  // corner read each other, so all 100 values are computed before any store.
  const bool corner_thread = tid < 4 * kBand * kBand;
  float* cell = nullptr;
  float value = 0.0f;
  if (corner_thread) {
    const int corner = tid / (kBand * kBand);
    const int a = (tid % (kBand * kBand)) / kBand;
    const int b = tid % kBand;
    const bool bottom = corner >= 2;
    const bool right = corner % 2 == 1;
    const int rs = bottom ? -M : M;
    const int cs = right ? -1 : 1;
    float* c = ez + (bottom ? (N - 1) * M : 0) + (right ? M - 1 : 0);
    value = fdtd::corner_value(c, rs, cs, a, b);
    cell = c + a * rs + b * cs;
  }
  __syncthreads();
  if (corner_thread) *cell = value;
  __syncthreads();

  // Stage 4: additive point source.
  if (tid == 0) ez[sx * M + sy] += *amp;
}

}  // namespace

extern "C" {

// Advance the padded state nsteps steps on `stream` (a cudaStream_t of the
// current device, which holds every pointer; null is the legacy default
// stream). `amp` holds nsteps source amplitudes, `strips` 2*N*6 + 2*6*M
// floats of scratch. Returns the first CUDA error seen (cudaSuccess = 0).
// Launches asynchronously; faults during the run surface at the caller's
// next synchronisation.
int fdtd_fused_run(float* ez, float* hx, float* hy, const float* ce,
                   const float* ch, const float* amp, float* strips, int N,
                   int M, int nsteps, int sx, int sy, float coef,
                   void* stream) {
  cudaError_t err = cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTileX, kTileY);
  const dim3 grid((M + kTileX - 1) / kTileX, (N + kTileY - 1) / kTileY);
  for (int n = 0; n < nsteps; ++n) {
    h_update_and_save_strips<<<grid, block, 0, s>>>(ez, ch, hx, hy, strips, N, M);
    e_interior_update<<<grid, block, 0, s>>>(ez, hx, hy, ce, N, M);
    boundary_update<<<1, kBoundaryThreads, 0, s>>>(ez, strips, amp + n, N, M,
                                                   sx, sy, coef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

const char* fdtd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

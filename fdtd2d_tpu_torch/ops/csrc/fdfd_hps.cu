// The HPS sweeps: one launch a merge level and direction of the nested-
// dissection backsolve (fdtd2d_tpu_torch/fdfd/hps.py), the leaf included.
//
// It replaces no TPU kernel. The JAX package runs the sweeps as XLA's batched
// matmuls and gathers with no Pallas kernel (fdtd2d_tpu/fdfd/hps.py,
// _solve_cols); the port ran them as torch ops, five index gathers a level
// between two batched complex64 products that cuBLAS tiles 64 x 32 for
// matrices of 12 to 124 rows. With the plan's per-level factors Y = A_JJ^{-1}
// (nJ x nJ) and E = Y A_JR (nJ x nR) of every parent, and K right-hand sides
// (a chunk of at most 16, padded to KP = 1, 4, 8 or 16):
//
//   up    g = Y b_J                 (kept for the way down)
//         b_parent = b_R - E^T b_J  (to the next level)
//   down  x_J = g - E x_R           (x_R: the parent's skeleton)
//         x_J and x_R to the two children's skeletons (the table)
//
// The leaf is the same step with the sublattice grid, (G, K, nr nc), as the
// children: its table holds each box's interior, then ring, points. Up, a
// level writes each parent row where the next level reads it, in that
// level's J-then-R order (out_map), so a merge reads b_J and b_R in order
// and only the leaf gathers. Down, x_J and x_R go to the children's ring
// order through the table, and the leaf writes the interior and copies the
// ring: every grid point is written once, by the leaf box that holds it.
//
// What bounds it: at 2048^2, K = 16, an inner solve reads Y once and E twice,
// ~10 GB (3.0 ms at 3.35 TB/s), and each complex64 value of Y or E feeds 16
// complex multiply-adds, 64 float32 FMAs: 2.31 ms at 67 TFLOP/s. So the
// products must be FMA-dense while the factors stream at HBM's rate; the
// skeleton vectors (about half as many bytes again, more than the factors at
// the lowest levels) move once a level, straight between the products.
//
// The design, one CTA of 256 threads a block of rows:
// - The rows of a launch are every item's (a group and a parent) output
//   rows, item after item: up, the nJ rows of Y then the nR columns of E (the
//   rows of E^T); down, the nJ rows of E. A block is RS consecutive rows (64
//   for KP = 16, 128 for 8, 256 for 4 and 1): a thread owns a row and 4 of
//   its KP right-hand sides (all, for KP = 1). Small items pack many to a
//   block, large ones split over blocks, so the tiling follows nJ, nR and the
//   item count alone; the low levels' thousands of small blocks keep several
//   CTAs on an SM. Every leading index of the factors is a group.
// - The reduction runs in chunks of tc terms through a two-stage ring in
//   shared memory, the next chunk in flight while one is computed
//   (cp.async): the block's factor segments, term by term up (Y's rows as
//   torch.linalg.inv leaves them on the card, and E's columns, lie along
//   memory: 16-byte copies) and row by row down (rows of tc + 1 values, an
//   odd stride: a warp's rows meet no bank twice), and each item's tc x KP
//   vector chunk, rows padded to KP + 2. A thread reads one factor value and
//   two 16-byte vector values a term and makes 16 complex multiply-adds.
// - The epilogue writes g, b_R - E^T b_J or g - E x_R; its operands and
//   destinations are loaded while the first chunk is in flight.
//
// Products are complex64 with float32 FMAs, as cuBLAS's cf32 GEMM makes them;
// no TF32, no tensor cores. Only the order of summation differs from the
// torch path: each chunk's terms are summed on their own and the chunk sums
// added in order, a blocked sum whose rounding over the top levels' 2,044 to
// 4,092 terms is well below one sequential chain's.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Level {
  const float2* Y;     // (items, nJ, nJ), or each item's transpose (y_t); read up only
  const float2* E;     // (items, nJ, nR)
  const int* table;    // (P, nJ + nR): the child-space point of each J, then each R point;
                       // none up at a merge, whose children lie in its J-then-R order
  const int* out_map;  // up: each parent row's place in the next level's J-then-R order, or none
  float2* child;       // the children's skeletons (or the grid) of this chunk of right-hand sides
  long long child_g;   // its strides in complex64 values: a group,
  long long child_p;   // a point,
  long long child_k;   // a right-hand side
  float2* parent;      // (items, nR, KP): up writes b_R - E^T b_J, down reads x_R
  float2* g;           // (items, nJ, KP): up writes Y b_J, down reads it
  int child_kw;        // right-hand sides the child space holds: reads past them are 0
  int y_t;             // Y's rows lie along memory's columns (torch.linalg.inv's layout on the card)
  int items, P, nJ, nR, tc, ni;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's latest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's threads copy an h x w block of complex64 values, (y, x) from
// src[y sy + x] to dst[y dy + x dx], in turn along x, the source's
// contiguous axis.
__device__ __forceinline__ void copy2d(float2* dst, int dy, int dx, const float2* src,
                                       long long sy, int h, int w) {
  int x = static_cast<int>(threadIdx.x) % w, y = static_cast<int>(threadIdx.x) / w;
  const int ax = kThreads % w, ay = kThreads / w;
  while (y < h) {
    cp_async8(dst + y * dy + x * dx, src + y * sy + x);
    x += ax;
    y += ay;
    if (x >= w) {
      x -= w;
      ++y;
    }
  }
}

// One term of a thread's sums: the factor value m times the KB vector values
// at v (16-byte aligned for KB = 4), into acc (complex j at acc[2 j], acc[2 j + 1]).
template <int KB>
__device__ __forceinline__ void mac(float (&acc)[2 * KB], const float2 m, const float2* v) {
  float2 w[KB];
  if constexpr (KB == 1) {
    w[0] = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < KB / 2; ++j) {
      const float4 t = reinterpret_cast<const float4*>(v)[j];
      w[2 * j] = make_float2(t.x, t.y);
      w[2 * j + 1] = make_float2(t.z, t.w);
    }
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    acc[2 * j] = fmaf(m.x, w[j].x, acc[2 * j]);
    acc[2 * j] = fmaf(-m.y, w[j].y, acc[2 * j]);
    acc[2 * j + 1] = fmaf(m.x, w[j].y, acc[2 * j + 1]);
    acc[2 * j + 1] = fmaf(m.y, w[j].x, acc[2 * j + 1]);
  }
}
// Copies an h x w block (w even) 16 bytes at a time: (y, x) from src[y sy +
// x] to dst[y dy + x]; every row start 16-byte aligned.
__device__ __forceinline__ void copy2d16(float2* dst, int dy, const float2* src, long long sy,
                                         int h, int w) {
  const int w2 = w / 2;
  int x = static_cast<int>(threadIdx.x) % w2, y = static_cast<int>(threadIdx.x) / w2;
  const int ax = kThreads % w2, ay = kThreads / w2;
  while (y < h) {
    cp_async16(dst + y * dy + 2 * x, src + y * sy + 2 * x);
    x += ax;
    y += ay;
    if (x >= w2) {
      x -= w2;
      ++y;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return !(reinterpret_cast<uintptr_t>(a) & 15);
}

// h x w values along rows (dst rows at dy), 16 bytes at a time where every
// row start allows it, else 8
__device__ __forceinline__ void copy_rows(float2* dst, int dy, const float2* src, long long sy,
                                          int h, int w) {
  if (!(w & 1) && !(dy & 1) && !(sy & 1) && aligned16(dst) && aligned16(src)) {
    copy2d16(dst, dy, src, sy, h, w);
  } else {
    copy2d(dst, dy, 1, src, sy, h, w);
  }
}

constexpr int kStages = 2;   // the ring: the next chunk in flight while one is computed

template <int KP>
struct Shape {
  static constexpr int KB = KP < 4 ? KP : 4;        // right-hand sides a thread
  static constexpr int KBLK = KP / KB;              // threads across a row
  static constexpr int RS = kThreads / KBLK;        // rows a block: 64, 128 or 256
  static constexpr int VS = KP < 4 ? KP : KP + 2;   // complex values a vector row in shared memory
};

// complex64 values of one ring stage: the block's factor segments (term by
// term up, row by row at a stride of tc + 1 down) and its items' vector chunks
template <int KP, bool kDown>
__host__ __device__ constexpr int stage_values(int tc, int ni) {
  using S = Shape<KP>;
  return (kDown ? S::RS * (tc + 1) : tc * S::RS) + ni * tc * S::VS;
}

template <int KP, bool kDown>
__global__ void __launch_bounds__(kThreads) hps_level(const Level p) {
  using S = Shape<KP>;
  constexpr int KB = S::KB, KBLK = S::KBLK, RS = S::RS, VS = S::VS;
  constexpr int kGather = 4;   // table entries a thread loads at once, ahead of its copies
  constexpr int kShare = 4;    // x_R rows of a row's share whose points it loads ahead
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const ring = reinterpret_cast<float2*>(smem);

  const int nJ = p.nJ, nR = p.nR, tc = p.tc;
  const int MS = kDown ? tc + 1 : RS;   // down: rows of tc terms at MS; up: terms of RS rows
  const int R = kDown ? nJ : nJ + nR;   // rows an item
  const int T = kDown ? nR : nJ;        // terms a row
  const int nch = (T + tc - 1) / tc;
  const int stage = stage_values<KP, kDown>(tc, p.ni);
  const int voff = kDown ? RS * MS : tc * RS;   // the vector chunks in a stage
  const int q0 = static_cast<int>(blockIdx.x) * RS;
  const int nrows = min(RS, p.items * R - q0);
  const int i_lo = q0 / R, i_hi = (q0 + nrows - 1) / R;
  // the lambdas capture locals only: no reference to the parameter struct
  const float2* const Y = p.Y;
  const float2* const E = p.E;
  const int* const table = p.table;
  const float2* const parent = p.parent;
  float2* const child = p.child;
  const long long child_g = p.child_g, child_p = p.child_p, child_k = p.child_k;
  const int child_kw = p.child_kw, P = p.P;
  const bool y_t = p.y_t;
  const int tid = threadIdx.x;

  // the values (k < KP) of `tab`'s n child-space points into dst rows of VS,
  // one value a (point, k), along the points; right-hand sides the space
  // does not hold read 0. The thread's first table entries are loaded
  // together, so their latencies overlap, and only then its copies issued.
  auto gather = [&](float2* dst, const int* tab, const float2* cg, int n) {
    const int total = n * KP;
    int at[kGather];
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      const int e = tid + j * kThreads;
      at[j] = e < total ? tab[e % n] : 0;
    }
    auto one = [&](int e, int point) {
      const int c = e % n, k = e / n;
      if (k < child_kw) {
        cp_async8(dst + c * VS + k, cg + static_cast<long long>(point) * child_p + k * child_k);
      } else {
        dst[c * VS + k] = make_float2(0.f, 0.f);
      }
    };
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      const int e = tid + j * kThreads;
      if (e < total) one(e, at[j]);
    }
    for (int e = tid + kGather * kThreads; e < total; e += kThreads) one(e, tab[e % n]);
  };
  // n rows of KP values lying together at src into dst rows of VS
  auto rows_in = [&](float2* dst, const float2* src, int n) {
    if constexpr (KP == 1) {
      for (int e = tid; e < n; e += kThreads) cp_async8(dst + e, src + e);
    } else {
      for (int e = tid; e < n * (KP / 2); e += kThreads) {
        const int r = e / (KP / 2), u = e % (KP / 2);
        cp_async16(dst + r * VS + 2 * u, src + r * KP + 2 * u);
      }
    }
  };

  // chunk ch's factor segments and vector rows into ring stage st
  auto issue = [&](int ch, int st) {
    const int c0 = ch * tc, tn = min(tc, T - c0);
    float2* const Ms = ring + st * stage;
    for (int i = i_lo; i <= i_hi; ++i) {
      const int first = i * R;   // the item's rows in the block: [a, b)
      const int a = max(first, q0) - first;
      const int b = min(first + R, q0 + nrows) - first;
      const int slot = first + a - q0;
      if (kDown) {   // rows of E, row by row
        copy2d(Ms + slot * MS, MS, 1, E + (static_cast<long long>(i) * nJ + a) * nR + c0, nR, b - a,
               tn);
      } else {       // term by term: Y's rows (stored as columns, or transposed here) and E's columns
        if (a < nJ && y_t) {
          copy_rows(Ms + slot, RS, Y + (static_cast<long long>(i) * nJ + c0) * nJ + a, nJ, tn,
                    min(b, nJ) - a);
        } else if (a < nJ) {
          copy2d(Ms + slot, 1, RS, Y + (static_cast<long long>(i) * nJ + a) * nJ + c0, nJ,
                 min(b, nJ) - a, tn);
        }
        const int ea = max(a, nJ);
        if (b > ea) {
          copy_rows(Ms + slot + ea - a, RS, E + (static_cast<long long>(i) * nJ + c0) * nR + ea - nJ,
                    nR, tn, b - ea);
        }
      }
      float2* const Vi = Ms + voff + (i - i_lo) * tc * VS;
      if (kDown) {   // x_R rows [c0, c0 + tn), lying together
        rows_in(Vi, parent + (static_cast<long long>(i) * nR + c0) * KP, tn);
      } else if (table == nullptr) {   // b_J rows, the children in the item's J-then-R order
        rows_in(Vi, child + (static_cast<long long>(i) * (nJ + nR) + c0) * KP, tn);
      } else {       // b_J through the table (the leaf's grid)
        gather(Vi, table + static_cast<long long>(i % P) * (nJ + nR) + c0,
               child + static_cast<long long>(i / P) * child_g, tn);
      }
    }
  };

  issue(0, 0);
  cp_commit();
  // this thread's output: row s of the block, right-hand sides k0 .. k0 + KB - 1
  const int s = tid / KBLK, k0 = tid % KBLK * KB;
  const bool active = s < nrows;
  const int q = q0 + (active ? s : 0), item = q / R, o = q % R;
  const int pi = item % P, gi = item / P;
  const int* tab = table + static_cast<long long>(pi) * (nJ + nR);
  float2* const cg = child + static_cast<long long>(gi) * child_g;
  const int r_lo = (o * nR + nJ - 1) / nJ, r_hi = ((o + 1) * nR + nJ - 1) / nJ;
  // loads whose latency the first chunk's copies cover: destinations and the
  // epilogue's operands (b_R up, g down)
  long long dest = 0;   // up: b_parent's row; down: x_J's point
  int share[kShare];    // down: the points of this row's share of x_R
  float2 pre[KB];
  if (active) {
    if (kDown) {
      dest = tab[o];
#pragma unroll
      for (int j = 0; j < kShare; ++j) share[j] = r_lo + j < r_hi ? tab[nJ + r_lo + j] : 0;
#pragma unroll
      for (int j = 0; j < KB; ++j) pre[j] = p.g[(static_cast<long long>(item) * nJ + o) * KP + k0 + j];
    } else if (o >= nJ) {
      const int r = pi * nR + o - nJ;
      dest = static_cast<long long>(gi) * P * nR + (p.out_map ? p.out_map[r] : r);
      const long long src = table ? static_cast<long long>(tab[o]) * child_p
                                  : (static_cast<long long>(pi) * (nJ + nR) + o) * KP;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        pre[j] = k0 + j < child_kw ? cg[src + (k0 + j) * child_k] : make_float2(0.f, 0.f);
      }
    }
  }

  float acc[2 * KB], sum[2 * KB];   // a chunk's sums, and the chunks' before it
#pragma unroll
  for (int m = 0; m < 2 * KB; ++m) acc[m] = sum[m] = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) issue(ch + 1, (ch + 1) % kStages);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (active) {
      const int c0 = ch * tc, tn = min(tc, T - c0);
      const float2* Ms = ring + (ch % kStages) * stage;
      const float2* vrow = Ms + voff + (item - i_lo) * tc * VS + k0;
      const int mstep = kDown ? 1 : RS;
      const float2* mrow = Ms + (kDown ? s * MS : s);
#pragma unroll 4
      for (int c = 0; c < tn; ++c) mac<KB>(acc, mrow[c * mstep], vrow + c * VS);
#pragma unroll
      for (int m = 0; m < 2 * KB; ++m) {   // a chunk's sums join the total in chunk order
        sum[m] = ch ? sum[m] + acc[m] : acc[m];
        acc[m] = 0.f;
      }
      if (kDown) {   // this row's share of x_R that lies in the chunk, to the children
        auto put = [&](int r, int point) {
          float2* d = cg + static_cast<long long>(point) * child_p;
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (k0 + j < child_kw) d[(k0 + j) * child_k] = vrow[(r - c0) * VS + j];
          }
        };
#pragma unroll
        for (int j = 0; j < kShare; ++j) {
          const int r = r_lo + j;
          if (r < r_hi && r >= c0 && r < c0 + tn) put(r, share[j]);
        }
        for (int r = max(r_lo + kShare, c0); r < min(r_hi, c0 + tn); ++r) put(r, tab[nJ + r]);
      }
    }
    __syncthreads();
  }
  if (!active) return;
  if (!kDown && o < nJ) {   // g = Y b_J
    float2* d = p.g + (static_cast<long long>(item) * nJ + o) * KP + k0;
#pragma unroll
    for (int j = 0; j < KB; ++j) d[j] = make_float2(sum[2 * j], sum[2 * j + 1]);
  } else if (!kDown) {      // b_parent = b_R - E^T b_J, in the next level's order
    float2* d = p.parent + dest * KP + k0;
#pragma unroll
    for (int j = 0; j < KB; ++j) d[j] = make_float2(pre[j].x - sum[2 * j], pre[j].y - sum[2 * j + 1]);
  } else {                  // x_J = g - E x_R, to the children
    float2* d = cg + dest * child_p;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (k0 + j < child_kw) {
        d[(k0 + j) * child_k] = make_float2(pre[j].x - sum[2 * j], pre[j].y - sum[2 * j + 1]);
      }
    }
  }
}

template <int KP, bool kDown>
size_t smem_bytes(int tc, int ni) {
  return sizeof(float2) * kStages * static_cast<size_t>(stage_values<KP, kDown>(tc, ni));
}

// Raises a kernel's dynamic shared memory limit to the device's opt-in
// maximum, once a device: the launches then ask for what they use.
template <int KP, bool kDown>
cudaError_t prepare() {
  static unsigned long long done = 0;   // a bit a device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hps_level<KP, kDown>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

template <int KP, bool kDown>
cudaError_t launch(const Level& p, cudaStream_t stream) {
  using S = Shape<KP>;
  const int R = kDown ? p.nJ : p.nJ + p.nR;
  const long long blocks = (static_cast<long long>(p.items) * R + S::RS - 1) / S::RS;
  if (static_cast<long long>(p.items) * R + S::RS > 0x7fffffffLL ||
      p.ni < min(p.items, (S::RS - 1) / R + 2)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare<KP, kDown>();
  if (err != cudaSuccess) return err;
  hps_level<KP, kDown><<<static_cast<unsigned>(blocks), kThreads, smem_bytes<KP, kDown>(p.tc, p.ni),
                         stream>>>(p);
  return cudaGetLastError();
}

template <int KP, bool kDown>
cudaError_t layout_of(int tc, int ni, int* out) {
  const size_t smem = smem_bytes<KP, kDown>(tc, ni);
  out[0] = static_cast<int>(smem);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, hps_level<KP, kDown>);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  err = prepare<KP, kDown>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], hps_level<KP, kDown>, kThreads, smem);
}

// Calls f.template operator()<KP, kDown>() for the instantiation that kp
// and down name, or returns cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int kp, bool down, F f) {
  switch (kp) {
    case 1: return down ? f.template operator()<1, true>() : f.template operator()<1, false>();
    case 4: return down ? f.template operator()<4, true>() : f.template operator()<4, false>();
    case 8: return down ? f.template operator()<8, true>() : f.template operator()<8, false>();
    case 16: return down ? f.template operator()<16, true>() : f.template operator()<16, false>();
    default: return cudaErrorInvalidValue;
  }
}

// The launch and the layout query of the instantiation dispatch() picks.
struct Launch {
  const Level& p;
  cudaStream_t s;
  template <int KP, bool kDown>
  cudaError_t operator()() const { return launch<KP, kDown>(p, s); }
};
struct Layout {
  int tc, ni;
  int* out;
  template <int KP, bool kDown>
  cudaError_t operator()() const { return layout_of<KP, kDown>(tc, ni, out); }
};

}  // namespace

extern "C" {

// One direction of one level (the leaf or a merge) on `stream`, a
// cudaStream_t of the current device, which holds every pointer, a CTA a
// block of rows. `items` is groups x P; Y and E hold an item's factors one
// after the other; y_t != 0: each item's Y is stored transposed. With a `table`, the child space is read (up) or
// written (down) at child + g child_g + point child_p + k child_k for the
// table's points and right-hand sides k < child_kw; up without one, the
// children are (items, nJ + nR, kp) in J-then-R order. Up, parent rows go
// to `out_map`'s places within a group (J-then-R order of the next level),
// or in order without one. `tc` (even) terms a chunk, `ni` the most items a
// block meets (the planner's). Returns the first CUDA error:
// cudaErrorInvalidValue for parameters the kernel does not take.
int fdfd_hps_level_run(int down, int kp, const void* Y, const void* E, const void* table,
                       const void* out_map, void* child, long long child_g, long long child_p,
                       long long child_k, int child_kw, void* parent, void* g, int y_t, int items,
                       int P, int nJ, int nR, int tc, int ni, void* stream) {
  const bool ordered = table == nullptr;   // up at a merge: children in J-then-R order
  if (items < 1 || P < 1 || items % P || nJ < 1 || nR < 1 || tc < 2 || tc % 2 || ni < 1 ||
      child_kw < 1 || child_kw > kp || (ordered && (down || child_kw != kp)) ||
      (down && out_map != nullptr) || E == nullptr || child == nullptr || parent == nullptr ||
      g == nullptr || (!down && Y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level p{static_cast<const float2*>(Y), static_cast<const float2*>(E),
                static_cast<const int*>(table),  static_cast<const int*>(out_map),
                static_cast<float2*>(child),     child_g, child_p, child_k,
                static_cast<float2*>(parent),    static_cast<float2*>(g),
                child_kw, y_t, items, P, nJ, nR, tc, ni};
  const cudaError_t err = dispatch(kp, down, Launch{p, static_cast<cudaStream_t>(stream)});
  if (err != cudaSuccess) cudaGetLastError();  // clear a launch error
  return static_cast<int>(err);
}

// The level kernel's layout for kp, tc and ni: out[0] the dynamic shared
// memory a CTA asks for, out[1] registers a thread, out[2] the CTAs an SM of
// the current device holds at once with that shared memory.
int fdfd_hps_level_layout(int down, int kp, int tc, int ni, int* out) {
  return static_cast<int>(dispatch(kp, down, Layout{tc, ni, out}));
}

}  // extern "C"

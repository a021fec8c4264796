// The row sweep: the two row recurrences of the stacked block-Thomas solve
// (fdtd2d_tpu_torch/fdfd/direct.py), one cooperative launch a direction.
//
// It replaces no TPU kernel. The JAX package runs these recurrences as
// lax.scan over the rows with no Pallas kernel (fdtd2d_tpu/fdfd/direct.py,
// _solve_rows); the port ran them as a host loop of three launches a row (a
// mul, a sub and a batched GEMM against the row's inverses), 3,066 launches
// an inner solve at 1024^2, where the host issuing them left the card idle
// two thirds of the time and cuBLAS's 32x32-tile GEMM read W at about a
// tenth of HBM's rate. With W_r = U_r^{-1} stored (G, nr, nc, nc) and K
// right-hand sides:
//
//   forward   z_0 = W_0 b_0,           z_r = W_r (b_r - n_r o z_{r-1})
//   backward  x_{nr-1} = z_{nr-1},     x_r = z_r - W_r (s_r o x_{r+1})
//
// What bounds it: one pass reads all of W once (4.29 GB at 1024^2, 4 x 512
// rows of 512 x 512 complex64), 1.28 ms at 3.35 TB/s; its 8 real FMAs a
// complex multiply-add of 16 right-hand sides take about as long on the
// CUDA cores (no TF32: the pivotless factor needs full float32). Between two
// rows lies the recurrence: every product of row r needs all of row r - 1's
// result, made by every CTA of the group. So W is streamed once while the
// products keep pace, and the dependence between rows is carried on the card:
//
// - A group is one leading index (a sublattice, times the scenes of a
//   scene-batched factor); the right-hand sides split into chunks of at most
//   16 (kc, padded to kp = 4, 8 or 16). A unit is a (group, chunk) pair;
//   units exchange nothing. The `ctas` CTAs of a unit each own a slab of
//   the nc output components, i.e. of the rows of every W_r, and stream
//   their slab of W_r through a two-stage ring in shared memory (cp.async,
//   `tr` rows a stage), one stage ahead: the next row's first tile is in
//   flight while the CTA computes, publishes and waits. The operands of a
//   tile's epilogue (b_{r+1} and n_{r+1} forward, z_r and s_{r-1} backward)
//   are copied in at its start, under the products.
// - The carried vector, v_r = b_r - n_r o z_{r-1} forward or u_r = s_r o
//   x_{r+1} backward (nc x kp complex), is whole in shared memory. The CTA
//   that computes a slab of z_r (x_r) writes it to the output, forms the
//   same slab of the next carried vector on the fly and writes it to a
//   small exchange buffer in global memory (it lives in L2), double-buffered
//   by the step's parity. Then it publishes the step's tag in its own 64-bit
//   slot (release), and before the next row every CTA of the unit polls
//   its peers' slots (acquire) and copies the whole next vector into shared
//   memory, in two halves so that the products of the first overlap the
//   copy of the second. The launch is cooperative, so the peers are
//   resident; a wait that never ends traps instead of hanging the card. Tags
//   count up across launches (the caller's `base`), so the slots are never
//   cleared.
// - The product of a tile: 256 threads; a thread owns a 4-row x 4-column
//   micro-tile of the tile's tr x kp outputs and a strided share of the nc
//   terms of its sums (S = 256 / micro-tiles, a multiple of 16). Per term it
//   reads 4 W values and 4 vector values from shared memory and makes 16
//   complex multiply-adds (64 FMAs). Sixteen lanes of a half-warp sum their
//   partials by shuffles, the half-warps of a micro-tile through 2 KB of
//   shared memory. The vector's rows are padded to kp + 2 complex values,
//   so the half-warp's 16-byte reads of 16 consecutive rows meet no bank
//   twice.
//
// Where the time goes on an H100 at 1024^2, K = 16 (33 CTAs a group, 132 in
// all; clock64 stamps of an instrumented copy): a row step takes about 7.5
// us, ~2.3 of them products; the rest is the exchange: the release waits
// ~1 us for the block's stores, the peers' tags arrive ~0.8 us later, and
// every CTA then pulls the 64 KB vector from L2, 8.4 MB a row step across
// the card beside W's 8.4 MB. Thread-block clusters would carry the vector
// in distributed shared memory instead, but an H100 holds 7 clusters of 16
// CTAs at once, and 4 groups need 8 (a second wave doubles the time).
//
// The outputs are written in place: the forward pass writes z into x, the
// backward pass reads z_r from x and overwrites it with x_r (a CTA touches
// only its own slab). Products are complex64 with float32 FMAs, as cuBLAS's
// cf32 GEMM makes them; only the order of summation differs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRed = kThreads;   // complex partial sums of the half-warps

struct Sweep {
  const float2* W;            // (G, nr, nc, nc): W_r = U_r^{-1}
  const float2* nv;           // (G, nr, nc): coupling to row r - 1
  const float2* sv;           // (G, nr, nc): coupling to row r + 1
  const float2* b;            // (G, K, nr, nc): the right-hand sides
  float2* x;                  // (G, K, nr, nc): z after the forward pass, x after the backward
  float2* exch;               // (units, 2, nc, kp): the next carried vector, by parity
  unsigned long long* tags;   // one slot a CTA of the launch
  unsigned long long base;    // tags of this launch are base + 1, base + 2, ...
  int nr, nc, K, kc, chunks, ctas, tr, unit0;
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

// Thread 0, after a block barrier that follows the step's writes: the
// release orders every write of the block before the barrier ahead of the tag.
__device__ __forceinline__ void arrive(unsigned long long* slot, unsigned long long tag) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(slot), "l"(tag) : "memory");
}

// Every thread: returns once each of the unit's `ctas` slots holds `tag` or later.
__device__ __forceinline__ void await_unit(const unsigned long long* slots, int ctas,
                                           unsigned long long tag) {
  if (static_cast<int>(threadIdx.x) < ctas) {
    const unsigned long long* slot = slots + threadIdx.x;
    for (int spin = 0;; ++spin) {
      unsigned long long v;
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(slot) : "memory");
      if (v >= tag) break;
      if (spin > (1 << 24)) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One level of the half-warp transpose-reduce: the lanes that differ in bit
// kHalf / 2 swap halves of acc[0, 2 kHalf), so that each keeps the sum of
// one half.
template <int kHalf>
__device__ __forceinline__ void fold(float (&acc)[32]) {
  const bool up = threadIdx.x & (kHalf / 2);
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const float send = up ? acc[m] : acc[m + kHalf];
    const float keep = up ? acc[m + kHalf] : acc[m];
    acc[m] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf / 2);
  }
}

// 32 floats a lane in; out, in acc[0] and acc[1] of lane l, the sums over
// the 16 lanes of its half-warp of floats 2 (l % 16) and 2 (l % 16) + 1.
__device__ __forceinline__ void halfwarp_reduce(float (&acc)[32]) {
  fold<16>(acc);
  fold<8>(acc);
  fold<4>(acc);
  fold<2>(acc);
}

// One term of a thread's sums: W[4 rows][c] times v[c][4 columns], 16 complex
// multiply-adds into acc (complex j = 4 row + column at acc[2 j], acc[2 j + 1]).
template <int VS>
__device__ __forceinline__ void mac(float (&acc)[32], const float2* w0, const float2* vcol, int nc,
                                    int c) {
  const float4 va = *reinterpret_cast<const float4*>(vcol + c * VS);
  const float4 vb = *reinterpret_cast<const float4*>(vcol + c * VS + 2);
  const float2 v[4] = {make_float2(va.x, va.y), make_float2(va.z, va.w), make_float2(vb.x, vb.y),
                       make_float2(vb.z, vb.w)};
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float2 w = w0[ii * nc + c];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float& re = acc[2 * (ii * 4 + kk)];
      float& im = acc[2 * (ii * 4 + kk) + 1];
      re = fmaf(w.x, v[kk].x, re);
      re = fmaf(-w.y, v[kk].y, re);
      im = fmaf(w.x, v[kk].y, im);
      im = fmaf(w.y, v[kk].x, im);
    }
  }
}

template <int KP, bool kBack>
__global__ void __launch_bounds__(kThreads, 1) row_sweep(const Sweep p) {
  constexpr int VS = KP + 2;   // complex values a row of the carried vector in shared memory
  constexpr int KB = KP / 4;   // micro-tile columns
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nr = p.nr, nc = p.nc, tr = p.tr, K = p.K;
  const float2* const W = p.W;
  const int local = blockIdx.x / p.ctas, cta = blockIdx.x % p.ctas;
  const int unit = p.unit0 + local;
  const int g = unit / p.chunks;
  const int k0 = (unit % p.chunks) * p.kc;
  const int kn = min(p.kc, p.K - k0);
  const int lo = static_cast<int>(static_cast<long long>(cta) * nc / p.ctas);
  const int hi = static_cast<int>(static_cast<long long>(cta + 1) * nc / p.ctas);
  const int ntiles = (hi - lo + tr - 1) / tr;
  const int steps = kBack ? nr - 1 : nr;
  const bool wide = !(nc & 1) && !(reinterpret_cast<uintptr_t>(W) & 15);

  float2* Wsm = reinterpret_cast<float2*>(smem);                  // 2 stages of tr x nc
  float2* Vsm = Wsm + 2 * static_cast<size_t>(tr) * nc;           // nc x VS
  float2* red = Vsm + static_cast<size_t>(nc) * VS;               // kRed
  float2* pre = red + kRed;                                       // 2 x tr x KP
  const int half = nc / 2;   // the carried vector arrives as rows [0, half), then the rest

  // the lambdas capture locals only: no reference to the parameter struct
  auto row_of = [=](int s) { return kBack ? nr - 2 - s : s; };
  auto at = [=](int k, int r, int c) {   // (g, k0 + k, r, c) in (G, K, nr, nc)
    return ((static_cast<size_t>(g) * K + k0 + k) * nr + r) * nc + c;
  };
  auto issue = [=](int s, int t, int stage) {   // a ring tile of W_{row_of(s)}
    const int row0 = lo + t * tr;
    const int n = min(tr, hi - row0) * nc;
    const float2* src = W + (static_cast<size_t>(g) * nr + row_of(s)) * nc * nc +
                        static_cast<size_t>(row0) * nc;
    float2* dst = Wsm + static_cast<size_t>(stage) * tr * nc;
    if (wide) {
      for (int e = tid; e < n / 2; e += kThreads) cp_async16(dst + 2 * e, src + 2 * e);
    } else {
      for (int e = tid; e < n; e += kThreads) cp_async8(dst + e, src + e);
    }
  };

  issue(0, 0, 0);
  cp_commit();
  {  // the first carried vector: b_0 forward, s_{nr-2} o z_{nr-1} backward
    const int r0 = row_of(0);
    for (int e = tid; e < nc * KP; e += kThreads) {
      const int c = e % nc, k = e / nc;
      float2 v = make_float2(0.f, 0.f);
      if (k < kn) {
        v = kBack ? cmul(p.sv[(static_cast<size_t>(g) * nr + r0) * nc + c], p.x[at(k, nr - 1, c)])
                  : p.b[at(k, r0, c)];
      }
      Vsm[c * VS + k] = v;
    }
  }

  const int T = (tr / 4) * KB;   // micro-tiles of a tile
  const int S = kThreads / T;    // threads sharing a micro-tile's sums, a multiple of 16
  const int mt = tid / S, sp = tid % S;
  const int ib = mt / KB, kb = mt % KB;
  const int ei = tid % tr, ek = tid / tr;   // the thread's output in the epilogue
  int q = 0;                     // tiles so far: the ring's stage is q & 1
  for (int s = 0; s < steps; ++s) {
    const int r = row_of(s);
    const bool more = s + 1 < steps;
    if (s > 0) {  // the carried vector from the exchange, in two groups
      await_unit(p.tags + static_cast<size_t>(local) * p.ctas, p.ctas, p.base + s);
      const float2* src = p.exch + (static_cast<size_t>(local) * 2 + (s & 1)) * nc * KP;
      auto fetch = [=](int e) {   // 16 bytes: row e / (KP / 2), part e % (KP / 2)
        const int c = e / (KP / 2), part = e % (KP / 2);
        cp_async16(Vsm + c * VS + 2 * part, src + c * KP + 2 * part);
      };
      for (int e = tid; e < half * (KP / 2); e += kThreads) fetch(e);
      cp_commit();
      for (int e = half * (KP / 2) + tid; e < nc * (KP / 2); e += kThreads) fetch(e);
      cp_commit();
    }
    for (int t = 0; t < ntiles; ++t, ++q) {
      const bool split = s > 0 && t == 0;   // the vector's second half may be in flight
      if (split) {
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      // this tile's epilogue operands, each thread its own, into `pre`
      const int c_out = lo + t * tr + ei;
      const bool mine = tid < tr * KP && c_out < hi && ek < kn;
      const size_t o = at(ek, r, c_out);
      if (mine && (kBack || more)) {
        if (kBack) {
          cp_async8(pre + tid, p.x + o);
          if (more) {
            cp_async8(pre + tr * KP + tid, p.sv + (static_cast<size_t>(g) * nr + r - 1) * nc + c_out);
          }
        } else {
          cp_async8(pre + tid, p.b + o + nc);   // row r + 1
          cp_async8(pre + tr * KP + tid,
                    p.nv + (static_cast<size_t>(g) * nr + r + 1) * nc + c_out);
        }
      }
      cp_commit();
      if (t + 1 < ntiles) {
        issue(s, t + 1, (q + 1) & 1);
      } else if (more) {
        issue(s + 1, 0, (q + 1) & 1);
      }
      cp_commit();

      const float2* w0 = Wsm + (static_cast<size_t>(q & 1) * tr + ib * 4) * nc;
      const float2* vcol = Vsm + kb * 4;
      float acc[32];
#pragma unroll
      for (int m = 0; m < 32; ++m) acc[m] = 0.f;
      int c = sp;
      if (split) {
#pragma unroll 4
        for (; c < half; c += S) mac<VS>(acc, w0, vcol, nc, c);
        cp_wait<2>();
        __syncthreads();
      }
#pragma unroll 4
      for (; c < nc; c += S) mac<VS>(acc, w0, vcol, nc, c);
      halfwarp_reduce(acc);
      red[((sp / 16) * T + mt) * 16 + (tid & 15)] = make_float2(acc[0], acc[1]);
      cp_wait<1>();   // this thread's operands
      __syncthreads();

      // epilogue: thread (i, k) of the tile's tr x kp outputs, i fastest
      if (tid < tr * KP && c_out < hi) {
        const int home = (ei / 4) * KB + ek / 4, j = (ei % 4) * 4 + ek % 4;
        float2 y = make_float2(0.f, 0.f);
        for (int h = 0; h < S / 16; ++h) {
          const float2 a = red[(h * T + home) * 16 + j];
          y.x += a.x;
          y.y += a.y;
        }
        float2 next = make_float2(0.f, 0.f);
        if (ek < kn) {
          float2 out = y;
          if (kBack) {
            const float2 z = pre[tid];
            out = make_float2(z.x - y.x, z.y - y.y);
          }
          p.x[o] = out;
          if (more) {
            next = cmul(pre[tr * KP + tid], out);   // s_{r-1} o x_r backward
            if (!kBack) {                           // b_{r+1} - n_{r+1} o z_r forward
              const float2 bb = pre[tid];
              next = make_float2(bb.x - next.x, bb.y - next.y);
            }
          }
        }
        if (more) {
          p.exch[((static_cast<size_t>(local) * 2 + ((s + 1) & 1)) * nc + c_out) * KP + ek] = next;
        }
      }
    }
    if (more) {
      __syncthreads();
      if (tid == 0) arrive(p.tags + blockIdx.x, p.base + s + 1);
    }
  }
}

size_t smem_bytes(int nc, int kp, int tr) {
  return sizeof(float2) *
         (2 * static_cast<size_t>(tr) * nc + static_cast<size_t>(nc) * (kp + 2) + kRed + 2 * tr * kp);
}

template <int KP, bool kBack>
cudaError_t launch(const Sweep& p, int grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.nc, KP, p.tr);
  auto kernel = row_sweep<KP, kBack>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Sweep arg = p;
  void* args[] = {&arg};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(kThreads), args, smem, stream);
}

template <bool kBack>
cudaError_t launch_kp(const Sweep& p, int kp, int grid, cudaStream_t stream) {
  switch (kp) {
    case 4: return launch<4, kBack>(p, grid, stream);
    case 8: return launch<8, kBack>(p, grid, stream);
    case 16: return launch<16, kBack>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int KP>
cudaError_t layout_of(int nc, int tr, int* out) {
  const size_t smem = smem_bytes(nc, KP, tr);
  out[0] = static_cast<int>(smem);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, row_sweep<KP, false>);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  err = cudaFuncSetAttribute(row_sweep<KP, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], row_sweep<KP, false>, kThreads,
                                                       smem);
}

}  // namespace

extern "C" {

// One direction of the row sweep on `stream` (a cudaStream_t of the current
// device, which holds every pointer), as one cooperative launch of
// units x ctas CTAs: units unit0 .. unit0 + units - 1, unit u being group
// u / chunks and right-hand sides [(u % chunks) kc, ...). `exch` holds
// units x 2 x nc x kp complex values of scratch, `tags` units x ctas 64-bit
// slots, each below base + 1. The forward pass reads b and writes z into x;
// the backward pass (backward != 0, nr >= 2) turns z in x into the solution.
// Returns the first CUDA error: cudaErrorInvalidValue for parameters the
// kernel does not take, the runtime's error when it refuses the launch
// (more CTAs than can be resident at once).
int fdfd_rowsweep_run(const void* W, const void* nv, const void* sv, const void* b, void* x,
                      void* exch, void* tags, unsigned long long base, int backward, int units,
                      int unit0, int ctas, int nr, int nc, int K, int kc, int chunks, int kp,
                      int tr, void* stream) {
  const bool tr_ok = tr == 4 || tr == 8 || tr == 16 || tr == 32 || tr == 64;
  if (!tr_ok || tr * kp > kThreads || kc < 1 || kc > kp || static_cast<long long>(kc) * chunks < K ||
      units < 1 || unit0 < 0 || ctas < 1 || ctas > nc || nr < (backward ? 2 : 1) || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Sweep p{static_cast<const float2*>(W),  static_cast<const float2*>(nv),
                static_cast<const float2*>(sv), static_cast<const float2*>(b),
                static_cast<float2*>(x),        static_cast<float2*>(exch),
                static_cast<unsigned long long*>(tags), base, nr, nc, K, kc, chunks, ctas, tr,
                unit0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = backward ? launch_kp<true>(p, kp, units * ctas, s)
                                   : launch_kp<false>(p, kp, units * ctas, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's layout for kp and a ring of tr rows of nc: out[0] the dynamic
// shared memory a CTA asks for, out[1] registers a thread, out[2] the CTAs
// an SM of the current device holds at once with that shared memory.
int fdfd_rowsweep_layout(int kp, int nc, int tr, int* out) {
  switch (kp) {
    case 4: return static_cast<int>(layout_of<4>(nc, tr, out));
    case 8: return static_cast<int>(layout_of<8>(nc, tr, out));
    case 16: return static_cast<int>(layout_of<16>(nc, tr, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

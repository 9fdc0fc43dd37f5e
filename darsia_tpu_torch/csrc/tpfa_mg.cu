// The multigrid-preconditioned CG trip of the 2D TPFA pressure solve, for a
// batch of B problems on (h, w) cell grids (float32, row-major, W fastest).
//
// Replaces no Pallas kernel: the JAX package runs `tpfa_mg_pcg`
// (darsia_tpu/measure/beckmann_kernels.py) as XLA array code.  Added because
// the port's tensor form of one CG trip streamed ~224 full-field passes
// through device memory (strided views of the residual, the pair sums of the
// restriction, one launch per term): at B = 1024 on 120 x 280 cells a field is
// 137.6 MB, 2.75x the L2, so every pass goes to HBM.  Every kernel here is
// bound by device memory (3.35 TB/s); the design moves ~23 fine-field passes a
// trip at the finest level and ~26 over all levels:
//
// * `tpfa_apply_kernel`: A p and <p, A p> per pair (reads p, t0, t1; writes
//   A p: 4 passes).
// * `cg_update_kernel`: x <- (x - mean) + alpha p, r <- r - alpha A p into the
//   other buffer of a pair (reads 4, writes 2: 6 passes), with sum x, |x|^2 and
//   |r|^2 per pair.  The projection of x is applied lazily: its mean is
//   subtracted when x is next read.
// * `mg_pre_kernel`: one level's pre-smoothing (nu damped Jacobi sweeps from
//   zero), residual and 2x2 aggregate restriction in one pass: a tile plus a
//   halo of nu cells in shared memory, the Jacobi step omega / diag formed from
//   the faces there.  Reads b, t0, t1; writes the smoothed x and a quarter
//   field: 4.25 passes.
// * `mg_post_kernel`: adds the prolonged coarse correction to that x and runs
//   the nu post-sweeps (halo nu), writing the level's output; at the finest
//   level also sum z, <r, z> and sum r per pair for the projected
//   preconditioned residual.  Reads b, x, t0, t1 and a quarter field; writes
//   one: 5.25 passes.
// * `cg_direction_kernel`: p <- (z - mean z) + beta p (3 passes).
// * `cg_finalize_kernel`: per pair, the trip's scalars and the stopping rule.
// * `mg_coarse_matrix_kernel`, once per solve: the coarsest level's sweeps as
//   a float64 matrix, a block per unit vector and pair, in shared memory (the
//   tensor form takes ~400 launches on tiny arrays).
//
// The two stencil kernels run 32 x 8 threads, a warp along each row of the
// tile, so that every stage is a pair of loops with no index division.
// A pair whose `active` flag is 0 returns at once and its state stays as it
// is.  Per-pair sums are deterministic: each block writes its partial sum
// into a (B, blocks) buffer, and the consumer sums those in a fixed order, so
// a run repeats bit for bit (no atomics).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileX = 32, kTileY = kThreads / kTileX;  // the stencil kernels' block
// Stencil blocks resident per SM: registers capped at 40 a thread, and tiles
// of at most 1536 cells with their halo (37 KB of shared memory).
constexpr int kStencilBlocks = 6;

__device__ __forceinline__ int thread_rank() { return threadIdx.y * blockDim.x + threadIdx.x; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the warp's sum
}

// The block's sums of v[0..K) (each thread's share), written as doubles to
// out[0..K) by thread 0 in a fixed order.
template <int K>
__device__ void block_sums(const float (&v)[K], double* out) {
  __shared__ float red[K][kWarps];
  const int lane = thread_rank() & 31, warp = thread_rank() >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = warp_sum(lane < kWarps ? red[k][lane] : 0.f);
      if (lane == 0) out[k] = (double)s;
    }
  }
}

// Sum of part[0], part[stride], ... (count entries) by the calling warp, in a
// fixed order; valid on lane 0.
__device__ double pair_total(const double* part, int count, int stride) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int i = lane; i < count; i += 32) s += part[(long long)i * stride];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// Offset of pair b's field in a (2, B, n) double buffer (buffer sel[b] ^ flip)
// or, with sel null, in a (B, n) field.
__device__ __forceinline__ long long field_offset(const int* sel, int flip, int b, int B,
                                                  long long n) {
  const long long buf = sel ? (long long)(sel[b] ^ flip) : 0LL;
  return (buf * B + b) * n;
}

__device__ __forceinline__ bool inside(int i, int j, int h, int w) {
  return i >= 0 && i < h && j >= 0 && j < w;
}

// One float from global to shared memory without waiting (cp.async), or a
// zero where `valid` is false (nothing is read then).  A thread issues all
// of its tile's loads before it waits, so that enough bytes are in flight to
// cover the device memory's latency.
__device__ __forceinline__ void load_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// ---------------------------------------------------------------- A p

__global__ void __launch_bounds__(kThreads)
tpfa_apply_kernel(const float* __restrict__ p, const float* __restrict__ t0,
                  const float* __restrict__ t1, int tshared, const unsigned char* __restrict__ active,
                  float* __restrict__ ap, double* __restrict__ part, int h, int w) {
  const int b = blockIdx.y;
  if (!active[b]) return;
  const int n = h * w;
  const float* x = p + (long long)b * n;
  const float* a0 = t0 + (tshared ? 0LL : (long long)b * (h - 1) * w);
  const float* a1 = t1 + (tshared ? 0LL : (long long)b * h * (w - 1));
  float* out = ap + (long long)b * n;
  float acc[1] = {0.f};
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n; idx += gridDim.x * kThreads) {
    const int i = idx / w, j = idx - i * w;
    const float xc = x[idx];
    // tpfa_apply's order: per axis the face after the cell, then the face before.
    float r = 0.f;
    if (i < h - 1) r += a0[idx] * (xc - x[idx + w]);
    if (i > 0) r += a0[idx - w] * (xc - x[idx - w]);
    if (j < w - 1) r += a1[i * (w - 1) + j] * (xc - x[idx + 1]);
    if (j > 0) r += a1[i * (w - 1) + j - 1] * (xc - x[idx - 1]);
    out[idx] = r;
    acc[0] += xc * r;
  }
  block_sums<1>(acc, part + (long long)b * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------- x, r update

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(float* X, float* R, const int* __restrict__ sel, const float* __restrict__ P,
                 const float* __restrict__ AP, const double* __restrict__ part_pap, int nblk_pap,
                 const float* __restrict__ rz, const float* __restrict__ mx,
                 const unsigned char* __restrict__ active, double* __restrict__ part, int B, int n) {
  const int b = blockIdx.y;
  if (!active[b]) return;
  __shared__ float s_alpha;
  if (threadIdx.x < 32) {
    const double pap = pair_total(part_pap + (long long)b * nblk_pap, nblk_pap, 1);
    if (threadIdx.x == 0) {
      const float d = (float)pap;
      s_alpha = rz[b] / (d < 1e-30f ? 1e-30f : d);  // clamp(min=1e-30) keeps a NaN
    }
  }
  __syncthreads();
  const float alpha = s_alpha, m = mx[b];
  const long long src = field_offset(sel, 0, b, B, n), dst = field_offset(sel, 1, b, B, n);
  const long long off = (long long)b * n;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n; idx += gridDim.x * kThreads) {
    const float xn = (X[src + idx] - m) + alpha * P[off + idx];
    const float rn = R[src + idx] - alpha * AP[off + idx];
    X[dst + idx] = xn;
    R[dst + idx] = rn;
    acc[0] += xn;
    acc[1] += xn * xn;
    acc[2] += rn * rn;
  }
  block_sums<3>(acc, part + ((long long)b * gridDim.x + blockIdx.x) * 3);
}

// ---------------------------------------------------------------- V-cycle levels

// A tile of TH x TW cells (TH, TW even, so it holds whole 2x2 aggregates) and a
// halo, in shared memory: the right-hand side, the Jacobi step, two iterate
// buffers, and the faces: T0s row k is the face between region rows k - 1 and
// k, T1s column k the face between region columns k - 1 and k.  Cells and
// faces outside the grid read 0 (a zero step keeps such cells at 0).
struct Region {
  int h, w, i0, j0, halo, RH, RW;
  float *T0s, *T1s, *S, *Bs, *X0, *X1;
};

__device__ Region make_region(float* smem, int h, int w, int TH, int TW, int tiles_w, int halo) {
  Region g;
  g.h = h;
  g.w = w;
  g.i0 = (blockIdx.x / tiles_w) * TH;
  g.j0 = (blockIdx.x % tiles_w) * TW;
  g.halo = halo;
  g.RH = TH + 2 * halo;
  g.RW = TW + 2 * halo;
  const int cells = g.RH * g.RW;
  g.T0s = smem;
  g.T1s = g.T0s + (g.RH + 1) * g.RW;
  g.S = g.T1s + g.RH * (g.RW + 1);
  g.Bs = g.S + cells;
  g.X0 = g.Bs + cells;
  g.X1 = g.X0 + cells;
  return g;
}

// Loads b (and x into X0, where given) on the region and the faces, without
// waiting; `wait_region` waits for them and forms the Jacobi step.
__device__ void load_region(const Region& g, const float* b, const float* x, const float* a0,
                            const float* a1) {
  const int gi0 = g.i0 - g.halo, gj0 = g.j0 - g.halo, RH = g.RH, RW = g.RW, h = g.h, w = g.w;
  const int ty = threadIdx.y, tx = threadIdx.x;
  for (int li = ty; li < RH; li += kTileY)
    for (int lj = tx; lj < RW; lj += kTileX) {
      const int gi = gi0 + li, gj = gj0 + lj, q = li * RW + lj;
      const bool in = inside(gi, gj, h, w);
      const int o = in ? gi * w + gj : 0;
      load_async(&g.Bs[q], b + o, in);
      if (x) load_async(&g.X0[q], x + o, in);
    }
  for (int k = ty; k <= RH; k += kTileY)
    for (int lj = tx; lj < RW; lj += kTileX) {
      const int f = gi0 - 1 + k, gj = gj0 + lj;
      const bool in = f >= 0 && f < h - 1 && gj >= 0 && gj < w;
      load_async(&g.T0s[k * RW + lj], a0 + (in ? f * w + gj : 0), in);
    }
  for (int li = ty; li < RH; li += kTileY)
    for (int k = tx; k <= RW; k += kTileX) {
      const int gi = gi0 + li, f = gj0 - 1 + k;
      const bool in = gi >= 0 && gi < h && f >= 0 && f < w - 1;
      load_async(&g.T1s[li * (RW + 1) + k], a1 + (in ? gi * (w - 1) + f : 0), in);
    }
}

__device__ void wait_region(const Region& g, float omega) {
  const int gi0 = g.i0 - g.halo, gj0 = g.j0 - g.halo, RH = g.RH, RW = g.RW, h = g.h, w = g.w;
  const int ty = threadIdx.y, tx = threadIdx.x;
  wait_async();
  __syncthreads();
  for (int li = ty; li < RH; li += kTileY)
    for (int lj = tx; lj < RW; lj += kTileX) {
      const int q = li * RW + lj, f = li * (RW + 1) + lj;
      // _tpfa_diag's sum: (after + before) along axis 0, then along axis 1.
      float d = (g.T0s[q + RW] + g.T0s[q]) + (g.T1s[f + 1] + g.T1s[f]);
      d = d < 1e-30f ? 1e-30f : d;
      g.S[q] = inside(gi0 + li, gj0 + lj, h, w) ? (1.0f / d) * omega : 0.f;
    }
  __syncthreads();
}

// b - A x at region cell q = (li, lj), in _tpfa_residual's order.
__device__ __forceinline__ float tile_residual(const Region& g, const float* x, int q, int li,
                                               int lj) {
  const int RW = g.RW, f = li * (RW + 1) + lj;
  const float xc = x[q];
  float r = g.Bs[q];
  r = fmaf(-g.T0s[q + RW], xc - x[q + RW], r);
  r = fmaf(g.T0s[q], x[q - RW] - xc, r);
  r = fmaf(-g.T1s[f + 1], xc - x[q + 1], r);
  r = fmaf(g.T1s[f], x[q - 1] - xc, r);
  return r;
}

// `count` damped Jacobi sweeps x <- x + step (b - A x), sweep k over the cells
// at least `margin + k` from the region's edge (what the stencil leaves
// valid); from zero, the first sweep is b * step.  `cur` names the buffer
// holding x (0: X0, 1: X1); returns the one holding the result.
__device__ int tile_sweeps(const Region& g, int cur, int margin, int count, bool from_zero) {
  for (int k = 0; k < count; ++k) {
    const int m = margin + k;
    const float* x = cur ? g.X1 : g.X0;
    float* y = cur ? g.X0 : g.X1;
    for (int li = m + threadIdx.y; li < g.RH - m; li += kTileY)
      for (int lj = m + threadIdx.x; lj < g.RW - m; lj += kTileX) {
        const int q = li * g.RW + lj;
        y[q] = (from_zero && k == 0) ? g.Bs[q] * g.S[q]
                                     : fmaf(g.S[q], tile_residual(g, x, q, li, lj), x[q]);
      }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

__device__ int tile_zero(const Region& g) {
  for (int q = thread_rank(); q < g.RH * g.RW; q += kThreads) g.X0[q] = 0.f;
  __syncthreads();
  return 0;
}

__device__ __forceinline__ const float* pair_faces(const float* t, int tshared, int pair,
                                                   long long size) {
  return t + (tshared ? 0LL : (long long)pair * size);
}

// Pre-smoothing, residual and restriction: x_nu = nu sweeps from zero, written
// to xs (B, h, w); rc = R (b - A x_nu), (B, ceil(h/2), ceil(w/2)), float64
// when rc_double (the input of the coarsest level's float64 matrix).  Halo
// max(nu, 1).
__global__ void __launch_bounds__(kThreads, kStencilBlocks)
mg_pre_kernel(const float* __restrict__ b, const int* __restrict__ bsel, int bflip,
              const float* __restrict__ t0, const float* __restrict__ t1, int tshared,
              const unsigned char* __restrict__ active, float* __restrict__ xs, void* rc,
              int rc_double, int B, int h, int w, int TH, int TW, int tiles_w, int nu,
              float omega) {
  const int pair = blockIdx.y;
  if (!active[pair]) return;
  extern __shared__ float smem[];
  const Region g = make_region(smem, h, w, TH, TW, tiles_w, nu > 1 ? nu : 1);
  const long long n = (long long)h * w;
  load_region(g, b + field_offset(bsel, bflip, pair, B, n), nullptr,
              pair_faces(t0, tshared, pair, (long long)(h - 1) * w),
              pair_faces(t1, tshared, pair, (long long)h * (w - 1)));
  wait_region(g, omega);
  const int cur = nu == 0 ? tile_zero(g) : tile_sweeps(g, 0, 0, nu, true);
  const float* x = cur ? g.X1 : g.X0;
  const int RW = g.RW, halo = g.halo;
  float* xo = xs + (long long)pair * n;
  for (int ti = threadIdx.y; ti < TH; ti += kTileY)
    for (int tj = threadIdx.x; tj < TW; tj += kTileX) {
      const int gi = g.i0 + ti, gj = g.j0 + tj;
      if (inside(gi, gj, h, w)) xo[gi * w + gj] = x[(halo + ti) * RW + halo + tj];
    }
  const int hc = (h + 1) / 2, wc = (w + 1) / 2;
  const long long base = (long long)pair * hc * wc;
  for (int ci = threadIdx.y; ci < TH / 2; ci += kTileY)
    for (int cj = threadIdx.x; cj < TW / 2; cj += kTileX) {
      const int ic = g.i0 / 2 + ci, jc = g.j0 / 2 + cj;
      if (ic >= hc || jc >= wc) continue;
      const int li = halo + 2 * ci, lj = halo + 2 * cj, q = li * RW + lj;
      // _restrict_cells' order: pairs along axis 0, then along axis 1.
      const float v = (tile_residual(g, x, q, li, lj) + tile_residual(g, x, q + RW, li + 1, lj)) +
                      (tile_residual(g, x, q + 1, li, lj + 1) +
                       tile_residual(g, x, q + RW + 1, li + 1, lj + 1));
      const long long o = base + (long long)ic * wc + jc;
      if (rc_double)
        static_cast<double*>(rc)[o] = (double)v;
      else
        static_cast<float*>(rc)[o] = v;
    }
}

// Post-smoothing: out = nu sweeps from xs + P e_c (xs: the pre pass's x_nu),
// on a halo of nu cells; e_c is float64 when ec_double.  With `part`, each
// block adds (sum out, sum b out, sum b) over its tile.
__global__ void __launch_bounds__(kThreads, kStencilBlocks)
mg_post_kernel(const float* __restrict__ b, const int* __restrict__ bsel, int bflip,
               const float* __restrict__ t0, const float* __restrict__ t1, int tshared,
               const unsigned char* __restrict__ active, const float* __restrict__ xs,
               const void* ec, int ec_double, float* __restrict__ out, double* __restrict__ part,
               int B, int h, int w, int TH, int TW, int tiles_w, int nu, float omega) {
  const int pair = blockIdx.y;
  if (!active[pair]) return;
  extern __shared__ float smem[];
  const Region g = make_region(smem, h, w, TH, TW, tiles_w, nu);
  const long long n = (long long)h * w;
  load_region(g, b + field_offset(bsel, bflip, pair, B, n), xs + (long long)pair * n,
              pair_faces(t0, tshared, pair, (long long)(h - 1) * w),
              pair_faces(t1, tshared, pair, (long long)h * (w - 1)));
  {
    // The coarse cells under the region, staged in X1 (free until the
    // sweeps): rows ci0.., columns cj0.. (floor halves; the halo may start
    // above or left of the grid).
    const int gi0 = g.i0 - g.halo, gj0 = g.j0 - g.halo, hc = (h + 1) / 2, wc = (w + 1) / 2;
    const int ci0 = gi0 >> 1, cj0 = gj0 >> 1;
    const int CRH = ((gi0 + g.RH - 1) >> 1) - ci0 + 1, CRW = ((gj0 + g.RW - 1) >> 1) - cj0 + 1;
    const long long base = (long long)pair * hc * wc;
    for (int cr = threadIdx.y; cr < CRH; cr += kTileY)
      for (int cc = threadIdx.x; cc < CRW; cc += kTileX) {
        const int ic = ci0 + cr, jc = cj0 + cc;
        const bool in = ic >= 0 && ic < hc && jc >= 0 && jc < wc;
        const long long o = base + (in ? (long long)ic * wc + jc : 0LL);
        if (ec_double)
          g.X1[cr * CRW + cc] = in ? (float)static_cast<const double*>(ec)[o] : 0.f;
        else
          load_async(&g.X1[cr * CRW + cc], static_cast<const float*>(ec) + o, in);
      }
    wait_region(g, omega);
    for (int li = threadIdx.y; li < g.RH; li += kTileY)
      for (int lj = threadIdx.x; lj < g.RW; lj += kTileX) {
        const int gi = gi0 + li, gj = gj0 + lj;
        if (!inside(gi, gj, h, w)) continue;
        const int q = li * g.RW + lj;
        g.X0[q] = g.X0[q] + g.X1[((gi >> 1) - ci0) * CRW + (gj >> 1) - cj0];
      }
    __syncthreads();
  }
  const int cur = tile_sweeps(g, 0, 1, nu, false);
  const float* x = cur ? g.X1 : g.X0;
  float* o = out + (long long)pair * n;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int ti = threadIdx.y; ti < TH; ti += kTileY)
    for (int tj = threadIdx.x; tj < TW; tj += kTileX) {
      const int gi = g.i0 + ti, gj = g.j0 + tj;
      if (!inside(gi, gj, h, w)) continue;
      const int q = (g.halo + ti) * g.RW + g.halo + tj;
      const float z = x[q];
      o[gi * w + gj] = z;
      acc[0] += z;
      acc[1] += g.Bs[q] * z;
      acc[2] += g.Bs[q];
    }
  if (part) block_sums<3>(acc, part + ((long long)pair * gridDim.x + blockIdx.x) * 3);
}

// ---------------------------------------------------------------- direction

// The projected z and its <r, z> from the V-cycle's sums: mean z, and
// <r, z - mean z> = <r, z> - mean z * sum r.
__device__ void vcycle_scalars(const double* pv, int nblk_v, int n, float* zbar, float* rzn) {
  const double sz = pair_total(pv, nblk_v, 3), srz = pair_total(pv + 1, nblk_v, 3),
               sr = pair_total(pv + 2, nblk_v, 3);
  *zbar = (float)(sz / n);
  *rzn = (float)(srz - (double)*zbar * sr);
}

__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(const float* __restrict__ Z, float* __restrict__ P,
                    const double* __restrict__ part_v, int nblk_v, const float* __restrict__ rz,
                    float* __restrict__ rz_next, const unsigned char* __restrict__ active, int n) {
  const int b = blockIdx.y;
  if (!active[b]) return;
  __shared__ float s_zbar, s_beta;
  if (threadIdx.x < 32) {
    float zbar, rzn;
    vcycle_scalars(part_v + (long long)b * nblk_v * 3, nblk_v, n, &zbar, &rzn);
    if (threadIdx.x == 0) {
      s_zbar = zbar;
      s_beta = rzn / rz[b];
      if (blockIdx.x == 0) rz_next[b] = rzn;
    }
  }
  __syncthreads();
  const float zbar = s_zbar, beta = s_beta;
  const long long off = (long long)b * n;
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n; idx += gridDim.x * kThreads)
    P[off + idx] = (Z[off + idx] - zbar) + beta * P[off + idx];
}

// ---------------------------------------------------------------- the trip's end

// Per active pair: an update whose x is not finite is rejected (x and r keep
// their buffer); rz takes the new value; the stopping rule of _pcg (|r| above
// the threshold, rz finite and |rz| > 1e-28) leaves the pair active or not.
__global__ void cg_finalize_kernel(int* __restrict__ sel, float* __restrict__ mx,
                                   float* __restrict__ rn, float* __restrict__ rz,
                                   const float* __restrict__ rz_next,
                                   const float* __restrict__ thr, unsigned char* __restrict__ active,
                                   const double* __restrict__ part_u, int nblk_u, int n, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || !active[b]) return;
  const double* pu = part_u + (long long)b * nblk_u * 3;
  double s[3] = {0.0, 0.0, 0.0};
  for (int i = 0; i < nblk_u; ++i)
    for (int k = 0; k < 3; ++k) s[k] += pu[i * 3 + k];
  if (isfinite((float)s[1])) {
    sel[b] ^= 1;
    mx[b] = (float)(s[0] / n);
    rn[b] = (float)sqrt(s[2]);
  }
  const float r = rz_next[b];
  rz[b] = r;
  active[b] = (rn[b] > thr[b]) && isfinite(r) && fabsf(r) > 1e-28f;
}

// ---------------------------------------------------------------- coarsest level

// Row i of pair b's matrix of the coarsest level: `sweeps` damped Jacobi
// sweeps from zero on the unit vector e_i, in float64 (tpfa_mg_hierarchy's
// tensor form, term for term).  Block (i, b), one thread per cell or more.
__global__ void mg_coarse_matrix_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                                        int tshared, double* __restrict__ out, int h, int w,
                                        int sweeps, double omega) {
  extern __shared__ double dsm[];
  const int n = h * w, i = blockIdx.x, b = blockIdx.y;
  double* T0 = dsm;               // (h - 1) x w
  double* T1 = T0 + (h - 1) * w;  // h x (w - 1)
  double* S = T1 + h * (w - 1);
  double* X0 = S + n;
  double* X1 = X0 + n;
  const float* a0 = pair_faces(t0, tshared, b, (long long)(h - 1) * w);
  const float* a1 = pair_faces(t1, tshared, b, (long long)h * (w - 1));
  for (int q = threadIdx.x; q < (h - 1) * w; q += blockDim.x) T0[q] = (double)a0[q];
  for (int q = threadIdx.x; q < h * (w - 1); q += blockDim.x) T1[q] = (double)a1[q];
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int ci = c / w, cj = c - ci * w;
    const double dn = ci < h - 1 ? T0[c] : 0.0, up = ci > 0 ? T0[c - w] : 0.0;
    const double rt = cj < w - 1 ? T1[ci * (w - 1) + cj] : 0.0;
    const double lt = cj > 0 ? T1[ci * (w - 1) + cj - 1] : 0.0;
    double d = (dn + up) + (rt + lt);
    d = d < 1e-30 ? 1e-30 : d;
    S[c] = (1.0 / d) * omega;
    X0[c] = c == i ? S[c] : 0.0;  // the first sweep from zero: e_i * step
  }
  __syncthreads();
  double* x = X0;
  double* y = X1;
  for (int k = 1; k < sweeps; ++k) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int ci = c / w, cj = c - ci * w;
      const double xc = x[c];
      double r = c == i ? 1.0 : 0.0;
      if (ci < h - 1) r = fma(-T0[c], xc - x[c + w], r);
      if (ci > 0) r = fma(T0[c - w], x[c - w] - xc, r);
      if (cj < w - 1) r = fma(-T1[ci * (w - 1) + cj], xc - x[c + 1], r);
      if (cj > 0) r = fma(T1[ci * (w - 1) + cj - 1], x[c - 1] - xc, r);
      y[c] = fma(S[c], r, xc);
    }
    __syncthreads();
    double* t = x;
    x = y;
    y = t;
  }
  double* o = out + ((long long)b * n + i) * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) o[c] = x[c];
}

int region_bytes(int TH, int TW, int halo) {
  const int RH = TH + 2 * halo, RW = TW + 2 * halo;
  return (int)sizeof(float) * ((RH + 1) * RW + RH * (RW + 1) + 4 * RH * RW);
}

constexpr int kMaxRegionBytes = 100 * 1024;

int allow_smem() {
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(mg_pre_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxRegionBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mg_post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxRegionBytes);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

}  // namespace

extern "C" {

int darsia_tpfa_apply(const float* p, const float* t0, const float* t1, int tshared,
                      const unsigned char* active, float* ap, double* part, int B, int h, int w,
                      int nblk, void* stream) {
  tpfa_apply_kernel<<<dim3(nblk, B), kThreads, 0, (cudaStream_t)stream>>>(p, t0, t1, tshared,
                                                                          active, ap, part, h, w);
  return (int)cudaGetLastError();
}

int darsia_cg_update(float* X, float* R, const int* sel, const float* P, const float* AP,
                     const double* part_pap, int nblk_pap, const float* rz, const float* mx,
                     const unsigned char* active, double* part, int B, int n, int nblk,
                     void* stream) {
  cg_update_kernel<<<dim3(nblk, B), kThreads, 0, (cudaStream_t)stream>>>(
      X, R, sel, P, AP, part_pap, nblk_pap, rz, mx, active, part, B, n);
  return (int)cudaGetLastError();
}

int darsia_mg_pre(const float* b, const int* bsel, int bflip, const float* t0, const float* t1,
                  int tshared, const unsigned char* active, float* xs, void* rc, int rc_double,
                  int B, int h, int w, int TH, int TW, int tiles_h, int tiles_w, int nu,
                  float omega, void* stream) {
  const int bytes = region_bytes(TH, TW, nu > 1 ? nu : 1);
  if (bytes > kMaxRegionBytes) return (int)cudaErrorInvalidValue;
  if (int err = allow_smem()) return err;
  mg_pre_kernel<<<dim3(tiles_h * tiles_w, B), dim3(kTileX, kTileY), bytes,
                  (cudaStream_t)stream>>>(b, bsel, bflip, t0, t1, tshared, active, xs, rc,
                                          rc_double, B, h, w, TH, TW, tiles_w, nu, omega);
  return (int)cudaGetLastError();
}

int darsia_mg_post(const float* b, const int* bsel, int bflip, const float* t0, const float* t1,
                   int tshared, const unsigned char* active, const float* xs, const void* ec,
                   int ec_double, float* out, double* part, int B, int h, int w, int TH, int TW,
                   int tiles_h, int tiles_w, int nu, float omega, void* stream) {
  const int bytes = region_bytes(TH, TW, nu);
  if (bytes > kMaxRegionBytes) return (int)cudaErrorInvalidValue;
  if (int err = allow_smem()) return err;
  mg_post_kernel<<<dim3(tiles_h * tiles_w, B), dim3(kTileX, kTileY), bytes,
                   (cudaStream_t)stream>>>(b, bsel, bflip, t0, t1, tshared, active, xs, ec,
                                           ec_double, out, part, B, h, w, TH, TW, tiles_w, nu,
                                           omega);
  return (int)cudaGetLastError();
}

int darsia_cg_direction(const float* Z, float* P, const double* part_v, int nblk_v,
                        const float* rz, float* rz_next, const unsigned char* active, int B,
                        int n, int nblk, void* stream) {
  cg_direction_kernel<<<dim3(nblk, B), kThreads, 0, (cudaStream_t)stream>>>(
      Z, P, part_v, nblk_v, rz, rz_next, active, n);
  return (int)cudaGetLastError();
}

int darsia_mg_coarse_matrix(const float* t0, const float* t1, int tshared, double* out, int B,
                            int h, int w, int sweeps, double omega, void* stream) {
  const int n = h * w, threads = n < 256 ? ((n + 31) / 32) * 32 : 256;
  const int bytes = (int)sizeof(double) * ((h - 1) * w + h * (w - 1) + 3 * n);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  mg_coarse_matrix_kernel<<<dim3(n, B), threads, bytes, (cudaStream_t)stream>>>(
      t0, t1, tshared, out, h, w, sweeps, omega);
  return (int)cudaGetLastError();
}

int darsia_cg_finalize(int* sel, float* mx, float* rn, float* rz, const float* rz_next,
                       const float* thr, unsigned char* active, const double* part_u, int nblk_u,
                       int B, int n, void* stream) {
  cg_finalize_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      sel, mx, rn, rz, rz_next, thr, active, part_u, nblk_u, n, B);
  return (int)cudaGetLastError();
}

}  // extern "C"

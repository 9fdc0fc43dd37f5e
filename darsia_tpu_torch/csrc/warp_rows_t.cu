// K1: channel-batched row resample with transposed output, for Hopper (sm_90a).
//
// Replaces darsia_tpu/ops/pallas/warp2pass.py::_row_warp_t_kernel (reached
// through warp_rows_pallas_t).  For data (C, R, W_in), cols (R, W_out) shared
// by all channels and a static displacement bound D = ceil(max_disp) + 1:
//
//   out[c, j, r] = v0 + frac * (v1 - v0)      (output transposed: (C, W_out, R))
//
// with the index arithmetic of the Pallas kernel reproduced exactly, so the
// two agree bit for bit:
//
//   tile_start = 128 * floor(j / 128)          (the TPU's lane tile)
//   rel_f      = clip(cols[r, j], 0, W_in - 1) + (P - tile_start)   in f32, P = D
//   base       = floor(rel_f),  frac = rel_f - base
//   rel        = clip(base, 0, nw * 128 - 2),   nw = ceil((2D + 129) / 128)
//   v0 / v1    = data[c, r, clamp(tile_start + rel - P (+1), 0, W_in - 1)]
//
// The clamp on rel is the edge of the Pallas window chain: where |cols - j|
// exceeds the bound, both kernels return chain-edge values instead of the
// exact sample.  The chain itself (a select over 128-wide windows) is an
// artifact of the TPU's 128-lane gather and is not carried over: Hopper loads
// any address, so each thread reads its two neighbours directly.  The lerp
// uses explicit round-to-nearest intrinsics so no FMA contraction separates it
// from the plain PyTorch version (warp_rows_t_reference).
//
// What bounds it on this card: memory bandwidth.  It must move
// 4 * (C*R*W_in + R*W_out + C*R*W_out) bytes (data and cols read once, the
// output written once) and does about 10 flops per output; at a 4K production
// pass (C = 3) that is 159 MB, 0.047 ms at 3.35 TB/s.
//
// Design.  A work item is a tile of 32 output columns j by 64 rows r, for a
// group of up to 4 channels.  A thread owns one j (lanes along j) and 8
// consecutive r (warps along r).
//   * Every channel's loads in flight before one barrier: cols and the
//     indices are derived once per (r, j), then all 2 * CG * 8 data loads are
//     issued (48 at C = 3) before any is used; the lerps go to a
//     double-buffered tile in shared memory, and one __syncthreads per item
//     both publishes this buffer and frees the other.
//   * Persistent blocks: the grid is SMs x resident blocks (asked of the
//     runtime, not assumed), each block walking items in a strided loop.  An
//     item's loads are in flight while the previous item's tile is stored,
//     and the next item's cols load while this one finishes.
//   * 16-byte stores along r, out of the staged tile.  A j-row of the tile is
//     68 floats, an odd number of 16-byte units, so the compute phase's
//     16-byte writes (4 consecutive r of one j) and the store phase's 16-byte
//     reads are both free of bank conflicts.  cols and data stay 4-byte loads
//     with lanes along j: each warp instruction then reads one 128-byte run
//     (a float4 cols read per thread would spread every gather instruction
//     over four times the sectors).
//   * Whole 32-byte sectors out: a tile computes rows r0 - 8 .. r0 + 55 and
//     each of its j-rows stores the 56-float run that starts at the sector
//     boundary at or before out[c, j, r0].  No output sector is written in
//     part by two tiles (a partly written sector costs device memory traffic
//     of its own); the 8-row halo is computed twice, 1/8 more samples.
// On sm_90a, ptxas gives CG = 3 123 registers and CG = 1 78, without spills;
// with 52,224 and 17,408 bytes of shared memory, 2 and 3 blocks of 256 threads
// are resident per SM, a grid of 264 and 396 blocks on 132 SMs.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLane = 128;  // the Pallas lane tile that fixes tile_start
constexpr int kTJ = 32;     // tile columns j: one per lane
constexpr int kTR = 64;     // tile rows r computed
constexpr int kHalo = 8;    // one 32-byte sector of floats
constexpr int kRun = kTR - kHalo;  // tile rows r stored: whole sectors
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTR / kWarps;  // consecutive r of one thread
constexpr int kStride = kTR + 4;     // floats per staged j-row
constexpr int kTileFloats = kTJ * kStride;  // one channel's staged tile
constexpr int kVecPerRow = kTR / 4;         // store lanes per j-row
constexpr int kVecStores = kTJ * kVecPerRow / kThreads;
constexpr int kMaxGroup = 4;  // channels staged per pass over a tile
constexpr int kDefaultSmem = 48 * 1024;  // above it, dynamic smem needs opt-in
constexpr int kMaxDevices = 64;
static_assert(kRows % 4 == 0 && kRun % 4 == 0, "16-byte groups of rows");
static_assert(kTJ * kVecPerRow % kThreads == 0, "store lanes");
static_assert(kStride / 4 % 2 == 1, "an odd number of 16-byte units per j-row");

__device__ __forceinline__ float lerp_rn(float v0, float v1, float frac) {
  return __fadd_rn(v0, __fmul_rn(frac, __fsub_rn(v1, v0)));
}

// Work item -> first channel and tile origin; item = tile * groups + group,
// tile = tr * tiles_j + tj (neighbouring blocks share input rows).  Tile tr
// stores the runs that start in the sector of row r0 = tr * kRun and computes
// rows r0 - kHalo .. r0 + kRun - 1.
struct Item {
  int c0, r0, j0;
};

template <int CG>
__device__ __forceinline__ Item item_origin(int item, int groups, int tiles_j) {
  const int tile = item / groups;
  const int tr = tile / tiles_j;
  return {(item - tile * groups) * CG, tr * kRun, (tile - tr * tiles_j) * kTJ};
}

// Row k of this thread in tile `it`, clamped into the array (clamped rows are
// computed and staged but never stored).
__device__ __forceinline__ int tile_row(Item it, int k, int R) {
  const int warp = threadIdx.x >> 5;
  return min(max(it.r0 - kHalo + warp * kRows + k, 0), R - 1);
}

__device__ __forceinline__ void load_cols(const float* __restrict__ cols, Item it,
                                          int R, int W_out, float (&c)[kRows]) {
  const int j = min(it.j0 + (int)(threadIdx.x & 31), W_out - 1);
#pragma unroll
  for (int k = 0; k < kRows; ++k) c[k] = __ldg(cols + tile_row(it, k, R) * W_out + j);
}

// The staged tile of item `it` (CG channels, [CG][kTJ][kStride]) to out.
// Each j-row stores the run out[c, j, r0 - s : r0 - s + kRun], s the offset of
// out[c, j, r0] in its 32-byte sector; tile position p holds row
// r0 - kHalo + p.  Lanes g < kRun / 4 of a j-row's kVecPerRow lanes each
// store 16-byte chunk g of the run.
template <int CG>
__device__ __forceinline__ void store_tile(const float* __restrict__ st,
                                           float* __restrict__ out, Item it, int C,
                                           int R, int W_out) {
#pragma unroll
  for (int cc = 0; cc < CG; ++cc) {
    if (it.c0 + cc >= C) break;
#pragma unroll
    for (int q = 0; q < kVecStores; ++q) {
      const int f = threadIdx.x + q * kThreads;
      const int jl = f / kVecPerRow, g = f % kVecPerRow;
      if (g >= kRun / 4 || it.j0 + jl >= W_out) continue;
      const size_t at = ((size_t)(it.c0 + cc) * W_out + it.j0 + jl) * R + it.r0;
      const int s = (int)(at % kHalo);
      const int r = it.r0 - s + 4 * g;  // first row of the chunk
      const float* src = st + cc * kTileFloats + jl * kStride + kHalo - s + 4 * g;
      float* dst = out + (at - s + 4 * g);
      if (r >= 0 && r + 4 <= R) {
        *reinterpret_cast<float4*>(dst) =
            s % 4 == 0 ? *reinterpret_cast<const float4*>(src)
                       : make_float4(src[0], src[1], src[2], src[3]);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (r + e >= 0 && r + e < R) dst[e] = src[e];
        }
      }
    }
  }
}

template <int CG>
__global__ void __launch_bounds__(kThreads, 2)
warp_rows_t_kernel(const float* __restrict__ data, const float* __restrict__ cols,
                   float* __restrict__ out, int C, int R, int W_in, int W_out,
                   int pad, int rel_max, int tiles_j, int groups, int num_items) {
  extern __shared__ float4 smem[];  // [2][CG][kTJ][kStride]: double-buffered tile
  float* const stage = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float hi = (float)(W_in - 1);

  float cn[kRows];  // cols of the next item, loaded one item ahead
  int item = blockIdx.x;
  load_cols(cols, item_origin<CG>(item, groups, tiles_j), R, W_out, cn);
  int prev = -1, buf = 0;
  for (; item < num_items; item += gridDim.x) {
    const Item it = item_origin<CG>(item, groups, tiles_j);

    // Sample indices (within a channel plane) and fractions, once for all
    // channels.
    const int j = min(it.j0 + lane, W_out - 1);
    const int tile_start = j & ~(kLane - 1);
    const float shift = (float)pad - (float)tile_start;  // exact: small integers
    int i0[kRows], i1[kRows];
    float frac[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float x = fminf(fmaxf(cn[k], 0.0f), hi);
      const float rel_f = __fadd_rn(x, shift);
      const float base = floorf(rel_f);
      frac[k] = __fsub_rn(rel_f, base);
      const int rel = (int)fminf(fmaxf(base, 0.0f), (float)rel_max);
      const int p = tile_start + rel - pad;
      const int row = tile_row(it, k, R) * W_in;
      i0[k] = row + min(max(p, 0), W_in - 1);
      i1[k] = row + min(max(p + 1, 0), W_in - 1);
    }

    // Every channel's loads in flight before any of them is used.
    float v0[CG][kRows], v1[CG][kRows];
#pragma unroll
    for (int cc = 0; cc < CG; ++cc) {
      const bool live = it.c0 + cc < C;
      const float* plane = data + (size_t)min(it.c0 + cc, C - 1) * R * W_in;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        v0[cc][k] = live ? __ldg(plane + i0[k]) : 0.0f;
        v1[cc][k] = live ? __ldg(plane + i1[k]) : 0.0f;
      }
    }

    // The next item's cols, in flight while this item finishes.
    const int next = item + gridDim.x;
    if (next < num_items) load_cols(cols, item_origin<CG>(next, groups, tiles_j), R, W_out, cn);

    // The previous item's tile leaves while these loads arrive.
    if (prev >= 0) {
      store_tile<CG>(stage + (buf ^ 1) * CG * kTileFloats, out,
                     item_origin<CG>(prev, groups, tiles_j), C, R, W_out);
    }

    // Lerp into this item's buffer, 4 consecutive r of the thread's j per
    // 16-byte store.
    float* st = stage + buf * CG * kTileFloats + lane * kStride + warp * kRows;
#pragma unroll
    for (int cc = 0; cc < CG; ++cc) {
#pragma unroll
      for (int k = 0; k < kRows; k += 4) {
        *reinterpret_cast<float4*>(st + cc * kTileFloats + k) = make_float4(
            lerp_rn(v0[cc][k], v1[cc][k], frac[k]),
            lerp_rn(v0[cc][k + 1], v1[cc][k + 1], frac[k + 1]),
            lerp_rn(v0[cc][k + 2], v1[cc][k + 2], frac[k + 2]),
            lerp_rn(v0[cc][k + 3], v1[cc][k + 3], frac[k + 3]));
      }
    }
    // One barrier per item: it publishes this buffer, and orders the reads
    // of the other buffer (above) before the next item overwrites it.
    __syncthreads();
    prev = item;
    buf ^= 1;
  }
  if (prev >= 0) {
    store_tile<CG>(stage + (buf ^ 1) * CG * kTileFloats, out,
                   item_origin<CG>(prev, groups, tiles_j), C, R, W_out);
  }
}

constexpr int stage_bytes(int cg) { return 2 * cg * kTileFloats * (int)sizeof(float); }

// Launch geometry: a persistent grid of (SMs x resident blocks) blocks, or
// one block per item where there are fewer items.
struct Plan {
  int tiles_j, groups, num_items, per_sm, grid;
};

// Resident blocks per SM and SM count of warp_rows_t_kernel<CG> on the
// current device (cached per device), after opting in to its dynamic shared
// memory.
template <int CG>
cudaError_t occupancy(int* per_sm, int* sms) {
  static int cache[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev][0] > 0) {
    *per_sm = cache[dev][0];
    *sms = cache[dev][1];
    return cudaSuccess;
  }
  constexpr int smem = stage_bytes(CG);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(warp_rows_t_kernel<CG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, warp_rows_t_kernel<CG>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) {
    cache[dev][0] = *per_sm;
    cache[dev][1] = *sms;
  }
  return cudaSuccess;
}

template <int CG>
cudaError_t plan(int C, int R, int W_out, Plan* p) {
  int sms = 0;
  const cudaError_t err = occupancy<CG>(&p->per_sm, &sms);
  if (err != cudaSuccess) return err;
  p->tiles_j = (W_out + kTJ - 1) / kTJ;
  p->groups = (C + CG - 1) / CG;
  // Runs start up to kHalo - 1 rows before r0: tiles_r * kRun - (kHalo - 1) >= R.
  p->num_items = p->tiles_j * ((R + kHalo - 1 + kRun - 1) / kRun) * p->groups;
  p->grid = min(p->num_items, sms * p->per_sm);
  return cudaSuccess;
}

template <int CG>
int launch(const float* data, const float* cols, float* out, int C, int R, int W_in,
           int W_out, int pad, int rel_max, cudaStream_t stream) {
  Plan p;
  const cudaError_t err = plan<CG>(C, R, W_out, &p);
  if (err != cudaSuccess) return (int)err;
  warp_rows_t_kernel<CG><<<p.grid, kThreads, stage_bytes(CG), stream>>>(
      data, cols, out, C, R, W_in, W_out, pad, rel_max, p.tiles_j, p.groups, p.num_items);
  return (int)cudaGetLastError();
}

template <int CG>
int report(int C, int R, int W_out, int* geometry) {
  Plan p;
  const cudaError_t err = plan<CG>(C, R, W_out, &p);
  if (err != cudaSuccess) return (int)err;
  geometry[0] = p.grid;
  geometry[1] = p.per_sm;
  geometry[2] = stage_bytes(CG);
  geometry[3] = p.num_items;
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes).  darsia_warp_rows_t launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() of the launch (or the error of its set-up).  `out` must
// be 32-byte aligned (a fresh allocation is).  C <= 4 channels run as one
// group, larger C in groups of 4.
extern "C" int darsia_warp_rows_t(const float* data, const float* cols, float* out,
                                  int C, int R, int W_in, int W_out, int pad,
                                  int rel_max, void* stream) {
  if (((size_t)out & 31) != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C < kMaxGroup ? C : kMaxGroup) {
    case 1: return launch<1>(data, cols, out, C, R, W_in, W_out, pad, rel_max, s);
    case 2: return launch<2>(data, cols, out, C, R, W_in, W_out, pad, rel_max, s);
    case 3: return launch<3>(data, cols, out, C, R, W_in, W_out, pad, rel_max, s);
    default: return launch<4>(data, cols, out, C, R, W_in, W_out, pad, rel_max, s);
  }
}

// The geometry darsia_warp_rows_t would launch with for these shapes on the
// current device: {grid blocks, resident blocks per SM, dynamic shared memory
// bytes per block, work items} into geometry[0..3].  Returns a cudaError.
extern "C" int darsia_warp_rows_t_geometry(int C, int R, int W_out, int* geometry) {
  switch (C < kMaxGroup ? C : kMaxGroup) {
    case 1: return report<1>(C, R, W_out, geometry);
    case 2: return report<2>(C, R, W_out, geometry);
    case 3: return report<3>(C, R, W_out, geometry);
    default: return report<4>(C, R, W_out, geometry);
  }
}

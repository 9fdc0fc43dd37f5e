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
// any address, so each thread reads its two neighbours directly.
//
// What bounds it on this card: memory bandwidth.  Per output element it moves
// about 12 bytes (one f32 of data read, one f32 of cols read, one f32 written)
// and does a handful of flops, far below the H100's compute/byte ratio.  The
// design keeps every access coalesced:
//   * a 32 x 32 (j, r) output tile per block; in the compute phase lanes run
//     along j, so cols and data (a smooth, bounded shift of j) are read in
//     contiguous runs;
//   * the tile is transposed through shared memory (padded to 33 columns, no
//     bank conflicts) and written with lanes along r, the output's minor axis;
//   * cols, and the index/fraction derived from it, are loaded once per tile
//     and reused for all C channels.
// The lerp uses explicit round-to-nearest intrinsics so no FMA contraction
// separates it from the plain PyTorch version (warp_rows_t_reference).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;        // output tile edge (j and r)
constexpr int kRowsPerStep = 8;  // block is kTile x kRowsPerStep threads
constexpr int kSteps = kTile / kRowsPerStep;
constexpr int kLane = 128;       // the Pallas lane tile that fixes tile_start

__global__ void __launch_bounds__(kTile * kRowsPerStep)
warp_rows_t_kernel(const float* __restrict__ data, const float* __restrict__ cols,
                   float* __restrict__ out, int C, int R, int W_in, int W_out,
                   int pad, int rel_max) {
  __shared__ float tile[kTile][kTile + 1];

  const int j = blockIdx.x * kTile + threadIdx.x;
  const int r0 = blockIdx.y * kTile;
  const bool j_ok = j < W_out;
  const int tile_start = (j / kLane) * kLane;
  const float shift = (float)pad - (float)tile_start;  // exact: small integers
  const float hi = (float)(W_in - 1);

  int i0[kSteps], i1[kSteps];
  float frac[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int r = r0 + threadIdx.y + k * kRowsPerStep;
    i0[k] = 0;
    i1[k] = 0;
    frac[k] = 0.0f;
    if (j_ok && r < R) {
      const float x = fminf(fmaxf(cols[(size_t)r * W_out + j], 0.0f), hi);
      const float rel_f = __fadd_rn(x, shift);
      const float base = floorf(rel_f);
      frac[k] = __fsub_rn(rel_f, base);
      const int rel = (int)fminf(fmaxf(base, 0.0f), (float)rel_max);
      const int p = tile_start + rel - pad;
      i0[k] = min(max(p, 0), W_in - 1);
      i1[k] = min(max(p + 1, 0), W_in - 1);
    }
  }

  const int r_out = r0 + threadIdx.x;  // write phase: lanes along r
  for (int c = 0; c < C; ++c) {
    const float* plane = data + (size_t)c * R * W_in;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int r = r0 + threadIdx.y + k * kRowsPerStep;
      if (j_ok && r < R) {
        const float* row = plane + (size_t)r * W_in;
        const float v0 = row[i0[k]];
        const float v1 = row[i1[k]];
        tile[threadIdx.x][threadIdx.y + k * kRowsPerStep] =
            __fadd_rn(v0, __fmul_rn(frac[k], __fsub_rn(v1, v0)));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int jj = blockIdx.x * kTile + threadIdx.y + k * kRowsPerStep;
      if (jj < W_out && r_out < R) {
        out[((size_t)c * W_out + jj) * R + r_out] =
            tile[threadIdx.y + k * kRowsPerStep][threadIdx.x];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() of the launch.
extern "C" int darsia_warp_rows_t(const float* data, const float* cols, float* out,
                                  int C, int R, int W_in, int W_out, int pad,
                                  int rel_max, void* stream) {
  const dim3 block(kTile, kRowsPerStep);
  const dim3 grid((W_out + kTile - 1) / kTile, (R + kTile - 1) / kTile);
  warp_rows_t_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      data, cols, out, C, R, W_in, W_out, pad, rel_max);
  return (int)cudaGetLastError();
}

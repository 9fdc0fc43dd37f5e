// K2 and K3: row resample with an untransposed output, for Hopper (sm_90a).
//
// K2 replaces darsia_tpu/ops/pallas/warp2pass.py::_row_warp_kernel (the plain
// schedule, launched at :218) and K3 replaces ::_row_warp_ring_kernel (the
// ring-buffer schedule, launched at :188); both are reached through
// warp_rows_pallas.  For data (R, W_in) (channels folded into rows), cols
// (R, W_out) and a static displacement bound D = ceil(max_disp) + 1:
//
//   out[r, j] = v0 + frac * (v1 - v0)
//
// with the index arithmetic of the Pallas kernels (and of K1, warp_rows_t.cu)
// reproduced exactly, so all of them agree bit for bit:
//
//   tile_start = 128 * floor(j / 128)          (the TPU's lane tile)
//   rel_f      = clip(cols[r, j], 0, W_in - 1) + (P - tile_start)   in f32, P = D
//   base       = floor(rel_f),  frac = rel_f - base
//   rel        = clip(base, 0, nw * 128 - 2),   nw = ceil((2D + 129) / 128)
//   v0 / v1    = data[r, clamp(tile_start + rel - P (+1), 0, W_in - 1)]
//
// rel is the offset into the output tile's chain of nw 128-wide windows of the
// edge-padded row; its clamp is the chain's edge, reached only where
// |cols - j| exceeds the bound.
//
// What bounds both on this card: memory bandwidth.  Per output element they
// move 12 bytes (one f32 of data read, one f32 of cols read, one f32 written)
// and do about ten flops.
//   * K2, the plain schedule: one thread per output element, a warp's lanes
//     along j, so the cols reads, the data reads (a bounded shift of j) and
//     the stores are contiguous runs.  Reuse of data between neighbouring
//     outputs is left to L1 and L2.
//   * K3, the ring schedule: a block owns a strip of kStrip rows and walks
//     along j in 128-column chunks.  The strip's input window, nw chunks of
//     the edge-padded rows, stays in a circular shared-memory buffer; each
//     step loads ONE new chunk into it (every input element is read from
//     device memory once, as the Pallas ring DMAs one block per step) and,
//     once nw chunks are in, computes one 128-column output tile from the
//     ring.  Logical window w of tile t sits in slot (t + w) % nw.  Each
//     step's cols are read before the chunk's barrier, so the two global
//     loads overlap.
// The lerp uses explicit round-to-nearest intrinsics so no FMA contraction
// separates it from the plain PyTorch version (warp_rows_reference).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLane = 128;   // the Pallas lane tile: output tile and chunk width
constexpr int kRowsK2 = 4;   // K2 block: kLane x kRowsK2 threads
constexpr int kStrip = 8;    // K3: rows per block
constexpr int kRowsK3 = 4;   // K3 block: kLane x kRowsK3 threads
constexpr int kStripPerThread = kStrip / kRowsK3;
constexpr size_t kDefaultSmem = 48 * 1024;  // above it, dynamic smem needs opt-in

__device__ __forceinline__ float lerp_rn(float v0, float v1, float frac) {
  return __fadd_rn(v0, __fmul_rn(frac, __fsub_rn(v1, v0)));
}

// Chain offset rel (clamped to the chain's edge) and fraction of sample
// position c in the output tile whose shift is P - tile_start.
__device__ __forceinline__ int chain_offset(float c, float hi, float shift,
                                            int rel_max, float* frac) {
  const float x = fminf(fmaxf(c, 0.0f), hi);
  const float rel_f = __fadd_rn(x, shift);
  const float base = floorf(rel_f);
  *frac = __fsub_rn(rel_f, base);
  return (int)fminf(fmaxf(base, 0.0f), (float)rel_max);
}

__global__ void __launch_bounds__(kLane * kRowsK2)
warp_rows_kernel(const float* __restrict__ data, const float* __restrict__ cols,
                 float* __restrict__ out, int R, int W_in, int W_out, int pad,
                 int rel_max) {
  const int r = blockIdx.x * kRowsK2 + threadIdx.y;
  const int tile_start = blockIdx.y * kLane;
  const int j = tile_start + threadIdx.x;
  if (r >= R || j >= W_out) return;
  const size_t at = (size_t)r * W_out + j;
  float frac;
  const int rel = chain_offset(cols[at], (float)(W_in - 1),
                               (float)pad - (float)tile_start, rel_max, &frac);
  const int p = tile_start + rel - pad;
  const float* row = data + (size_t)r * W_in;
  const float v0 = row[min(max(p, 0), W_in - 1)];
  const float v1 = row[min(max(p + 1, 0), W_in - 1)];
  out[at] = lerp_rn(v0, v1, frac);
}

__global__ void __launch_bounds__(kLane * kRowsK3)
warp_rows_ring_kernel(const float* __restrict__ data, const float* __restrict__ cols,
                      float* __restrict__ out, int R, int W_in, int W_out, int pad,
                      int rel_max, int nw) {
  extern __shared__ float ring[];  // [nw][kStrip][kLane]
  const int x = threadIdx.x;
  const int r0 = blockIdx.x * kStrip;
  const int num_tiles = (W_out + kLane - 1) / kLane;
  const float hi = (float)(W_in - 1);

  for (int s = 0; s < num_tiles + nw - 1; ++s) {
    // The output tile this step computes, once the ring is full.
    const int t = s - (nw - 1);
    const int j = t * kLane + x;
    const bool compute = t >= 0 && j < W_out;
    int rel[kStripPerThread];
    float frac[kStripPerThread];
#pragma unroll
    for (int k = 0; k < kStripPerThread; ++k) {
      const int r = r0 + threadIdx.y + k * kRowsK3;
      rel[k] = 0;
      frac[k] = 0.0f;
      if (compute && r < R) {
        rel[k] = chain_offset(cols[(size_t)r * W_out + j], hi,
                              (float)pad - (float)(t * kLane), rel_max, &frac[k]);
      }
    }

    // Padded chunk s into slot s % nw: padded column s*128 + x is input
    // column s*128 + x - P, edge-clamped.
    float* slot = ring + (size_t)(s % nw) * kStrip * kLane;
    const int col = min(max(s * kLane + x - pad, 0), W_in - 1);
#pragma unroll
    for (int k = 0; k < kStripPerThread; ++k) {
      const int row = threadIdx.y + k * kRowsK3;
      if (r0 + row < R) slot[row * kLane + x] = data[(size_t)(r0 + row) * W_in + col];
    }
    __syncthreads();

    if (compute) {
#pragma unroll
      for (int k = 0; k < kStripPerThread; ++k) {
        const int row = threadIdx.y + k * kRowsK3;
        if (r0 + row < R) {
          // Chain offset a lies in logical window a / 128 of tile t.
          const int a = rel[k], b = rel[k] + 1;
          const float* slot_a = ring + (size_t)((t + a / kLane) % nw) * kStrip * kLane;
          const float* slot_b = ring + (size_t)((t + b / kLane) % nw) * kStrip * kLane;
          const float v0 = slot_a[row * kLane + a % kLane];
          const float v1 = slot_b[row * kLane + b % kLane];
          out[(size_t)(r0 + row) * W_out + j] = lerp_rn(v0, v1, frac[k]);
        }
      }
    }
    // The next step overwrites the slot of chunk t, which this step read.
    __syncthreads();
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() of the
// launch (or of the shared-memory opt-in that precedes it).

extern "C" int darsia_warp_rows(const float* data, const float* cols, float* out,
                                int R, int W_in, int W_out, int pad, int rel_max,
                                void* stream) {
  const dim3 block(kLane, kRowsK2);
  const dim3 grid((R + kRowsK2 - 1) / kRowsK2, (W_out + kLane - 1) / kLane);
  warp_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      data, cols, out, R, W_in, W_out, pad, rel_max);
  return (int)cudaGetLastError();
}

extern "C" int darsia_warp_rows_ring(const float* data, const float* cols, float* out,
                                     int R, int W_in, int W_out, int pad, int rel_max,
                                     void* stream) {
  const int nw = (rel_max + 2) / kLane;
  const size_t smem = (size_t)nw * kStrip * kLane * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_rows_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kLane, kRowsK3);
  const dim3 grid((R + kStrip - 1) / kStrip);
  warp_rows_ring_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      data, cols, out, R, W_in, W_out, pad, rel_max, nw);
  return (int)cudaGetLastError();
}

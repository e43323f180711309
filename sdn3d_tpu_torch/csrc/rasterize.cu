// Forward triangle rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel sdn3d_tpu/ops/rasterize_pallas.py:662
// `rasterize_face_index_pallas` (default body `_raster_kernel_v3`, :543).
// It computes the function of the XLA reference
// `rasterize_face_maps(impl="xla")` (sdn3d_tpu/ops/rasterize.py:156-250),
// not the TPU schedule: faces in original order (no Morton sort), exact
// fp32 flat colours written planar (not v3's 3x10-bit packed plane).
//
// For each image b and pixel (px, py) with centre
//   XP = (2 px + 1 - S) / S,  YP = (2 py + 1 - S) / S
// the winner is the lowest-index face f that covers the pixel (three edge
// functions >= 0), is front-facing, non-degenerate and valid, and whose
// interpolated depth zp = 1 / (w0/z0 + w1/z1 + w2/z2) lies strictly inside
// (near, far) and is strictly less than every earlier face's.
//
// Bit-equality with the plain PyTorch version (ops/rasterize.py) needs the
// same IEEE operations in the same order: the build passes -fmad=false (no
// a*b+c contraction, which would flip boundary pixels) and keeps IEEE
// division (no --use_fast_math).  Per-face quantities (barycentric inverse,
// the front/valid/non-degenerate flag) come from the shared PyTorch
// pre-pass, so both versions start from the same bits.
//
// What bounds it on the H100: neither the bytes (the outputs, at most
// 20 B per pixel, are written once) nor the edge-test arithmetic of the
// face x pixel pairs that overlap, but the culling: every 16x16 tile
// tests the bounding box of every face of its image.  The design keeps
// that test cheap and the per-pixel work dense:
//   * a 256-face chunk is skipped by the whole block when its union box
//     (computed by the pre-pass) misses the tile;
//   * otherwise each thread tests one face's box, and the hits are
//     compacted into shared memory in ascending face order with a warp
//     ballot and a prefix sum over the eight warps;
//   * the hit faces' 18 floats are staged in shared memory, and each
//     thread walks that list for its own pixel with a strict `<` update.
// No atomics: the result is deterministic.  Binning faces to tiles first
// and staging with cp.async/TMA are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                 // 16 x 16 pixels per block
constexpr int kThreads = kTile * kTile;   // one pixel per thread
constexpr int kChunk = kThreads;          // faces tested per step
constexpr int kFaceFloats = 18;           // x0 y0 x1 y1 x2 y2 z0 z1 z2 inv[9]
constexpr int kWarps = kThreads / 32;

// torch.clamp semantics: NaN passes through; min(max(v, lo), hi) with
// std::max(a, b) = (a < b) ? b : a and std::min(a, b) = (b < a) ? b : a.
__device__ __forceinline__ float clamp01(float v) {
  if (v != v) return v;
  float m = (v < 0.0f) ? 0.0f : v;
  return (1.0f < m) ? 1.0f : m;
}

__device__ __forceinline__ float clamp_min_eps(float v) {
  if (v != v) return v;
  return (v < 1e-12f) ? 1e-12f : v;
}

__device__ __forceinline__ bool box_misses(int4 bb, int tx0, int tx1,
                                           int ty0, int ty1) {
  // bb = (x_lo, x_hi, y_lo, y_hi), inclusive pixel indices
  return bb.x > tx1 || bb.y < tx0 || bb.z > ty1 || bb.w < ty0;
}

__global__ void __launch_bounds__(kThreads)
raster_forward_kernel(const float* __restrict__ fdata,   // [B, F, 18]
                      const int4* __restrict__ bbox,     // [B, F]
                      const int4* __restrict__ cbbox,    // [B, NC]
                      const float* __restrict__ colors,  // [B, F, 3] or null
                      int F, int S, float near_z, float far_z,
                      int* __restrict__ fi_out,          // [B, S, S]
                      float* __restrict__ depth_out,     // [B, S, S]
                      float* __restrict__ rgb_out) {     // [B, 3, S, S] or null
  __shared__ int s_idx[kChunk];
  __shared__ float s_face[kChunk * kFaceFloats];
  __shared__ int s_warp[kWarps];

  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const int tx1 = min(tx0 + kTile, S) - 1;
  const int ty1 = min(ty0 + kTile, S) - 1;
  const int px = tx0 + (t % kTile);
  const int py = ty0 + (t / kTile);
  const bool active = px < S && py < S;   // ragged tile edge

  const float fS = (float)S;
  const float XP = (2.0f * (float)px + 1.0f - fS) / fS;
  const float YP = (2.0f * (float)py + 1.0f - fS) / fS;
  const float XI = (float)px;
  const float YI = (float)py;

  float best_z = far_z;
  int best = -1;

  const int n_chunks = (F + kChunk - 1) / kChunk;
  const float* fdata_b = fdata + (size_t)b * F * kFaceFloats;
  for (int c = 0; c < n_chunks; ++c) {
    // uniform across the block: every thread takes the same branch
    if (box_misses(cbbox[(size_t)b * n_chunks + c], tx0, tx1, ty0, ty1))
      continue;
    const int f = c * kChunk + t;
    bool hit = false;
    if (f < F) hit = !box_misses(bbox[(size_t)b * F + f], tx0, tx1, ty0, ty1);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_warp[w];
      offset += (w < warp) ? n : 0;
      total += n;
    }
    if (hit) s_idx[offset + __popc(mask & ((1u << lane) - 1u))] = f;
    __syncthreads();
    for (int i = t; i < total * kFaceFloats; i += kThreads) {
      const int k = i / kFaceFloats;
      const int j = i - k * kFaceFloats;
      s_face[i] = fdata_b[(size_t)s_idx[k] * kFaceFloats + j];
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < total; ++k) {
        const float* fd = s_face + k * kFaceFloats;
        const float x0 = fd[0], y0 = fd[1], x1 = fd[2], y1 = fd[3];
        const float x2 = fd[4], y2 = fd[5];
        const bool inside = ((YP - y0) * (x1 - x0) >= (XP - x0) * (y1 - y0)) &&
                            ((YP - y1) * (x2 - x1) >= (XP - x1) * (y2 - y1)) &&
                            ((YP - y2) * (x0 - x2) >= (XP - x2) * (y0 - y2));
        if (!inside) continue;
        float w0 = clamp01(fd[9] * XI + fd[10] * YI + fd[11]);
        float w1 = clamp01(fd[12] * XI + fd[13] * YI + fd[14]);
        float w2 = clamp01(fd[15] * XI + fd[16] * YI + fd[17]);
        const float ws = clamp_min_eps(w0 + w1 + w2);
        w0 = w0 / ws;
        w1 = w1 / ws;
        w2 = w2 / ws;
        const float zp = 1.0f / (w0 / fd[6] + w1 / fd[7] + w2 / fd[8]);
        if (zp > near_z && zp < far_z && zp < best_z) {
          best_z = zp;
          best = s_idx[k];
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const size_t plane = (size_t)S * S;
  const size_t p = (size_t)py * S + px;
  fi_out[(size_t)b * plane + p] = best;
  depth_out[(size_t)b * plane + p] = best_z;
  if (rgb_out != nullptr) {
    const float* col = colors + ((size_t)b * F + (best < 0 ? 0 : best)) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb_out[((size_t)b * 3 + ch) * plane + p] = best < 0 ? 0.0f : col[ch];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` and
// returns the cudaError_t of the launch (0 = success); never synchronises.
extern "C" int sdn3d_rasterize_forward(const float* fdata, const int* bbox,
                                       const int* cbbox, const float* colors,
                                       int B, int F, int S, float near_z,
                                       float far_z, int* fi_out,
                                       float* depth_out, float* rgb_out,
                                       void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (S + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, B);
  raster_forward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      fdata, reinterpret_cast<const int4*>(bbox),
      reinterpret_cast<const int4*>(cbbox), colors, F, S, near_z, far_z,
      fi_out, depth_out, rgb_out);
  return (int)cudaGetLastError();
}

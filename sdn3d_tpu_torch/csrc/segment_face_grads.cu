// Pixel->face reduction of the silhouette gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel sdn3d_tpu/ops/rasterize_pallas.py:941
// `segment_face_grads_pallas` (body `_seg_kernel`, :887), which the JAX
// package's `_reduce_pixel_grads` (sdn3d_tpu/ops/rasterize.py:320-347)
// calls on the TPU; elsewhere that function takes six scalar segment sums,
// whose plain PyTorch version is `segment_face_grads_plain`
// (sdn3d_tpu_torch/ops/rasterize.py):
//
//   out[b, f, 2v + c] = sum over pixels p with face_index[b, p] == f of
//                       -acc_c[b, v, p],   c = 0: x (acc_x), 1: y (acc_y).
//
// One warp per (image, face).  The face's pixel box comes from the forward
// rasterizer's pre-pass (`pack_faces`): it is proven to hold every pixel
// the face can win, so no pixel is lost.  The lanes stride the box's
// pixels in row-major order, each keeping six running sums of the pixels
// whose face index is f, and a fixed xor-shuffle tree adds the 32 lanes.
// Every face's sum is taken in the same order on every launch: the result
// is deterministic, with no atomics.  The order differs from the plain
// version's (pixel order), so the two agree to float32 rounding of the
// sums, not bit for bit.
//
// What bounds it on the H100: bytes.  Each pixel's face index and the six
// planes are needed once; the kernel reads each box's face indices and,
// where the face wins, its six planes.  Boxes overlap (a pixel lies in the
// boxes of its neighbouring faces too) and widened boxes of slivers are
// large, which is what a tighter box would cut (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
segment_kernel(const float* __restrict__ acc_x,  // [B, 3, H, W]
               const float* __restrict__ acc_y,  // [B, 3, H, W]
               const int* __restrict__ fi,       // [B, H, W]
               const int4* __restrict__ bbox,    // [B, F] (x_lo, x_hi, y_lo, y_hi)
               int B, int F, int H, int W,
               float* __restrict__ out) {        // [B, F, 6]
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gw >= (long long)B * F) return;          // whole warps leave together
  const int b = (int)(gw / F);
  const int f = (int)(gw % F);
  const int4 bb = bbox[gw];
  const size_t plane = (size_t)H * W;
  const int* fi_b = fi + (size_t)b * plane;
  const float* ax = acc_x + (size_t)b * 3 * plane;
  const float* ay = acc_y + (size_t)b * 3 * plane;

  float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (bb.x <= bb.y && bb.z <= bb.w) {
    const int bw = bb.y - bb.x + 1;
    const int n = bw * (bb.w - bb.z + 1);
    for (int i = lane; i < n; i += 32) {
      const int y = bb.z + i / bw;
      const int x = bb.x + i % bw;
      const size_t p = (size_t)y * W + x;
      if (fi_b[p] == f) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          s[2 * v] += -ax[v * plane + p];
          s[2 * v + 1] += -ay[v * plane + p];
        }
      }
    }
  }
  // fixed tree: lane l adds lane l^o at each level; both lanes of a pair
  // compute the same commutative sum, so every lane ends with equal bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
  }
  if (lane == 0) {
    float* o6 = out + gw * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) o6[c] = s[c];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` and
// returns the cudaError_t of the launch (0 = success); never synchronises.
extern "C" int sdn3d_segment_face_grads(const float* acc_x,
                                        const float* acc_y, const int* fi,
                                        const int* bbox, int B, int F, int H,
                                        int W, float* out, void* stream) {
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * F;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  segment_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      acc_x, acc_y, fi, reinterpret_cast<const int4*>(bbox), B, F, H, W, out);
  return (int)cudaGetLastError();
}

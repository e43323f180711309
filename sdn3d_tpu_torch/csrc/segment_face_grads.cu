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
// Two kernels, launched one after the other by the same wrapper:
//
//   won_box_kernel  one thread per pixel: where the pixel's face is f, it
//                   widens f's box (x_lo, x_hi, y_lo, y_hi), which the
//                   wrapper fills with (S, -1, S, -1), by integer atomicMin /
//                   atomicMax.  A thread only touches an edge of the box its
//                   neighbour on that side cannot set (the neighbour has
//                   another face or lies outside the image), so the atomics
//                   come from the boundary pixels of each face's region.
//                   Integer min and max commute: the boxes are the same on
//                   every launch whatever the atomics' order.  The plain
//                   version of this pass is `won_pixel_boxes`.
//   segment_kernel  one warp per (image, face) over the face's exact box of
//                   won pixels: the lanes stride the box's pixels in
//                   row-major order, each keeping six running sums of the
//                   pixels whose face index is f, and a fixed xor-shuffle
//                   tree adds the 32 lanes.  Every face's sum is taken in
//                   the same order on every launch: the result is
//                   deterministic.  The order differs from the plain
//                   version's (pixel order), so the two agree to float32
//                   rounding of the sums, not bit for bit.
//
// The boxes come from the face index alone, so the reduction cannot lose a
// pixel whatever the forward rasterizer culls, and the forward does no
// work for the backward.
//
// What bounds it on the H100: bytes.  Each pixel's face index is needed
// once, the six planes only at the won pixels.  The box pass reads the face
// index once (neighbours' reads hit the cache).  The sum kernel reads the
// face indices of each face's box, and exact boxes of the won pixels hold
// only a few pixels per won pixel (a face's box also covers some of its
// neighbours' pixels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
won_box_kernel(const int* __restrict__ fi,   // [B, H, W]
               int B, int F, int H, int W,
               int* __restrict__ box) {      // [B, F, 4] (x_lo, x_hi, y_lo, y_hi)
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long plane = (long long)H * W;
  if (g >= (long long)B * plane) return;
  const int f = fi[g];
  if (f < 0 || f >= F) return;
  const int b = (int)(g / plane);
  const int p = (int)(g - (long long)b * plane);
  const int y = p / W;
  const int x = p - y * W;
  int* bx = box + ((size_t)b * F + f) * 4;
  if (x == 0 || fi[g - 1] != f) atomicMin(bx + 0, x);
  if (x == W - 1 || fi[g + 1] != f) atomicMax(bx + 1, x);
  if (y == 0 || fi[g - W] != f) atomicMin(bx + 2, y);
  if (y == H - 1 || fi[g + W] != f) atomicMax(bx + 3, y);
}

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

// Plain C entry points, bound with ctypes.  Each launches on `stream` and
// returns the cudaError_t of the launch (0 = success); never synchronises.

// box [B, F, 4] must hold (S, -1, S, -1) per face, S >= max(H, W).
extern "C" int sdn3d_won_pixel_boxes(const int* fi, int B, int F, int H,
                                     int W, int* box, void* stream) {
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  won_box_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(fi, B, F, H,
                                                                  W, box);
  return (int)cudaGetLastError();
}

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

// Silhouette-gradient edge walk for Hopper (sm_90a).
//
// Replaces the TPU kernel sdn3d_tpu/ops/rasterize_pallas.py:1071
// `walk_grads_pallas` (body `_walk_kernel`, :998).  It computes the
// function of the XLA fori+roll loop of `_silhouette_grad_pixelwise`
// (sdn3d_tpu/ops/rasterize.py:462-531) and of its plain PyTorch version
// `walk_grads_plain` (sdn3d_tpu_torch/ops/rasterize.py), for one axis:
//
//   for k = 1..n_steps, for each of the pixel's face's edges e:
//     OUT  (pixel is edge e's in-boundary pixel): read alpha/grad at
//          distance k along the walk, diff = (a_k - alpha) * g_k, and add
//          diff / dist of the edge's two endpoints;
//     IN   (pixel lies j = k-1 steps inside the face from edge e):
//          diff = (alpha - a_k) * grad, same distance terms at the pixel;
//   into per-vertex accumulators, acc = (acc + gA) + gA_in per vertex,
//   edges 0, 1, 2 in order, k ascending.
//
// The 18 invariant planes (d1_cross, direction, kA, kB, j_gate,
// is_in_pixel per edge) come from the shared PyTorch pre-pass
// (`edge_invariant_stack`), so kernel and plain version start from the
// same bits.  Axis 0 walks along rows (stride W), axis 1 along columns
// (stride 1): no transposes.
//
// Bit-equality with the plain version: the same IEEE operations in the
// same order, built with -fmad=false (no a*b+c contraction, e.g. of
// kA * (d1k - d1_cross) + eps) and IEEE division (no --use_fast_math).
// Reads outside the image are zero (the plain version's torch.roll wraps
// around); the gates discard every such read in both.
//
// What bounds it on the H100: the operations of the gated terms are few
// (OUT terms only at in-boundary pixels, one IN step per pixel and edge),
// so a single pass over the planes, ~23 planes x 4 B per pixel, is the
// least the card could take.  The design:
//   * one thread per pixel at a time (a thread walks 8 pixels of its
//     block's 64 x 32 tile in turn), its 18 invariants in registers, read
//     once;
//   * alpha and grad of the tile plus a halo of n_steps pixels on both
//     sides along the walk are staged in shared memory (at n_steps 64:
//     192 x 32 x 2 planes x 4 B = 48 KB); longer walks read global memory;
//   * a pixel stops walking after the last step that can carry a term
//     (its OUT walk reaches the border or n_steps; its IN step is
//     j_gate + 1).  The skipped steps would each add +0.0 to an
//     accumulator that is never -0.0, so the sums are unchanged.
// No atomics, no reduction across threads: the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWalk = 64;     // pixels along the walk per block
constexpr int kTileCross = 32;    // pixels across the walk per block
constexpr int kInvRows = 18;
// Longest window staged in shared memory.  chip_smoke.py builds the source
// with -DSDN3D_WALK_MAX_STAGED_STEPS=-1 (global-memory reads at every
// window) to time the staging against its absence.
#ifndef SDN3D_WALK_MAX_STAGED_STEPS
#define SDN3D_WALK_MAX_STAGED_STEPS 64
#endif
constexpr int kMaxStagedSteps = SDN3D_WALK_MAX_STAGED_STEPS;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ alpha,   // [B, H, W]
            const float* __restrict__ grad,    // [B, H, W]
            const float* __restrict__ inv,     // [B, 18, H, W]
            float* __restrict__ out,           // [B, 3, H, W]
            int H, int W, int n_steps, float eps, int axis) {
  extern __shared__ float s_buf[];

  const int b = blockIdx.z;
  // tile in image coordinates: TX x TY pixels, x fastest (coalesced)
  const int TX = axis == 0 ? kTileCross : kTileWalk;
  const int TY = axis == 0 ? kTileWalk : kTileCross;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const size_t plane = (size_t)H * W;
  const float* alpha_b = alpha + (size_t)b * plane;
  const float* grad_b = grad + (size_t)b * plane;
  const int walk_len = axis == 0 ? H : W;
  const ptrdiff_t gstep = axis == 0 ? (ptrdiff_t)W : 1;   // global step

  // staged region: the tile widened by n_steps along the walk
  const int hy = axis == 0 ? n_steps : 0;
  const int hx = axis == 0 ? 0 : n_steps;
  const int RH = TY + 2 * hy;
  const int RW = TX + 2 * hx;
  float* s_alpha = s_buf;
  float* s_grad = s_buf + RH * RW;
  if (kStaged) {
    for (int i = threadIdx.x; i < RH * RW; i += kThreads) {
      const int gy = y0 - hy + i / RW;
      const int gx = x0 - hx + i % RW;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t p = (size_t)gy * W + gx;
      s_alpha[i] = in ? alpha_b[p] : 0.0f;
      s_grad[i] = in ? grad_b[p] : 0.0f;
    }
    __syncthreads();
  }
  const int sstep = axis == 0 ? RW : 1;                    // shared step

  const float last = (float)(walk_len - 1);
  for (int i = threadIdx.x; i < TX * TY; i += kThreads) {
    const int lx = i % TX;
    const int ly = i / TX;
    const int px = x0 + lx;
    const int py = y0 + ly;
    if (px >= W || py >= H) continue;
    const size_t pix = (size_t)py * W + px;
    const int w = axis == 0 ? py : px;      // the pixel's walk coordinate
    const float d1 = (float)w;

    const float* inv_p = inv + (size_t)b * kInvRows * plane + pix;
    float d1c[3], dir[3], kA[3], kB[3], jg[3], uA[3], uB[3];
    bool isin[3];
    int k_max = 0;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      d1c[e] = inv_p[(6 * e + 0) * plane];
      dir[e] = inv_p[(6 * e + 1) * plane];
      kA[e] = inv_p[(6 * e + 2) * plane];
      kB[e] = inv_p[(6 * e + 3) * plane];
      jg[e] = inv_p[(6 * e + 4) * plane];
      isin[e] = inv_p[(6 * e + 5) * plane] > 0.0f;
      // IN-pass distances do not depend on k
      const float tA = kA[e] * (d1 - d1c[e]);
      uA[e] = tA > 0.0f ? tA + eps : tA - eps;
      const float tB = kB[e] * (d1 - d1c[e]);
      uB[e] = tB > 0.0f ? tB + eps : tB - eps;
      // last step that can carry a term of this edge
      if (isin[e]) {
        const int border = dir[e] > 0.0f ? walk_len - 1 - w : w;
        k_max = max(k_max, min(n_steps, border));
      }
      if (jg[e] >= 0.0f && jg[e] + 1.0f <= (float)n_steps)
        k_max = max(k_max, (int)jg[e] + 1);
    }

    const float a0 = alpha_b[pix];
    const float g0 = grad_b[pix];
    float acc[3] = {0.0f, 0.0f, 0.0f};
    const int sbase = (ly + hy) * RW + (lx + hx);
    for (int k = 1; k <= k_max; ++k) {
      const float kf = (float)k;
      float a_f, a_b, g_f, g_b;
      if (kStaged) {
        a_f = s_alpha[sbase + k * sstep];
        a_b = s_alpha[sbase - k * sstep];
        g_f = s_grad[sbase + k * sstep];
        g_b = s_grad[sbase - k * sstep];
      } else {
        const bool f_in = w + k < walk_len;
        const bool b_in = w - k >= 0;
        a_f = f_in ? alpha_b[pix + k * gstep] : 0.0f;
        a_b = b_in ? alpha_b[pix - k * gstep] : 0.0f;
        g_f = f_in ? grad_b[pix + k * gstep] : 0.0f;
        g_b = b_in ? grad_b[pix - k * gstep] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const bool pos = dir[e] > 0.0f;
        const float a_k = pos ? a_f : a_b;
        // OUT: contributions land at the in-boundary pixel
        const float d1k = d1 + dir[e] * kf;
        const bool in_seg = d1k >= 0.0f && d1k <= last;
        const float g_k = pos ? g_f : g_b;
        const float diff = (a_k - a0) * g_k;
        float gA = 0.0f, gB = 0.0f;
        if (isin[e] && in_seg && diff > 0.0f) {
          float tA = kA[e] * (d1k - d1c[e]);
          tA = tA > 0.0f ? tA + eps : tA - eps;
          float tB = kB[e] * (d1k - d1c[e]);
          tB = tB > 0.0f ? tB + eps : tB - eps;
          if (kA[e] != 0.0f) gA = diff / tA;
          if (kB[e] != 0.0f) gB = diff / tB;
        }
        // IN: pixels at walk distance j = k-1 read their alpha_out (= a_k)
        const float diff_in = (a0 - a_k) * g0;
        float gA_in = 0.0f, gB_in = 0.0f;
        if (jg[e] == kf - 1.0f && diff_in > 0.0f) {
          if (kA[e] != 0.0f) gA_in = diff_in / uA[e];
          if (kB[e] != 0.0f) gB_in = diff_in / uB[e];
        }
        const int i1 = e == 2 ? 0 : e + 1;
        acc[e] = (acc[e] + gA) + gA_in;
        acc[i1] = (acc[i1] + gB) + gB_in;
      }
    }
    float* out_p = out + (size_t)b * 3 * plane + pix;
    out_p[0] = acc[0];
    out_p[plane] = acc[1];
    out_p[2 * plane] = acc[2];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` and
// returns the cudaError_t of the launch (0 = success); never synchronises.
extern "C" int sdn3d_walk_grads(const float* alpha, const float* grad,
                                const float* inv, float* out, int B, int H,
                                int W, int n_steps, float eps, int axis,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_steps < 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const int TX = axis == 0 ? kTileCross : kTileWalk;
  const int TY = axis == 0 ? kTileWalk : kTileCross;
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_steps <= kMaxStagedSteps) {
    const size_t smem =
        (size_t)2 * (kTileWalk + 2 * n_steps) * kTileCross * sizeof(float);
    walk_kernel<true><<<grid, kThreads, smem, s>>>(alpha, grad, inv, out, H,
                                                   W, n_steps, eps, axis);
  } else {
    walk_kernel<false><<<grid, kThreads, 0, s>>>(alpha, grad, inv, out, H,
                                                 W, n_steps, eps, axis);
  }
  return (int)cudaGetLastError();
}

// Silhouette-gradient edge walk for Hopper (sm_90a), with the walk's edge
// invariants computed in the kernel.
//
// Replaces the TPU kernel sdn3d_tpu/ops/rasterize_pallas.py:1071
// `walk_grads_pallas` (body `_walk_kernel`, :998) together with its XLA
// pre-pass, the 18 invariant planes per axis of `_edge_invariants`
// (sdn3d_tpu/ops/rasterize.py:257) over a per-pixel gather of the face
// table.  It computes, for both axes in one launch, the function of the
// plain PyTorch composition `walk_grads_faces_plain`
// (sdn3d_tpu_torch/ops/rasterize.py):
//
//   invariants (`edge_invariant_stack` of the pixel's face's pixel-space
//   vertices), then for k = 1..n_steps, for each of the face's edges e:
//     OUT  (pixel is edge e's in-boundary pixel): read alpha/grad at
//          distance k along the walk, diff = (a_k - alpha) * g_k, and add
//          diff / dist of the edge's two endpoints;
//     IN   (pixel lies j = k-1 steps inside the face from edge e):
//          diff = (alpha - a_k) * grad, same distance terms at the pixel;
//   into per-vertex accumulators, acc = (acc + gA) + gA_in per vertex,
//   edges 0, 1, 2 in order, k ascending.
//
// Bit-equality with the plain version: the invariants repeat
// `_edge_invariants`' operations in its order (IEEE division, floorf /
// ceilf, torch.minimum / maximum / clamp semantics), and the walk repeats
// `walk_grads_plain`'s; built with -fmad=false (no a*b+c contraction) and
// IEEE division (no --use_fast_math).  Axis 0 walks along rows (d1 = y,
// stride W), axis 1 along columns (d1 = x, stride 1): no transposes;
// blockIdx.z selects the axis.
//
// What bounds it on the H100: the function reads alpha, grad and the face
// index once, the [B, F, 6] face table (in L2), and writes 3 planes per
// axis: ~24 B a pixel per axis.  The walk's arithmetic is what a naive
// kernel spends its time on, so the design does only the steps that can
// carry a term, and keeps a warp's lanes busy with them:
//   * background pixels (face index < 0) have no term: they write +0.0 and
//     read nothing else; a tile without a face writes zeros and returns;
//   * a term needs a_k != alpha at the pixel (diff and diff_in are 0 or NaN
//     otherwise, and fail their `> 0` gates).  The tile's alpha and grad
//     plus a halo of n_steps along the walk are staged in shared memory
//     (windows up to 64), with a bit mask per line marking where alpha
//     changes; a pixel jumps over each run of its own alpha value in one
//     step.  A pixel whose run covers its whole window writes zeros
//     without computing its invariants;
//   * the pixels left (a fifth to a third of the hit pixels at the refine
//     path's inputs) are packed into a work list in shared memory (warp
//     ballot, one atomic a warp), and the block's threads take them in
//     turn, so no lane idles behind a neighbour that walks while it has
//     nothing to do.  A pixel's steps stay on one lane, in order;
//   * at the steps left, the walk body runs unchanged: each skipped step
//     would add only +0.0 to accumulators that are never -0.0, so the sums
//     are bit-equal to the plain version's;
//   * longer windows read global memory and scan for the next differing
//     alpha step by step.
// Reads outside the image are zero (the plain version's torch.roll wraps
// around); the gates discard every such read in both.  No atomics on the
// sums, no reduction across threads: the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWalk = 64;     // pixels along the walk per block
constexpr int kTileCross = 32;    // pixels across the walk per block (lines)
constexpr int kTilePixels = kTileWalk * kTileCross;
static_assert(kTilePixels % kThreads == 0, "whole warps per tile pass");
constexpr int kBig = 1 << 28;     // "no further step"
// Longest window staged in shared memory.  chip_smoke.py builds the source
// with -DSDN3D_WALK_MAX_STAGED_STEPS=-1 (global-memory scans at every
// window) to time the staging against its absence.
#ifndef SDN3D_WALK_MAX_STAGED_STEPS
#define SDN3D_WALK_MAX_STAGED_STEPS 64
#endif
constexpr int kMaxStagedSteps = SDN3D_WALK_MAX_STAGED_STEPS;
// 32-bit words of a line's run mask: the tile plus both halos
constexpr int kLineWords =
    (kTileWalk + 2 * (kMaxStagedSteps > 0 ? kMaxStagedSteps : 0) + 31) / 32;

// torch.minimum / maximum / clamp_min / clamp_max on the card: NaN wins
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float t_clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

struct Edge {
  float d1c, dir, kA, kB, jg;
  bool isin;
};

// `_edge_invariants` (sdn3d_tpu_torch/ops/rasterize.py) for one pixel and
// edge, its operations in its order.  u / v: the face's vertex coordinates
// across / along the walk; d0 / d1: the pixel's.
__device__ __forceinline__ Edge edge_invariants(const float* u, const float* v,
                                                float d0, float d1, int isz,
                                                int axis, int e) {
  const int i0 = e, i1 = (e + 1) % 3, i2 = (e + 2) % 3;
  const float Au = u[i0], Bu = u[i1], Cu = u[i2];
  const float Av = v[i0], Bv = v[i1], Cv = v[i2];
  const float last = (float)(isz - 1);

  const bool nonvert = Bu != Au;
  const float slope = (Bv - Av) / (nonvert ? Bu - Au : 1.0f);
  const float d1_cross = slope * (d0 - Au) + Av;
  const float dir = axis == 0 ? (Au < Bu ? -1.0f : 1.0f)
                              : (Au < Bu ? 1.0f : -1.0f);
  const float d1_in = dir > 0.0f ? floorf(d1_cross) : ceilf(d1_cross);
  const float d1_out = d1_in + dir;
  const bool col_ok = nonvert && d0 >= ceilf(t_min(Au, Bu)) &&
                      d0 <= t_max(Au, Bu) && d1_in >= 0.0f &&
                      d1_in <= last && d1_out >= 0.0f && d1_out <= last;

  const float base_k = ((Bu - Au) * 2.0f) / (float)isz;
  Edge E;
  E.d1c = d1_cross;
  E.dir = dir;
  E.kA = Bu != d0 ? base_k / (Bu - d0) : 0.0f;
  E.kB = Au != d0 ? base_k / (d0 - Au) : 0.0f;

  const bool use_ac = (d0 - Au) * (d0 - Cu) < 0.0f;
  const float slope_ac = (Cv - Av) / (Cu != Au ? Cu - Au : 1.0f);
  const float slope_bc = (Bv - Cv) / (Bu != Cu ? Bu - Cu : 1.0f);
  const float d0_cross2 = use_ac ? slope_ac * (d0 - Au) + Av
                                 : slope_bc * (d0 - Cu) + Cv;
  const float d1_lim_in = dir > 0.0f ? ceilf(d0_cross2) : floorf(d0_cross2);
  const float lo_in = t_clamp_min(t_min(d1_in, d1_lim_in), 0.0f);
  const float hi_in = t_clamp_max(t_max(d1_in, d1_lim_in), (float)isz - 1.0f);
  const bool in_range = col_ok && d1 >= lo_in && d1 <= hi_in;
  E.jg = in_range ? (d1_in - d1) * dir : -1.0f;
  E.isin = col_ok && d1_in == d1;
  return E;
}

// Smallest set bit >= t of a line's mask, or kBig.
__device__ __forceinline__ int next_set_bit(const uint32_t* mask, int t) {
  int w = t >> 5;
  if (w >= kLineWords) return kBig;
  uint32_t m = mask[w] & (0xffffffffu << (t & 31));
  while (m == 0) {
    if (++w >= kLineWords) return kBig;
    m = mask[w];
  }
  return (w << 5) + __ffs(m) - 1;
}

// Largest set bit <= t of a line's mask (bit 0 is always set).
__device__ __forceinline__ int last_set_bit(const uint32_t* mask, int t) {
  int w = t >> 5;
  uint32_t m = mask[w] & (0xffffffffu >> (31 - (t & 31)));
  while (m == 0) m = mask[--w];
  return (w << 5) + 31 - __clz(m);
}

// Where a pixel's walk reads alpha and grad: the staged tile (positions t
// along the line, zero halo) or global memory (bounds-checked).
struct Line {
  const float* a;     // alpha at the pixel
  const float* g;     // grad at the pixel
  ptrdiff_t step;     // one step along the walk
  const uint32_t* mask;   // staged: bit t set where alpha[t] != alpha[t-1]
  int t;              // staged: the pixel's position on its line
  int fwd_room;       // global: steps to the border forwards / backwards
  int bwd_room;
};

// Smallest k' in [k, kmax] whose alpha along direction `sgn` differs from
// a0, or kBig: the steps that can carry a term.
template <bool kStaged>
__device__ __forceinline__ int next_step(const Line& L, int sgn, int k,
                                         int kmax, float a0) {
  while (k <= kmax) {
    if (L.a[sgn * k * L.step] != a0) return k;
    if (kStaged) {
      // alpha here equals a0, and so does its whole run: jump past it
      const int t = L.t + sgn * k;
      k = sgn > 0 ? next_set_bit(L.mask, t + 1) - L.t
                  : L.t - (last_set_bit(L.mask, t) - 1);
    } else {
      ++k;
    }
  }
  return kBig;
}

// A pixel of the tile: where it is, its line, its face, its alpha and the
// first step each way whose alpha differs from it (kBig: none).
struct Pixel {
  Line L;
  size_t pix;
  int px, py, w, f, kf, kb;
  float a0;
};

// 4 blocks an SM (64 registers a thread): the staged tile of a 64-step
// window takes ~54 KB of shared memory a block
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 4)
walk_faces_kernel(const float* __restrict__ alpha,   // [B, S, S]
                  const float* __restrict__ grad,    // [B, S, S]
                  const int* __restrict__ face_index,  // [B, S, S]
                  const float* __restrict__ pp,      // [B, F, 6]
                  float* __restrict__ out,           // [2, B, 3, S, S]
                  int B, int S, int F, int n_steps, float eps) {
  extern __shared__ float s_buf[];
  __shared__ uint32_t s_mask[kTileCross * kLineWords];
  __shared__ uint16_t s_work[kTilePixels];   // tile positions of walkers
  __shared__ int s_n_work;

  // blockIdx.z = axis * B + b
  const int axis = blockIdx.z / B;
  const int b = blockIdx.z % B;
  // tile in image coordinates: TX x TY pixels, x fastest (coalesced)
  const int TX = axis == 0 ? kTileCross : kTileWalk;
  const int TY = axis == 0 ? kTileWalk : kTileCross;
  const int tiles_x = (S + TX - 1) / TX;
  if ((int)blockIdx.x >= tiles_x * ((S + TY - 1) / TY)) return;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const size_t plane = (size_t)S * S;
  const float* alpha_b = alpha + (size_t)b * plane;
  const float* grad_b = grad + (size_t)b * plane;
  const int* fi_b = face_index + (size_t)b * plane;
  const float* pp_b = pp + (size_t)b * F * 6;
  float* out_b = out + ((size_t)axis * B + b) * 3 * plane;

  // a tile without a face: every accumulator is +0.0
  if (threadIdx.x == 0) s_n_work = 0;
  bool any_hit = false;
  for (int i = threadIdx.x; i < kTilePixels; i += kThreads) {
    const int px = x0 + i % TX, py = y0 + i / TX;
    if (px < S && py < S && fi_b[(size_t)py * S + px] >= 0) any_hit = true;
  }
  if (!__syncthreads_or(any_hit)) {
    for (int i = threadIdx.x; i < kTilePixels; i += kThreads) {
      const int px = x0 + i % TX, py = y0 + i / TX;
      if (px >= S || py >= S) continue;
      float* o = out_b + (size_t)py * S + px;
      o[0] = 0.0f;
      o[plane] = 0.0f;
      o[2 * plane] = 0.0f;
    }
    return;
  }

  // staged region: the tile widened by n_steps along the walk; a line is
  // one column (axis 0) or row (axis 1) of it
  const int hy = axis == 0 ? n_steps : 0;
  const int hx = axis == 0 ? 0 : n_steps;
  const int RH = TY + 2 * hy;
  const int RW = TX + 2 * hx;
  const int sstep = axis == 0 ? RW : 1;
  float* s_alpha = s_buf;
  float* s_grad = s_buf + RH * RW;
  if (kStaged) {
    for (int i = threadIdx.x; i < kTileCross * kLineWords; i += kThreads)
      s_mask[i] = 0u;
    for (int i = threadIdx.x; i < RH * RW; i += kThreads) {
      const int gy = y0 - hy + i / RW;
      const int gx = x0 - hx + i % RW;
      const bool in = gy >= 0 && gy < S && gx >= 0 && gx < S;
      const size_t p = (size_t)gy * S + gx;
      s_alpha[i] = in ? alpha_b[p] : 0.0f;
      s_grad[i] = in ? grad_b[p] : 0.0f;
    }
    __syncthreads();
    // run masks: bit t of a line where alpha changes from position t - 1
    for (int i = threadIdx.x; i < RH * RW; i += kThreads) {
      const int line = axis == 0 ? i % RW : i / RW;
      const int t = axis == 0 ? i / RW : i % RW;
      if (t == 0 || s_alpha[i] != s_alpha[i - sstep])
        atomicOr(&s_mask[line * kLineWords + (t >> 5)], 1u << (t & 31));
    }
    __syncthreads();
  }

  const ptrdiff_t gstep = axis == 0 ? (ptrdiff_t)S : 1;
  // the pixel at tile position i; false where it lies outside the image
  auto locate = [&](int i, Pixel& P) -> bool {
    const int lx = i % TX;
    const int ly = i / TX;
    P.px = x0 + lx;
    P.py = y0 + ly;
    if (P.px >= S || P.py >= S) return false;
    P.pix = (size_t)P.py * S + P.px;
    P.f = fi_b[P.pix];
    P.w = axis == 0 ? P.py : P.px;      // the pixel's walk coordinate
    if (kStaged) {
      const int sidx = (ly + hy) * RW + (lx + hx);
      P.L.a = s_alpha + sidx;
      P.L.g = s_grad + sidx;
      P.L.step = sstep;
      P.L.mask = s_mask + (axis == 0 ? lx : ly) * kLineWords;
      P.L.t = (axis == 0 ? ly : lx) + n_steps;
    } else {
      P.L.a = alpha_b + P.pix;
      P.L.g = grad_b + P.pix;
      P.L.step = gstep;
      P.L.fwd_room = S - 1 - P.w;
      P.L.bwd_room = P.w;
    }
    P.a0 = P.L.a[0];
    // the global scan stays inside the image
    const int nf = kStaged ? n_steps : min(n_steps, P.L.fwd_room);
    const int nb = kStaged ? n_steps : min(n_steps, P.L.bwd_room);
    P.kf = P.f < 0 ? kBig : next_step<kStaged>(P.L, 1, 1, nf, P.a0);
    P.kb = P.f < 0 ? kBig : next_step<kStaged>(P.L, -1, 1, nb, P.a0);
    return true;
  };

  // pass 1: pixels that cannot walk write zeros; the others go on the
  // work list, a warp's walkers in one atomic
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < kTilePixels; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    Pixel P;
    bool walks = false;
    if (locate(i, P)) {
      walks = P.kf != kBig || P.kb != kBig;
      if (!walks) {
        float* o = out_b + P.pix;
        o[0] = 0.0f;
        o[plane] = 0.0f;
        o[2 * plane] = 0.0f;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, walks);
    int base = 0;
    if (lane == 0 && m != 0u) base = atomicAdd(&s_n_work, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (walks) s_work[base + __popc(m & ((1u << lane) - 1u))] = (uint16_t)i;
  }
  __syncthreads();

  // pass 2: each walking pixel on one lane, its steps in order
  const float last = (float)(S - 1);
  const int n_work = s_n_work;
  for (int j = threadIdx.x; j < n_work; j += kThreads) {
    Pixel P;
    locate(s_work[j], P);
    const Line& L = P.L;
    const float a0 = P.a0;
    const int w = P.w;
    int kf = P.kf, kb = P.kb;

    // the face's pixel-space vertices across (u) and along (v) the walk
    const float* q = pp_b + (size_t)P.f * 6;
    float u[3], v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = __ldg(q + 2 * c + (axis == 0 ? 0 : 1));
      v[c] = __ldg(q + 2 * c + (axis == 0 ? 1 : 0));
    }
    const float d0 = (float)(axis == 0 ? P.px : P.py);
    const float d1 = (float)w;
    Edge E[3];
    float uA[3], uB[3];
    int kmax_f = 0, kmax_b = 0;     // last step that can carry a term
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      E[e] = edge_invariants(u, v, d0, d1, S, axis, e);
      // IN-pass distances do not depend on k
      const float tA = E[e].kA * (d1 - E[e].d1c);
      uA[e] = tA > 0.0f ? tA + eps : tA - eps;
      const float tB = E[e].kB * (d1 - E[e].d1c);
      uB[e] = tB > 0.0f ? tB + eps : tB - eps;
      const bool pos = E[e].dir > 0.0f;
      int lim = 0;
      if (E[e].isin) lim = min(n_steps, pos ? S - 1 - w : w);
      if (E[e].jg >= 0.0f && E[e].jg + 1.0f <= (float)n_steps)
        lim = max(lim, (int)E[e].jg + 1);
      if (pos) kmax_f = max(kmax_f, lim);
      else kmax_b = max(kmax_b, lim);
    }
    if (kf > kmax_f) kf = kBig;
    if (kb > kmax_b) kb = kBig;

    const float g0 = L.g[0];
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (;;) {
      const int k = min(kf, kb);
      if (k == kBig) break;
      const float kf_ = (float)k;
      const ptrdiff_t off = k * L.step;
      float a_f, a_b, g_f, g_b;
      if (kStaged) {
        a_f = L.a[off];
        a_b = L.a[-off];
        g_f = L.g[off];
        g_b = L.g[-off];
      } else {
        const bool f_in = k <= L.fwd_room;
        const bool b_in = k <= L.bwd_room;
        a_f = f_in ? L.a[off] : 0.0f;
        a_b = b_in ? L.a[-off] : 0.0f;
        g_f = f_in ? L.g[off] : 0.0f;
        g_b = b_in ? L.g[-off] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const bool pos = E[e].dir > 0.0f;
        const float a_k = pos ? a_f : a_b;
        // OUT: contributions land at the in-boundary pixel
        const float d1k = d1 + E[e].dir * kf_;
        const bool in_seg = d1k >= 0.0f && d1k <= last;
        const float g_k = pos ? g_f : g_b;
        const float diff = (a_k - a0) * g_k;
        float gA = 0.0f, gB = 0.0f;
        if (E[e].isin && in_seg && diff > 0.0f) {
          float tA = E[e].kA * (d1k - E[e].d1c);
          tA = tA > 0.0f ? tA + eps : tA - eps;
          float tB = E[e].kB * (d1k - E[e].d1c);
          tB = tB > 0.0f ? tB + eps : tB - eps;
          if (E[e].kA != 0.0f) gA = diff / tA;
          if (E[e].kB != 0.0f) gB = diff / tB;
        }
        // IN: pixels at walk distance j = k-1 read their alpha_out (= a_k)
        const float diff_in = (a0 - a_k) * g0;
        float gA_in = 0.0f, gB_in = 0.0f;
        if (E[e].jg == kf_ - 1.0f && diff_in > 0.0f) {
          if (E[e].kA != 0.0f) gA_in = diff_in / uA[e];
          if (E[e].kB != 0.0f) gB_in = diff_in / uB[e];
        }
        const int i1 = e == 2 ? 0 : e + 1;
        acc[e] = (acc[e] + gA) + gA_in;
        acc[i1] = (acc[i1] + gB) + gB_in;
      }
      if (kf == k) kf = next_step<kStaged>(L, 1, k + 1, kmax_f, a0);
      if (kb == k) kb = next_step<kStaged>(L, -1, k + 1, kmax_b, a0);
    }
    float* o = out_b + P.pix;
    o[0] = acc[0];
    o[plane] = acc[1];
    o[2 * plane] = acc[2];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes: both axes in one launch into
// out [2, B, 3, S, S] (axis 0 first).  Launches on `stream` and returns
// the cudaError_t of the launch (0 = success); never synchronises.
extern "C" int sdn3d_walk_faces(const float* alpha, const float* grad,
                                const int* face_index, const float* pp,
                                float* out, int B, int S, int F, int n_steps,
                                float eps, void* stream) {
  if (B <= 0 || S <= 0 || F <= 0 || n_steps < 0 || 2 * B > 65535)
    return (int)cudaErrorInvalidValue;
  // the tile count is the same for both axes: ceil(S/32) * ceil(S/64)
  const int tiles = ((S + kTileCross - 1) / kTileCross) *
                    ((S + kTileWalk - 1) / kTileWalk);
  dim3 grid(tiles, 1, 2 * B);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_steps <= kMaxStagedSteps) {
    const size_t smem =
        (size_t)2 * (kTileWalk + 2 * n_steps) * kTileCross * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        walk_faces_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    walk_faces_kernel<true><<<grid, kThreads, smem, s>>>(
        alpha, grad, face_index, pp, out, B, S, F, n_steps, eps);
  } else {
    walk_faces_kernel<false><<<grid, kThreads, 0, s>>>(
        alpha, grad, face_index, pp, out, B, S, F, n_steps, eps);
  }
  return (int)cudaGetLastError();
}

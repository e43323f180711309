// Forward triangle rasterizer for Hopper (sm_90a): faces binned to tiles.
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
// the winner is the face f that covers the pixel (three edge functions
// >= 0), is front-facing, non-degenerate and valid, whose interpolated
// depth zp = 1 / (w0/z0 + w1/z1 + w2/z2) lies strictly inside (near, far),
// and whose pair (zp, f) is the lexicographic minimum over those faces.
// The plain version (ops/rasterize.py) walks the faces in ascending order
// and takes a face only on a strictly smaller depth, which picks the lowest
// index among equal depths: the same face.  The rule needs no order, so the
// order of the faces in a tile's list (set by atomics) cannot change a bit.
//
// Bit-equality with the plain version needs the same IEEE operations in the
// same order: the build passes -fmad=false (no a*b+c contraction, which
// would flip boundary pixels) and keeps IEEE division (no
// --use_fast_math).  Per-face quantities (barycentric inverse, the
// front/valid/non-degenerate flag) come from the shared PyTorch pre-pass
// (`face_records`), so both versions start from the same bits.
//
// Each face is an 80-byte record: x0 y0 x1 y1 x2 y2 z0 z1 z2, the 3x3
// barycentric inverse, the ok flag and a pad (the flag again), so that a
// record is five 16-byte pieces.
//
// What bounds it on the H100: neither the bytes (the outputs, at most 20 B
// per pixel, are written once) nor the edge tests of the face x pixel
// pairs that overlap, but finding, for each tile, the faces that may cover
// it.  The design:
//   * bin (three small kernels): one thread per face computes the face's
//     conservative pixel box, with the formula and operation order of the
//     PyTorch `face_boxes` (ops/rasterize_cuda.py), counts the 16x16 tiles
//     the box touches, an exclusive scan per image turns the counts into
//     list offsets, and the faces are scattered into the tiles' lists
//     through atomic slots.  A face whose box touches more than K tiles
//     (whole-image slivers: the box is widened by an error bound of the
//     rounded edge tests) goes to its image's wide list instead, which every
//     tile walks.  An image's lists then hold at most F*K entries, so the
//     wrapper sizes the buffers from the shapes alone: no count is read back
//     to the host.
//   * raster (one block per tile, one thread per pixel): the block walks its
//     tile's list and the wide list in chunks of 64 faces, staged (record
//     and box) into a double-buffered shared-memory ring with cp.async
//     16-byte copies, so the gather of chunk k+1 overlaps the edge tests of
//     chunk k.  Each warp (two rows of the tile) then tests only the faces
//     whose box meets its rows: a ballot over the chunk's boxes gives the
//     warp one bit mask, and its lanes loop over the set bits together, so
//     the cull costs no divergence.  A lane notes the faces it lies inside
//     in a 64-bit mask and then interpolates the depth of those faces only:
//     the seven IEEE divisions of a depth run once per covering (pixel,
//     face), not once per warp and face.  TMA's tiled copies do not fit a
//     gather of scattered records, and tensor cores do not apply: the edge
//     tests and depths are scalar fp32 that must keep their exact bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                 // 16 x 16 pixels per tile
constexpr int kThreads = kTile * kTile;   // one pixel per thread
constexpr int kRec = 20;                  // floats per face record (80 B)
constexpr int kRec4 = kRec / 4;           // 16-byte pieces per record
constexpr int kOk = 18;                   // the ok flag's slot in a record
constexpr int kChunk = 64;                // faces per ring slot
static_assert(kChunk <= 64, "a lane's candidates are a 64-bit mask");
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;

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

// The face's inclusive pixel box (x_lo, x_hi, y_lo, y_hi), empty as
// (S, -1, S, -1): `face_boxes` in ops/rasterize_cuda.py, one IEEE operation
// at a time in its order.  Every intermediate of a kept face is finite or
// +-inf, never NaN (the where(cross > 0) guards the division), so plain
// min/max give torch's amin/amax/clamp.
__device__ __forceinline__ int4 face_box(const float4 r0, const float4 r1,
                                         bool ok, int S) {
  const float x0 = r0.x, y0 = r0.y, x1 = r0.z, y1 = r0.w, x2 = r1.x,
              y2 = r1.y;
  const bool finite = isfinite(x0) && isfinite(y0) && isfinite(x1) &&
                      isfinite(y1) && isfinite(x2) && isfinite(y2);
  if (!(ok && finite)) return make_int4(S, -1, S, -1);
  const float e1x = x1 - x0, e1y = y1 - y0;
  const float e2x = x2 - x0, e2y = y2 - y0;
  const float e3x = x2 - x1, e3y = y2 - y1;
  const float p0 = e1x * e2y, p1 = e1y * e2x;
  // 8u = 2^-21; 8u * 1.5 = 1.5 * 2^-21; pi rounded to float32
  const float cross =
      fabsf(p0 - p1) - 4.76837158203125e-07f * (fabsf(p0) + fabsf(p1));
  const float l1 = e1x * e1x + e1y * e1y;
  const float l2 = e2x * e2x + e2y * e2y;
  const float l3 = e3x * e3x + e3y * e3y;
  const float longest = fmaxf(fmaxf(l1, l2), l3);
  const float big = fmaxf(fmaxf(fmaxf(fabsf(x0), fabsf(y0)),
                                fmaxf(fabsf(x1), fabsf(y1))),
                          fmaxf(fabsf(x2), fabsf(y2)));
  const float d = 7.152557373046875e-07f * (1.0f + big);
  const float disp = (cross > 0.0f)
                         ? 3.14159265358979323846f * d * longest / cross
                         : __int_as_float(0x7f800000);  // +inf
  const float fS = (float)S;
  const float margin = fminf(disp * (0.5f * fS), 2.0f * fS) + 2.0f;
  const float qx0 = ((x0 + 1.0f) * fS - 1.0f) * 0.5f;
  const float qy0 = ((y0 + 1.0f) * fS - 1.0f) * 0.5f;
  const float qx1 = ((x1 + 1.0f) * fS - 1.0f) * 0.5f;
  const float qy1 = ((y1 + 1.0f) * fS - 1.0f) * 0.5f;
  const float qx2 = ((x2 + 1.0f) * fS - 1.0f) * 0.5f;
  const float qy2 = ((y2 + 1.0f) * fS - 1.0f) * 0.5f;
  const float lox = floorf(fminf(fminf(qx0, qx1), qx2) - margin);
  const float loy = floorf(fminf(fminf(qy0, qy1), qy2) - margin);
  const float hix = ceilf(fmaxf(fmaxf(qx0, qx1), qx2) + margin);
  const float hiy = ceilf(fmaxf(fmaxf(qy0, qy1), qy2) + margin);
  return make_int4((int)fminf(fmaxf(lox, 0.0f), fS),
                   (int)fminf(fmaxf(hix, -1.0f), fS - 1.0f),
                   (int)fminf(fmaxf(loy, 0.0f), fS),
                   (int)fminf(fmaxf(hiy, -1.0f), fS - 1.0f));
}

// Tiles a non-empty box touches: columns [tx0, tx1], rows [ty0, ty1].
struct TileRange {
  int tx0, tx1, ty0, ty1;
  __device__ int count() const { return (tx1 - tx0 + 1) * (ty1 - ty0 + 1); }
};

__device__ __forceinline__ bool box_empty(int4 bb) {
  return bb.x > bb.y || bb.z > bb.w;
}

__device__ __forceinline__ TileRange tile_range(int4 bb) {
  return {bb.x / kTile, bb.y / kTile, bb.z / kTile, bb.w / kTile};
}

// Bin pass 1: each face's box (written out), then one count per touched
// tile, or a slot in the wide list.  counts [B, T + 1] starts at 0; its
// last column is the image's wide-list length.
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const float4* __restrict__ rec,   // [B, F, 5] (float4)
                 int B, int F, int S, int K, int tiles,
                 int4* __restrict__ box_out,       // [B, F]
                 int* __restrict__ counts,         // [B, T + 1]
                 int* __restrict__ wide_faces) {   // [B, F]
  const long long g = (long long)blockIdx.x * kBinThreads + threadIdx.x;
  if (g >= (long long)B * F) return;
  const int b = (int)(g / F);
  const int f = (int)(g - (long long)b * F);
  const float4 r4 = rec[g * kRec4 + kOk / 4];
  const int4 bb = face_box(rec[g * kRec4], rec[g * kRec4 + 1],
                           r4.z != 0.0f, S);
  box_out[g] = bb;
  if (box_empty(bb)) return;
  const TileRange tr = tile_range(bb);
  const int T = tiles * tiles;
  int* cnt = counts + (size_t)b * (T + 1);
  if (tr.count() > K) {
    const int slot = atomicAdd(cnt + T, 1);
    wide_faces[(size_t)b * F + slot] = f;
    return;
  }
  for (int ty = tr.ty0; ty <= tr.ty1; ++ty)
    for (int tx = tr.tx0; tx <= tr.tx1; ++tx) atomicAdd(cnt + ty * tiles + tx, 1);
}

// Bin pass 2: per image (one block), tile_off[b, t] = sum of counts[b, :t]
// for t <= T.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(const int* __restrict__ counts, int T,
                int* __restrict__ tile_off) {
  __shared__ int s_warp[kScanThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int* c = counts + (size_t)blockIdx.x * (T + 1);
  int* o = tile_off + (size_t)blockIdx.x * (T + 1);
  const int per = (T + kScanThreads - 1) / kScanThreads;
  const int i0 = min(t * per, T);
  const int i1 = min(i0 + per, T);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += c[i];
  int v = local;                                  // inclusive warp scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += n;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int run = v - local + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (t == kScanThreads - 1) o[T] = s_warp[kScanThreads / 32 - 1];
}

// Bin pass 3: scatter each listed face into its tiles' lists; the counts
// of pass 1 count down to 0 as the slots are taken (the wide column stays).
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const int4* __restrict__ box,      // [B, F]
                   int B, int F, int K, int tiles,
                   const int* __restrict__ tile_off,  // [B, T + 1]
                   int* __restrict__ counts,          // [B, T + 1]
                   int* __restrict__ tile_faces) {    // [B, F * K]
  const long long g = (long long)blockIdx.x * kBinThreads + threadIdx.x;
  if (g >= (long long)B * F) return;
  const int4 bb = box[g];
  if (box_empty(bb)) return;
  const TileRange tr = tile_range(bb);
  if (tr.count() > K) return;
  const int b = (int)(g / F);
  const int f = (int)(g - (long long)b * F);
  const int T = tiles * tiles;
  const size_t row = (size_t)b * (T + 1);
  int* list = tile_faces + (size_t)b * F * K;
  for (int ty = tr.ty0; ty <= tr.ty1; ++ty)
    for (int tx = tr.tx0; tx <= tr.tx1; ++tx) {
      const int t = ty * tiles + tx;
      const int slot = atomicSub(counts + row + t, 1) - 1;
      list[tile_off[row + t] + slot] = f;
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Gather faces [c * kChunk, (c + 1) * kChunk) of the block's walk (its
// tile's list, then the wide list) into one ring slot: the face indices
// with plain stores, each face's record (five 16-byte pieces) and pixel box
// (one) with cp.async, in one commit group.
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ rec_b, const int4* __restrict__ box_b,
    const int* __restrict__ list, const int* __restrict__ wide, int n_tile,
    int n, int c, float* __restrict__ s_rec, int4* __restrict__ s_box,
    int* __restrict__ s_idx) {
  for (int i = threadIdx.x; i < kChunk * (kRec4 + 1); i += kThreads) {
    const int k = i / (kRec4 + 1);
    const int j = i - k * (kRec4 + 1);
    const int g = c * kChunk + k;
    if (g < n) {
      const int f = g < n_tile ? list[g] : wide[g - n_tile];
      if (j == kRec4) {
        s_idx[k] = f;
        cp_async16(s_box + k, box_b + f);
      } else {
        cp_async16(s_rec + k * kRec + j * 4, rec_b + (size_t)f * kRec + j * 4);
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
raster_binned_kernel(const float* __restrict__ rec,        // [B, F, 20]
                     const int4* __restrict__ box,         // [B, F]
                     const int* __restrict__ tile_off,     // [B, T + 1]
                     const int* __restrict__ tile_faces,   // [B, F * K]
                     const int* __restrict__ wide_n,       // [B] (stride)
                     int wide_stride,
                     const int* __restrict__ wide_faces,   // [B, F]
                     const float* __restrict__ colors,     // [B, F, 3] or null
                     int F, int S, int K, float near_z, float far_z,
                     int* __restrict__ fi_out,             // [B, S, S]
                     float* __restrict__ depth_out,        // [B, S, S]
                     float* __restrict__ rgb_out) {        // [B, 3, S, S] or null
  __shared__ __align__(16) float s_rec[2][kChunk * kRec];
  __shared__ __align__(16) int4 s_box[2][kChunk];
  __shared__ int s_idx[2][kChunk];

  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int tiles = gridDim.x;
  const int T = tiles * tiles;
  const int tile = blockIdx.y * tiles + blockIdx.x;
  const int tx0 = blockIdx.x * kTile;
  const int px = tx0 + (t % kTile);
  const int py = blockIdx.y * kTile + (t / kTile);
  const int wy0 = blockIdx.y * kTile + (t >> 5) * (32 / kTile);  // warp's rows
  const bool active = px < S && py < S;   // ragged tile edge

  const size_t row = (size_t)b * (T + 1);
  const int off = tile_off[row + tile];
  const int n_tile = tile_off[row + tile + 1] - off;
  const int n = n_tile + wide_n[(size_t)b * wide_stride];
  const int* list = tile_faces + (size_t)b * F * K + off;
  const int* wide = wide_faces + (size_t)b * F;
  const float* rec_b = rec + (size_t)b * F * kRec;
  const int4* box_b = box + (size_t)b * F;

  const float fS = (float)S;
  const float XP = (2.0f * (float)px + 1.0f - fS) / fS;
  const float YP = (2.0f * (float)py + 1.0f - fS) / fS;
  const float XI = (float)px;
  const float YI = (float)py;

  float best_z = far_z;
  int best = -1;

  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0)
    stage_chunk(rec_b, box_b, list, wide, n_tile, n, 0, s_rec[0], s_box[0],
                s_idx[0]);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage_chunk(rec_b, box_b, list, wide, n_tile, n, c + 1, s_rec[buf ^ 1],
                  s_box[buf ^ 1], s_idx[buf ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m = min(kChunk, n - c * kChunk);
    // each warp tests only the chunk's faces whose box meets its two rows
    // of the tile: a ballot over the staged boxes, then a loop over the
    // set bits that every lane of the warp takes alike; a lane notes the
    // faces it lies inside in a 64-bit mask
    unsigned long long cand = 0ull;
    for (int h = 0; h < m; h += 32) {
      bool meets = false;
      if (h + lane < m) {
        const int4 bb = s_box[buf][h + lane];
        meets = bb.x <= tx0 + kTile - 1 && bb.y >= tx0 &&
                bb.z <= wy0 + 32 / kTile - 1 && bb.w >= wy0;
      }
      unsigned bits = __ballot_sync(0xffffffffu, meets);
      while (bits != 0u) {
        const int k = h + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float* fd = s_rec[buf] + k * kRec;
        const float x0 = fd[0], y0 = fd[1], x1 = fd[2], y1 = fd[3];
        const float x2 = fd[4], y2 = fd[5];
        const bool inside = ((YP - y0) * (x1 - x0) >= (XP - x0) * (y1 - y0)) &
                            ((YP - y1) * (x2 - x1) >= (XP - x1) * (y2 - y1)) &
                            ((YP - y2) * (x0 - x2) >= (XP - x2) * (y0 - y2));
        cand |= (unsigned long long)inside << k;
      }
    }
    // then interpolates the depth of its own faces only, so the divisions
    // run once per covering (pixel, face) and not once per warp and face
    while (cand != 0ull) {
      const int k = __ffsll((long long)cand) - 1;
      cand &= cand - 1ull;
      const float* fd = s_rec[buf] + k * kRec;
      float w0 = clamp01(fd[9] * XI + fd[10] * YI + fd[11]);
      float w1 = clamp01(fd[12] * XI + fd[13] * YI + fd[14]);
      float w2 = clamp01(fd[15] * XI + fd[16] * YI + fd[17]);
      const float ws = clamp_min_eps(w0 + w1 + w2);
      w0 = w0 / ws;
      w1 = w1 / ws;
      w2 = w2 / ws;
      const float zp = 1.0f / (w0 / fd[6] + w1 / fd[7] + w2 / fd[8]);
      const int f = s_idx[buf][k];
      // lexicographic minimum of (zp, f): order-free
      if (zp > near_z && zp < far_z &&
          (zp < best_z || (zp == best_z && f < best))) {
        best_z = zp;
        best = f;
      }
    }
    __syncthreads();   // slot `buf` is refilled by the next iteration's stage
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

// Plain C entry points, bound with ctypes.  Each launches on `stream` and
// returns the cudaError_t of its launches (0 = success); never synchronises.

// counts [B, T + 1] must be 0; T = ceil(S / 16)^2.  Writes box [B, F, 4],
// tile_off [B, T + 1], tile_faces [B, F * K] (image b's list of tile t at
// [b, tile_off[b, t] : tile_off[b, t + 1]]), counts[:, T] (wide-list
// lengths; the other columns end at 0) and wide_faces [B, F].
extern "C" int sdn3d_bin_faces(const float* rec, int B, int F, int S, int K,
                               int* box, int* counts, int* tile_off,
                               int* tile_faces, int* wide_faces,
                               void* stream) {
  if (B <= 0 || F < 0 || S <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (S + kTile - 1) / kTile;
  const long long n = (long long)B * F;
  const unsigned blocks = (unsigned)((n + kBinThreads - 1) / kBinThreads);
  if (n > 0) {
    bin_count_kernel<<<blocks, kBinThreads, 0, st>>>(
        reinterpret_cast<const float4*>(rec), B, F, S, K, tiles,
        reinterpret_cast<int4*>(box), counts, wide_faces);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bin_scan_kernel<<<B, kScanThreads, 0, st>>>(counts, tiles * tiles, tile_off);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  bin_scatter_kernel<<<blocks, kBinThreads, 0, st>>>(
      reinterpret_cast<const int4*>(box), B, F, K, tiles, tile_off, counts,
      tile_faces);
  return (int)cudaGetLastError();
}

extern "C" int sdn3d_raster_binned(const float* rec, const int* box,
                                   const int* tile_off,
                                   const int* tile_faces, const int* wide_n,
                                   int wide_stride, const int* wide_faces,
                                   const float* colors, int B, int F, int S,
                                   int K, float near_z, float far_z,
                                   int* fi_out, float* depth_out,
                                   float* rgb_out, void* stream) {
  if (B <= 0 || F < 0 || S <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (S + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, B);
  raster_binned_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rec, reinterpret_cast<const int4*>(box), tile_off, tile_faces, wide_n,
      wide_stride, wide_faces, colors, F, S, K, near_z, far_z, fi_out,
      depth_out, rgb_out);
  return (int)cudaGetLastError();
}

// Edit-time textural conditioning for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds this conditioning on the
// host with numpy, frame by frame (sdn3d_tpu/cli/edit_vkitti.py
// `assemble_edit_conditioning` over sdn3d_tpu/data/textural_data.py
// `assemble_condition_maps` and `dense_instance_slots`), and so did the
// port before this kernel: ~12 ms of host a 192x624 frame while the card
// waited.  The plain PyTorch twin is `edit_conditioning_plain`
// (sdn3d_tpu_torch/ops/edit_conditioning.py); the two agree bit for bit,
// every output being integers or copied floats.
//
// Inputs of frame n: its raw instance plane (uint8, object index k, 0 =
// background), its source's transformed label plane (uint8 raw ids), the
// frame's object table (256 label overrides, 0 = none, then 256 pose
// bins, indexed by k; built on the host from the frame's JSON) and its
// source's code table (256 rows of feat_num floats, one per raw label
// value: the source's feature-means row of that value's slot, zeros where
// the source gives it none).  The generator reads the raw instance plane
// itself (fake_inference rebuilds k * 1000 from it and the label).
//
// One block per frame, two passes over its pixels with a barrier between:
//
//   pass 1  label = raw + 1, with 2 and 12 (car, van) set to 5, then the
//           object table's override; pose from the table.  The label is
//           stored as uint8, as the JAX package uploads it too: a raw 255
//           gives label 256, stored as 0.  Each pixel's id (k *
//           1000 at instance pixels, the label elsewhere) marks its bit in
//           a 512-bit map in shared memory, in np.unique's order: label
//           values 1..256 at bits 1..256, then k * 1000 at bit 256 + k.  A
//           thread sets a bit by atomicOr only after reading it clear, so
//           the atomics come from the first pixels of each id; OR
//           commutes, so the map is the same on every launch.
//   prefix  thread 0 sums the 16 words' popcounts: each id's rank is the
//           prefix of its word plus the popcount of its word below it.
//   pass 2  the id again from k and the stored label (a label is at least
//           1, so a stored 0 is 256), then inst_slots = the rank of the
//           pixel's id, 0 for ranks >= max_instances (where
//           dense_instance_slots leaves the overflow ids), and the frame's
//           [max_instances, feat_num] code table: the slot of rank r takes
//           the source row of the r-th present id when that id is a raw
//           label value (0..255), zeros otherwise, as the host assembly's
//           loop matches target ids to source ids.  nids[n] is the number
//           of distinct ids (the host warns above max_instances).
//
// Each thread revisits in pass 2 the pixels it wrote in pass 1, so it
// reads back its own stores.  Four pixels a step (uchar4) where the
// plane's size and the pointers allow.
//
// What bounds it on the H100: bytes, 7 a pixel (pass 1 reads two planes
// and writes two, pass 2 reads two and writes one), ~0.84 MB a 192x624
// frame, on one SM a frame; the batch's N frames run on N SMs.  Tens of
// microseconds a launch against the milliseconds of host numpy it
// replaces: the design keeps the host out (one launch a chunk, no fetch),
// not the SMs busy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTable = 256;          // object-table entries a frame (k)
constexpr int kCodes = 256;          // code-table rows a source (raw ids)
constexpr int kWords = 512 / 32;     // the id presence map

// the bit of a pixel's id: label values 1..256 as they are, k * 1000 at
// 256 + k
__device__ __forceinline__ int id_bit(int k, int label) {
  return k != 0 ? 256 + k : label;
}

// pass 1 of one pixel: its label (1..256) and pose; marks its id present
__device__ __forceinline__ void assemble(int k, int raw, const uint8_t* tab,
                                         unsigned* bits, uint8_t& label,
                                         uint8_t& pose) {
  int segm = raw + 1;
  if (segm == 2 || segm == 12) segm = 5;
  const int over = tab[k];
  if (over != 0) segm = over;
  label = (uint8_t)segm;
  pose = tab[kTable + k];
  const int b = id_bit(k, segm);
  const unsigned m = 1u << (b & 31);
  if (!(bits[b >> 5] & m)) atomicOr(&bits[b >> 5], m);
}

// pass 2 of one pixel: the dense slot of its id
__device__ __forceinline__ uint8_t slot_of(int k, int label,
                                           const unsigned* bits,
                                           const int* prefix, int M) {
  const int b = id_bit(k, label != 0 ? label : 256);
  const int w = b >> 5;
  const int r = prefix[w] + __popc(bits[w] & ((1u << (b & 31)) - 1u));
  return (uint8_t)(r < M ? r : 0);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conditioning_kernel(const uint8_t* __restrict__ inst,       // [N, P]
                    const uint8_t* __restrict__ src_label,  // [S, P]
                    const int* __restrict__ src_index,      // [N]
                    const uint8_t* __restrict__ tables,     // [N, 2, 256]
                    const float* __restrict__ codes,        // [S, 256, F]
                    int S, int P, int M, int F,
                    uint8_t* __restrict__ label,            // [N, P]
                    uint8_t* __restrict__ pose,             // [N, P]
                    uint8_t* __restrict__ slots,            // [N, P]
                    float* __restrict__ feat,               // [N, M, F]
                    int* __restrict__ nids) {               // [N]
  __shared__ uint8_t s_tab[2 * kTable];
  __shared__ unsigned s_bits[kWords];
  __shared__ int s_prefix[kWords + 1];
  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int s = src_index[n];
  if (s < 0 || s >= S) {               // the whole block leaves together
    if (t == 0) nids[n] = -1;
    return;
  }
  for (int i = t; i < 2 * kTable; i += kThreads)
    s_tab[i] = tables[(size_t)n * 2 * kTable + i];
  if (t < kWords) s_bits[t] = 0u;
  __syncthreads();

  const size_t off = (size_t)n * P;
  const uint8_t* in = inst + off;
  const uint8_t* raw = src_label + (size_t)s * P;
  uint8_t* lab = label + off;
  uint8_t* pos = pose + off;
  uint8_t* slo = slots + off;

  if (kVec) {
    const int Q = P / 4;
    for (int q = t; q < Q; q += kThreads) {
      const uchar4 k4 = reinterpret_cast<const uchar4*>(in)[q];
      const uchar4 r4 = reinterpret_cast<const uchar4*>(raw)[q];
      uchar4 l4, p4;
      assemble(k4.x, r4.x, s_tab, s_bits, l4.x, p4.x);
      assemble(k4.y, r4.y, s_tab, s_bits, l4.y, p4.y);
      assemble(k4.z, r4.z, s_tab, s_bits, l4.z, p4.z);
      assemble(k4.w, r4.w, s_tab, s_bits, l4.w, p4.w);
      reinterpret_cast<uchar4*>(lab)[q] = l4;
      reinterpret_cast<uchar4*>(pos)[q] = p4;
    }
  } else {
    for (int p = t; p < P; p += kThreads)
      assemble(in[p], raw[p], s_tab, s_bits, lab[p], pos[p]);
  }
  __syncthreads();
  if (t == 0) {
    int acc = 0;
    for (int w = 0; w < kWords; ++w) {
      s_prefix[w] = acc;
      acc += __popc(s_bits[w]);
    }
    s_prefix[kWords] = acc;
    nids[n] = acc;
  }
  __syncthreads();

  if (kVec) {
    const int Q = P / 4;
    for (int q = t; q < Q; q += kThreads) {
      const uchar4 k4 = reinterpret_cast<const uchar4*>(in)[q];
      const uchar4 l4 = reinterpret_cast<const uchar4*>(lab)[q];
      uchar4 s4;
      s4.x = slot_of(k4.x, l4.x, s_bits, s_prefix, M);
      s4.y = slot_of(k4.y, l4.y, s_bits, s_prefix, M);
      s4.z = slot_of(k4.z, l4.z, s_bits, s_prefix, M);
      s4.w = slot_of(k4.w, l4.w, s_bits, s_prefix, M);
      reinterpret_cast<uchar4*>(slo)[q] = s4;
    }
  } else {
    for (int p = t; p < P; p += kThreads)
      slo[p] = slot_of(in[p], lab[p], s_bits, s_prefix, M);
  }

  const int count = s_prefix[kWords];
  const float* rows = codes + (size_t)s * kCodes * F;
  float* out = feat + (size_t)n * M * F;
  for (int i = t; i < M * F; i += kThreads) {
    const int r = i / F;
    const int c = i - r * F;
    float v = 0.0f;
    if (r < count) {
      int w = 0;
      while (s_prefix[w + 1] <= r) ++w;
      unsigned word = s_bits[w];
      for (int j = r - s_prefix[w]; j > 0; --j) word &= word - 1u;
      const int b = w * 32 + __ffs(word) - 1;
      if (b < kCodes) v = rows[(size_t)b * F + c];
    }
    out[i] = v;
  }
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` and
// returns the cudaError_t of the launch (0 = success); never synchronises.
// A frame whose src_index is outside [0, S) gets nids -1 and no outputs.
extern "C" int sdn3d_edit_conditioning(
    const uint8_t* inst, const uint8_t* src_label, const int* src_index,
    const uint8_t* tables, const float* codes, int N, int S, int P, int M,
    int F, uint8_t* label, uint8_t* pose, uint8_t* slots, float* feat,
    int* nids, void* stream) {
  if (N <= 0 || S <= 0 || P <= 0 || M <= 0 || M > 256 || F <= 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = P % 4 == 0 && aligned4(inst) && aligned4(src_label) &&
                   aligned4(label) && aligned4(pose) && aligned4(slots);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    conditioning_kernel<true><<<N, kThreads, 0, st>>>(
        inst, src_label, src_index, tables, codes, S, P, M, F, label, pose,
        slots, feat, nids);
  else
    conditioning_kernel<false><<<N, kThreads, 0, st>>>(
        inst, src_label, src_index, tables, codes, S, P, M, F, label, pose,
        slots, feat, nids);
  return (int)cudaGetLastError();
}

"""Wrappers of the port's CUDA kernels (csrc/*.cu).

  rasterize.cu           forward rasterizer      rasterize_face_index
                         (bin_faces_cuda, then raster_binned_cuda)
  silhouette_walk.cu     silhouette edge walk    walk_grads
  segment_face_grads.cu  pixel->face reduction   segment_face_grads
                         (won_pixel_boxes_cuda, then the sums)
  edit_conditioning.cu   textural conditioning   ops/edit_conditioning

Each dispatcher runs on the device of its input: for a CPU tensor the
plain PyTorch version (ops/rasterize.py); for a CUDA tensor it launches the
kernel or raises.  There is no fallback from one to the other.  Each
`*_cuda` launcher counts its launches in `.launches`.

The kernels are built at first use with nvcc (route (b): plain C entry
points loaded with ctypes) into `sdn3d_tpu_torch/_build/`, each library
named by a hash of its source and flags so an edited source is never
served stale.  `build()` compiles several sources in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from sdn3d_tpu_torch.ops import rasterize as R

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("rasterize", "silhouette_walk", "segment_face_grads",
           "edit_conditioning")
# -fmad=false: no a*b+c contraction (it flips boundary pixels and walk
# terms against the plain versions); IEEE division stays on (no
# --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
TILE = 16            # pixels per tile side; kTile in rasterize.cu
# K: a face whose box touches more tiles goes to its image's wide list, so
# an image's tile lists hold at most F * K entries (whole-image slivers
# exist; see face_boxes)
MAX_TILES = 64
RECORD = 20          # floats per face record (80 B); kRec in rasterize.cu

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes argument types of each source's entry points
_ENTRY = {
    "rasterize": {
        "sdn3d_bin_faces": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        "sdn3d_raster_binned": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                _I, _F, _F, _P, _P, _P, _P],
    },
    "silhouette_walk": {
        "sdn3d_walk_faces": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "segment_face_grads": {
        "sdn3d_won_pixel_boxes": [_P, _I, _I, _I, _I, _P, _P],
        "sdn3d_segment_face_grads": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    },
    "edit_conditioning": {
        "sdn3d_edit_conditioning": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P, _P, _P, _P, _P, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
build_seconds: Dict[str, float] = {}   # nvcc wall time of each fresh build
build_log: Dict[str, str] = {}         # compiler output (ptxas -v report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


def library_path(name: str) -> str:
    """_build/lib{name}_{hash of source and flags}.so"""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile csrc/{name}.cu for each name into a shared library (once
    per source and flags hash), one nvcc process per source, all started
    together.  Returns {name: library path}.  The compiler's output, with
    ptxas' register / shared-memory / spill report, is kept in
    `build_log[name]`."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
             os.path.join(CSRC_DIR, f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu: nvcc failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load(name: str = "rasterize") -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build([name])[name])
            for entry, argtypes in _ENTRY[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def _launch(name: str, entry: str, *args) -> None:
    err = getattr(_load(name), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{name}.cu {entry} launch failed: cudaError {err}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def face_records(faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                 image_size: int) -> torch.Tensor:
    """PyTorch pre-pass of the forward kernel: [B, F, 20] f32 records
    x0 y0 x1 y1 x2 y2 z0 z1 z2, the 3x3 barycentric inverse (row-major),
    both from `rasterize.face_setup`, and the ok flag (1.0 front-facing,
    non-degenerate and valid, else 0.0) twice, the second copy padding the
    record to 80 B (five 16-byte pieces)."""
    faces, inv, ok = R.face_setup(faces, face_valid, image_size)
    B, F = faces.shape[:2]
    okf = ok.to(torch.float32)[..., None]
    return torch.cat([faces[..., :2].reshape(B, F, 6), faces[..., 2],
                      inv.reshape(B, F, 9), okf, okf], dim=-1).contiguous()


def face_boxes(records: torch.Tensor, image_size: int) -> torch.Tensor:
    """Each face's inclusive pixel box [B, F, 4] i32 (x_lo, x_hi, y_lo,
    y_hi) from its record: the plain version of the bin kernel's box
    (rasterize.cu `face_box`, which repeats these operations in order).
    Empty (S, -1, S, -1) for faces the plain rasterizer rejects outright
    (ok flag 0: back-facing, degenerate, invalid) and non-finite ones.

    The box is a cull and must never exclude a pixel the plain version's
    inside test accepts, and float rounding lets that test accept points
    outside the triangle.  Each edge test compares two rounded products
    of magnitude <= D * L (D: distance from a vertex to the pixel centre,
    L: the edge's length), so it errs by < 6u D L (u = 2^-24): the
    accepted set lies inside the triangle with every edge pushed out by
    d = 6u D.  That moves a vertex of angle theta by d / sin(theta / 2) <=
    pi d L_max^2 / cross (sin theta >= cross / L_max^2), which is what the
    box is widened by, plus 2 px.  A sliver thus gets a wide box, and a
    face whose cross product may be 0 the whole image."""
    S = image_size
    B, F = records.shape[:2]
    xy = records[..., :6].reshape(B, F, 3, 2)
    ok = records[..., 18] != 0
    u = 2.0 ** -24
    e1 = xy[:, :, 1] - xy[:, :, 0]
    e2 = xy[:, :, 2] - xy[:, :, 0]
    e3 = xy[:, :, 2] - xy[:, :, 1]
    prods = torch.stack([e1[..., 0] * e2[..., 1], e1[..., 1] * e2[..., 0]])
    # a lower bound of |cross| (its own rounding and that of e1, e2)
    cross = (prods[0] - prods[1]).abs() - 8 * u * prods.abs().sum(0)
    longest = torch.stack([(e * e).sum(-1) for e in (e1, e2, e3)], -1).amax(-1)
    big = xy.abs().amax(dim=(2, 3))                             # max |coord|
    d = 8 * u * 1.5 * (1.0 + big)            # > 6u * sqrt(2) * (1 + |coord|)
    disp = torch.where(cross > 0, torch.pi * d * longest / cross,
                       torch.full_like(cross, float("inf")))
    margin = torch.clamp(disp * (0.5 * S), max=2.0 * S) + 2.0   # pixels
    pix = ((xy + 1.0) * S - 1.0) * 0.5                          # pixel coords
    lo = torch.floor(pix.amin(dim=2) - margin[..., None])       # [B, F, 2]
    hi = torch.ceil(pix.amax(dim=2) + margin[..., None])
    lo = torch.clamp(lo, 0.0, float(S)).to(torch.int32)
    hi = torch.clamp(hi, -1.0, float(S - 1)).to(torch.int32)
    keep = ok & torch.isfinite(xy).all(dim=-1).all(dim=-1)
    lo = torch.where(keep[..., None], lo, torch.full_like(lo, S))
    hi = torch.where(keep[..., None], hi, torch.full_like(hi, -1))
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                       dim=-1).contiguous()


def pack_faces(faces: torch.Tensor, face_valid: Optional[torch.Tensor],
               image_size: int):
    """(records [B, F, 20], boxes [B, F, 4]): `face_records` and the
    PyTorch `face_boxes` of them, the boxes the bin kernel computes."""
    rec = face_records(faces, face_valid, image_size)
    return rec, face_boxes(rec, image_size)


class Bins(NamedTuple):
    """Faces binned to 16x16 tiles (T tiles per image, row-major), as the
    bin kernel writes them and `bin_faces_plain` builds them.

    box        [B, F, 4] i32 each face's pixel box (`face_boxes`);
    tile_off   [B, T + 1] i32 image b's list of tile t is
               tile_faces[b, tile_off[b, t]:tile_off[b, t + 1]];
    tile_faces [B, F * K] i32;
    wide_n     [B] i32 wide-list lengths;
    wide_faces [B, F] i32 image b's wide list is wide_faces[b, :wide_n[b]].
    A face is listed in every tile its box touches, or, when that is more
    than K tiles, once in its image's wide list, which every tile walks.
    Entries past a list's end are undefined on the card (-1 in the plain
    version); the kernel's lists are in no particular order."""
    box: torch.Tensor
    tile_off: torch.Tensor
    tile_faces: torch.Tensor
    wide_n: torch.Tensor
    wide_faces: torch.Tensor


def tile_grid(image_size: int) -> int:
    """Tiles per image side."""
    return -(-image_size // TILE)


def bin_faces_plain(box: torch.Tensor, image_size: int) -> Bins:
    """The plain version of the bin kernel: each face's tiles from its box
    [B, F, 4] (`face_boxes`), lists in ascending face order."""
    B, F = box.shape[:2]
    tiles = tile_grid(image_size)
    dev = box.device
    empty = (box[..., 0] > box[..., 1]) | (box[..., 2] > box[..., 3])
    t_lo, t_hi = box[..., 0::2] // TILE, box[..., 1::2] // TILE   # x, y
    n = ((t_hi - t_lo + 1).clamp(min=0).prod(-1)) * ~empty
    wide = n > MAX_TILES
    listed = ~empty & ~wide
    ti = torch.arange(tiles, device=dev)
    # [B, F, tiles]: the tile columns / rows each box touches
    in_x = (t_lo[..., 0, None] <= ti) & (ti <= t_hi[..., 0, None])
    in_y = (t_lo[..., 1, None] <= ti) & (ti <= t_hi[..., 1, None])
    member = (in_y[:, :, :, None] & in_x[:, :, None, :]
              & listed[..., None, None]).reshape(B, F, tiles * tiles)
    counts = member.sum(1)                                         # [B, T]
    tile_off = torch.cat([torch.zeros(B, 1, dtype=torch.long, device=dev),
                          counts.cumsum(1)], 1).to(torch.int32)
    tile_faces = torch.full((B, F * MAX_TILES), -1, dtype=torch.int32,
                            device=dev)
    wide_faces = torch.full((B, F), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        # nonzero of [T, F] runs tile by tile, faces ascending
        f = member[b].t().nonzero()[:, 1].to(torch.int32)
        tile_faces[b, :len(f)] = f
        w = wide[b].nonzero()[:, 0].to(torch.int32)
        wide_faces[b, :len(w)] = w
    return Bins(box, tile_off, tile_faces, wide.sum(1).to(torch.int32),
                wide_faces)


def _check_records(records: torch.Tensor) -> None:
    if not records.is_cuda:
        raise ValueError("the forward's kernels need CUDA tensors")
    if records.dim() != 3 or records.shape[2] != RECORD \
            or records.dtype != torch.float32 or not records.is_contiguous():
        raise ValueError(f"records must be contiguous float32 [B, F, "
                         f"{RECORD}], got {records.dtype} "
                         f"{tuple(records.shape)}")


def bin_faces_cuda(records: torch.Tensor, image_size: int) -> Bins:
    """Launch the bin kernels (rasterize.cu: box and count, scan per
    image, scatter) on face records [B, F, 20] float32 CUDA.  The buffers
    are sized from the shapes (an image's lists hold at most F * K
    entries), so nothing is read back to the host."""
    _check_records(records)
    B, F = records.shape[:2]
    S, K = int(image_size), MAX_TILES
    if B == 0 or S <= 0:
        raise ValueError("empty batch or image")
    if B * F * K >= 2 ** 31:
        raise ValueError(f"B * F * MAX_TILES = {B * F * K} overflows int32")
    T = tile_grid(S) ** 2
    dev = records.device
    i32 = dict(dtype=torch.int32, device=dev)
    box = torch.empty((B, F, 4), **i32)
    counts = torch.zeros((B, T + 1), **i32)
    tile_off = torch.empty((B, T + 1), **i32)
    tile_faces = torch.empty((B, F * K), **i32)
    wide_faces = torch.empty((B, F), **i32)
    with torch.cuda.device(dev):
        _launch("rasterize", "sdn3d_bin_faces", records.data_ptr(), B, F, S,
                K, box.data_ptr(), counts.data_ptr(), tile_off.data_ptr(),
                tile_faces.data_ptr(), wide_faces.data_ptr(), _stream(dev))
    bin_faces_cuda.launches += 1
    return Bins(box, tile_off, tile_faces, counts[:, T], wide_faces)


bin_faces_cuda.launches = 0


def raster_binned_cuda(records: torch.Tensor, bins: Bins, image_size: int,
                       near: float = R.DEFAULT_NEAR,
                       far: float = R.DEFAULT_FAR,
                       colors: Optional[torch.Tensor] = None):
    """Launch the raster kernel (one block per tile over its list and the
    wide list) on face records and their bins.  Returns (face_index
    [B, S, S] i32, depth [B, S, S] f32[, rgb [B, 3, S, S] f32])."""
    _check_records(records)
    B, F = records.shape[:2]
    S, K = int(image_size), MAX_TILES
    dev = records.device
    for name, t, shape in (("box", bins.box, (B, F, 4)),
                           ("tile_off", bins.tile_off,
                            (B, tile_grid(S) ** 2 + 1)),
                           ("tile_faces", bins.tile_faces, (B, F * K)),
                           ("wide_faces", bins.wide_faces, (B, F))):
        _check_planes(name, t, shape, torch.int32, dev)
    if bins.wide_n.shape != (B,) or bins.wide_n.dtype != torch.int32:
        raise ValueError("wide_n must be int32 [B]")
    if colors is not None:
        if colors.shape != (B, F, 3) or colors.dtype != torch.float32 \
                or colors.device != dev:
            raise ValueError("colors must be float32 [B, F, 3] on the "
                             "faces' device")
        colors = colors.contiguous()
    fi = torch.empty((B, S, S), dtype=torch.int32, device=dev)
    depth = torch.empty((B, S, S), dtype=torch.float32, device=dev)
    rgb = (torch.empty((B, 3, S, S), dtype=torch.float32, device=dev)
           if colors is not None else None)
    with torch.cuda.device(dev):
        _launch("rasterize", "sdn3d_raster_binned", records.data_ptr(),
                bins.box.data_ptr(), bins.tile_off.data_ptr(),
                bins.tile_faces.data_ptr(),
                bins.wide_n.data_ptr(), bins.wide_n.stride(0),
                bins.wide_faces.data_ptr(),
                colors.data_ptr() if colors is not None else None,
                B, F, S, K, float(near), float(far), fi.data_ptr(),
                depth.data_ptr(), rgb.data_ptr() if rgb is not None else None,
                _stream(dev))
    raster_binned_cuda.launches += 1
    return (fi, depth) + ((rgb,) if rgb is not None else ())


raster_binned_cuda.launches = 0


def rasterize_face_index_cuda(faces: torch.Tensor,
                              face_valid: Optional[torch.Tensor],
                              image_size: int,
                              near: float = R.DEFAULT_NEAR,
                              far: float = R.DEFAULT_FAR,
                              colors: Optional[torch.Tensor] = None):
    """The forward on the card: `face_records` (PyTorch), the bin kernels,
    the raster kernel.  faces [B, F, 3, 3] float32 CUDA; face_valid [B, F]
    bool or None; colors [B, F, 3] float32 or None.  Returns (face_index
    [B, S, S] i32, depth [B, S, S] f32[, rgb [B, 3, S, S] f32])."""
    if not faces.is_cuda:
        raise ValueError("rasterize_face_index_cuda needs a CUDA tensor")
    if faces.dim() != 4 or faces.shape[2:] != (3, 3):
        raise ValueError(f"faces must be [B, F, 3, 3], got {tuple(faces.shape)}")
    if faces.dtype != torch.float32:
        raise TypeError(f"faces must be float32, got {faces.dtype}")
    B, F = faces.shape[:2]
    S = int(image_size)
    if face_valid is not None and (face_valid.shape != (B, F)
                                   or face_valid.device != faces.device):
        raise ValueError("face_valid must be [B, F] on the faces' device")
    if B == 0 or S <= 0:
        raise ValueError("empty batch or image")
    rec = face_records(faces, face_valid, S)
    bins = bin_faces_cuda(rec, S)
    out = raster_binned_cuda(rec, bins, S, near, far, colors)
    rasterize_face_index_cuda.launches += 1
    return out


rasterize_face_index_cuda.launches = 0


def rasterize_face_index(faces: torch.Tensor,
                         face_valid: Optional[torch.Tensor],
                         image_size: int,
                         near: float = R.DEFAULT_NEAR,
                         far: float = R.DEFAULT_FAR,
                         colors: Optional[torch.Tensor] = None):
    """Forward rasterization on the device of `faces`: the CUDA kernels
    for a CUDA tensor, the plain PyTorch version for a CPU tensor.  Returns
    (face_index, depth[, rgb planar [B, 3, S, S]])."""
    if faces.is_cuda:
        return rasterize_face_index_cuda(faces, face_valid, image_size,
                                         near, far, colors)
    if faces.device.type != "cpu":
        raise ValueError(f"no rasterizer for device {faces.device}")
    out = R.rasterize_face_maps(faces, face_valid, image_size, near, far)
    if colors is not None:
        rgb = R._gather_face_colors(out[0], colors.float()).permute(0, 3, 1, 2)
        out = out + (rgb.contiguous(),)
    return out


def _check_planes(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def walk_grads_cuda(alpha: torch.Tensor, grad_alpha: torch.Tensor,
                    pp: torch.Tensor, face_index: torch.Tensor,
                    n_steps: int, eps: float) -> torch.Tensor:
    """Launch the fused walk kernel (csrc/silhouette_walk.cu), which
    computes each pixel's edge invariants from the face table itself, for
    both axes in one launch.  alpha, grad_alpha [B, S, S] float32 CUDA; pp
    [B, F, 6] float32 from `rasterize.face_pixel_table`; face_index
    [B, S, S] int32.  Returns [2, B, 3, S, S] (axis 0 first), the values of
    `rasterize.walk_grads_faces_plain` for each axis."""
    if not alpha.is_cuda:
        raise ValueError("walk_grads_cuda needs CUDA tensors")
    if alpha.dim() != 3 or alpha.shape[1] != alpha.shape[2] or n_steps < 0:
        raise ValueError(f"alpha must be [B, S, S] and n_steps >= 0, got "
                         f"{tuple(alpha.shape)}, {n_steps}")
    B, S, _ = alpha.shape
    F = pp.shape[1] if pp.dim() == 3 else -1
    dev = alpha.device
    _check_planes("alpha", alpha, (B, S, S), torch.float32, dev)
    _check_planes("grad_alpha", grad_alpha, (B, S, S), torch.float32, dev)
    _check_planes("face_index", face_index, (B, S, S), torch.int32, dev)
    _check_planes("pp", pp, (B, F, 6), torch.float32, dev)
    if B == 0 or S == 0 or F <= 0:
        raise ValueError("empty batch, image or face table")
    out = torch.empty((2, B, 3, S, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("silhouette_walk", "sdn3d_walk_faces", alpha.data_ptr(),
                grad_alpha.data_ptr(), face_index.data_ptr(), pp.data_ptr(),
                out.data_ptr(), B, S, F, int(n_steps), float(eps),
                _stream(dev))
    walk_grads_cuda.launches += 1
    return out


walk_grads_cuda.launches = 0


def walk_grads(alpha: torch.Tensor, grad_alpha: torch.Tensor,
               pp: torch.Tensor, face_index: torch.Tensor, n_steps: int,
               eps: float) -> torch.Tensor:
    """Silhouette walk accumulators of both axes, [2, B, 3, S, S] (axis 0
    first), on the device of `alpha`: one launch of the fused kernel for a
    CUDA tensor, its plain version (`walk_grads_faces_plain`, per axis) for
    a CPU tensor."""
    if alpha.is_cuda:
        return walk_grads_cuda(alpha, grad_alpha, pp, face_index, n_steps,
                               eps)
    if alpha.device.type != "cpu":
        raise ValueError(f"no walk kernel for device {alpha.device}")
    return torch.stack([R.walk_grads_faces_plain(
        alpha, grad_alpha, pp, face_index, n_steps, eps, axis)
        for axis in (0, 1)])


def won_pixel_boxes_cuda(face_index: torch.Tensor,
                         num_faces: int) -> torch.Tensor:
    """Launch the box pass of the reduction (segment_face_grads.cu): each
    face's box of the pixels it won, [B, F, 4] i32 (x_lo, x_hi, y_lo,
    y_hi), (S, -1, S, -1) for a face that won none, S = max(H, W); the
    values of `rasterize.won_pixel_boxes`."""
    if not face_index.is_cuda:
        raise ValueError("won_pixel_boxes_cuda needs a CUDA tensor")
    if face_index.dim() != 3:
        raise ValueError(f"face_index must be [B, H, W], got "
                         f"{tuple(face_index.shape)}")
    B, H, W = face_index.shape
    F = int(num_faces)
    dev = face_index.device
    _check_planes("face_index", face_index, (B, H, W), torch.int32, dev)
    if B * F * H * W == 0:
        raise ValueError("empty batch, image or face set")
    box = torch.full((B, F, 2, 2), -1, dtype=torch.int32, device=dev)
    box[..., 0] = max(H, W)                       # lo of x and y
    with torch.cuda.device(dev):
        _launch("segment_face_grads", "sdn3d_won_pixel_boxes",
                face_index.data_ptr(), B, F, H, W, box.data_ptr(),
                _stream(dev))
    won_pixel_boxes_cuda.launches += 1
    return box.reshape(B, F, 4)


won_pixel_boxes_cuda.launches = 0


def segment_face_grads_cuda(acc_x: torch.Tensor, acc_y: torch.Tensor,
                            face_index: torch.Tensor,
                            num_faces: int) -> torch.Tensor:
    """Launch the pixel->face reduction (csrc/segment_face_grads.cu): the
    box pass (`won_pixel_boxes_cuda`), then one warp per face over its box.
    acc_x / acc_y [B, 3, H, W] float32, face_index [B, H, W] int32.
    Returns [B, F, 6], the values of `rasterize.segment_face_grads_plain`
    summed in another (fixed) order."""
    if not acc_x.is_cuda:
        raise ValueError("segment_face_grads_cuda needs CUDA tensors")
    if face_index.dim() != 3:
        raise ValueError(f"face_index must be [B, H, W], got "
                         f"{tuple(face_index.shape)}")
    B, H, W = face_index.shape
    F = int(num_faces)
    dev = acc_x.device
    _check_planes("acc_x", acc_x, (B, 3, H, W), torch.float32, dev)
    _check_planes("acc_y", acc_y, (B, 3, H, W), torch.float32, dev)
    _check_planes("face_index", face_index, (B, H, W), torch.int32, dev)
    out = torch.empty((B, F, 6), dtype=torch.float32, device=dev)
    if B * F == 0:
        return out
    box = won_pixel_boxes_cuda(face_index, F)
    with torch.cuda.device(dev):
        _launch("segment_face_grads", "sdn3d_segment_face_grads",
                acc_x.data_ptr(), acc_y.data_ptr(), face_index.data_ptr(),
                box.data_ptr(), B, F, H, W, out.data_ptr(), _stream(dev))
    segment_face_grads_cuda.launches += 1
    return out


segment_face_grads_cuda.launches = 0


def segment_face_grads(acc_x: torch.Tensor, acc_y: torch.Tensor,
                       face_index: torch.Tensor,
                       num_faces: int) -> torch.Tensor:
    """Pixel->face reduction [B, F, 6] on the device of `acc_x`: the
    kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if acc_x.is_cuda:
        return segment_face_grads_cuda(acc_x, acc_y, face_index, num_faces)
    if acc_x.device.type != "cpu":
        raise ValueError(f"no reduction kernel for device {acc_x.device}")
    return R.segment_face_grads_plain(acc_x, acc_y, face_index, num_faces)

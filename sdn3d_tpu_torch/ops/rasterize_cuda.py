"""Wrappers of the port's CUDA kernels (csrc/*.cu).

  rasterize.cu           forward rasterizer      rasterize_face_index
  silhouette_walk.cu     silhouette edge walk    walk_grads
  segment_face_grads.cu  pixel->face reduction   segment_face_grads

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
from typing import Dict, Optional, Sequence, Tuple

import torch

from sdn3d_tpu_torch.ops import rasterize as R

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("rasterize", "silhouette_walk", "segment_face_grads")
# -fmad=false: no a*b+c contraction (it flips boundary pixels and walk
# terms against the plain versions); IEEE division stays on (no
# --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
CHUNK = 256          # faces per culling chunk; equals kChunk in rasterize.cu
_FACE_FLOATS = 18

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point and ctypes argument types of each source
_ENTRY = {
    "rasterize": ("sdn3d_rasterize_forward",
                  [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P]),
    "silhouette_walk": ("sdn3d_walk_grads",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    "segment_face_grads": ("sdn3d_segment_face_grads",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
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
            entry, argtypes = _ENTRY[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def _launch(name: str, *args) -> None:
    lib = _load(name)
    err = getattr(lib, _ENTRY[name][0])(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def pack_faces(faces: torch.Tensor, face_valid: Optional[torch.Tensor],
               image_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PyTorch pre-pass of the kernel (the counterpart of the JAX
    package's `pack_faces`, which is XLA there too).

    Returns
      fdata  [B, F, 18] f32: x0 y0 x1 y1 x2 y2 z0 z1 z2 and the 3x3
             barycentric inverse (row-major), from `rasterize.face_setup`;
      bbox   [B, F, 4] i32: inclusive pixel box (x_lo, x_hi, y_lo, y_hi),
             empty (lo > hi) for faces the plain version rejects
             outright (back-facing, degenerate, invalid, non-finite);
      cbbox  [B, ceil(F/256), 4] i32: union box of each 256-face chunk.

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
    faces, inv, ok = R.face_setup(faces, face_valid, S)
    B, F = faces.shape[:2]
    xy = faces[..., :2]                                         # [B, F, 3, 2]
    fdata = torch.cat([xy.reshape(B, F, 6), faces[..., 2],
                       inv.reshape(B, F, 9)], dim=-1).contiguous()

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
    bbox = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                       dim=-1).contiguous()

    nc = -(-F // CHUNK)
    pad = nc * CHUNK - F
    lo_p = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=S)
    hi_p = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-1)
    clo = lo_p.reshape(B, nc, CHUNK, 2).amin(dim=2)
    chi = hi_p.reshape(B, nc, CHUNK, 2).amax(dim=2)
    cbbox = torch.stack([clo[..., 0], chi[..., 0], clo[..., 1], chi[..., 1]],
                        dim=-1).contiguous()
    return fdata, bbox, cbbox


def rasterize_face_index_cuda(faces: torch.Tensor,
                              face_valid: Optional[torch.Tensor],
                              image_size: int,
                              near: float = R.DEFAULT_NEAR,
                              far: float = R.DEFAULT_FAR,
                              colors: Optional[torch.Tensor] = None,
                              boxes: bool = False):
    """Launch the CUDA kernel.  faces [B, F, 3, 3] float32 CUDA;
    face_valid [B, F] bool or None; colors [B, F, 3] float32 or None.
    Returns (face_index [B, S, S] i32, depth [B, S, S] f32
    [, rgb [B, 3, S, S] f32][, bbox]): with `boxes`, also the faces' pixel
    boxes of `pack_faces`, which the reduction kernel walks."""
    if not faces.is_cuda:
        raise ValueError("rasterize_face_index_cuda needs a CUDA tensor")
    if faces.dim() != 4 or faces.shape[2:] != (3, 3):
        raise ValueError(f"faces must be [B, F, 3, 3], got {tuple(faces.shape)}")
    if faces.dtype != torch.float32:
        raise TypeError(f"faces must be float32, got {faces.dtype}")
    B, F = faces.shape[:2]
    S = int(image_size)
    dev = faces.device
    if face_valid is not None and (face_valid.shape != (B, F)
                                   or face_valid.device != dev):
        raise ValueError("face_valid must be [B, F] on the faces' device")
    if colors is not None:
        if colors.shape != (B, F, 3) or colors.dtype != torch.float32 \
                or colors.device != dev:
            raise ValueError("colors must be float32 [B, F, 3] on the "
                             "faces' device")
        colors = colors.contiguous()
    if B == 0 or S <= 0:
        raise ValueError("empty batch or image")
    fdata, bbox, cbbox = pack_faces(faces, face_valid, S)
    fi = torch.empty((B, S, S), dtype=torch.int32, device=dev)
    depth = torch.empty((B, S, S), dtype=torch.float32, device=dev)
    rgb = (torch.empty((B, 3, S, S), dtype=torch.float32, device=dev)
           if colors is not None else None)
    for t in (fdata, bbox, cbbox, fi, depth):
        assert t.is_contiguous()
    with torch.cuda.device(dev):
        _launch("rasterize",
                fdata.data_ptr(), bbox.data_ptr(), cbbox.data_ptr(),
                colors.data_ptr() if colors is not None else None,
                B, F, S, float(near), float(far), fi.data_ptr(),
                depth.data_ptr(), rgb.data_ptr() if rgb is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
    rasterize_face_index_cuda.launches += 1
    return ((fi, depth) + ((rgb,) if rgb is not None else ())
            + ((bbox,) if boxes else ()))


rasterize_face_index_cuda.launches = 0


def rasterize_face_index(faces: torch.Tensor,
                         face_valid: Optional[torch.Tensor],
                         image_size: int,
                         near: float = R.DEFAULT_NEAR,
                         far: float = R.DEFAULT_FAR,
                         colors: Optional[torch.Tensor] = None,
                         boxes: bool = False):
    """Forward rasterization on the device of `faces`: the CUDA kernel for
    a CUDA tensor, the plain PyTorch version for a CPU tensor.  Returns
    (face_index, depth[, rgb planar [B, 3, S, S]][, bbox]) as
    rasterize_face_index_cuda does; the plain version has no boxes (None)."""
    if faces.is_cuda:
        return rasterize_face_index_cuda(faces, face_valid, image_size,
                                         near, far, colors, boxes)
    if faces.device.type != "cpu":
        raise ValueError(f"no rasterizer for device {faces.device}")
    out = R.rasterize_face_maps(faces, face_valid, image_size, near, far)
    if colors is not None:
        rgb = R._gather_face_colors(out[0], colors.float()).permute(0, 3, 1, 2)
        out = out + (rgb.contiguous(),)
    return out + (None,) if boxes else out


def _check_planes(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def walk_grads_cuda(alpha: torch.Tensor, grad_alpha: torch.Tensor,
                    inv: torch.Tensor, n_steps: int, eps: float,
                    axis: int) -> torch.Tensor:
    """Launch the walk kernel (csrc/silhouette_walk.cu) for one axis.
    alpha, grad_alpha [B, H, W] float32 CUDA; inv [B, 18, H, W] from
    `rasterize.edge_invariant_stack`.  Returns [B, 3, H, W] float32, the
    same values as `rasterize.walk_grads_plain`."""
    if not alpha.is_cuda:
        raise ValueError("walk_grads_cuda needs CUDA tensors")
    if alpha.dim() != 3 or axis not in (0, 1) or n_steps < 0:
        raise ValueError(f"alpha must be [B, H, W] and axis 0 or 1, got "
                         f"{tuple(alpha.shape)}, axis {axis}")
    B, H, W = alpha.shape
    dev = alpha.device
    _check_planes("alpha", alpha, (B, H, W), torch.float32, dev)
    _check_planes("grad_alpha", grad_alpha, (B, H, W), torch.float32, dev)
    _check_planes("inv", inv, (B, R.WALK_INV_ROWS, H, W), torch.float32, dev)
    if B == 0 or H == 0 or W == 0:
        raise ValueError("empty batch or image")
    out = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("silhouette_walk", alpha.data_ptr(), grad_alpha.data_ptr(),
                inv.data_ptr(), out.data_ptr(), B, H, W, int(n_steps),
                float(eps), int(axis), torch.cuda.current_stream(dev).cuda_stream)
    walk_grads_cuda.launches += 1
    return out


walk_grads_cuda.launches = 0


def walk_grads(alpha: torch.Tensor, grad_alpha: torch.Tensor,
               inv: torch.Tensor, n_steps: int, eps: float,
               axis: int) -> torch.Tensor:
    """Silhouette walk accumulators for one axis on the device of
    `alpha`: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if alpha.is_cuda:
        return walk_grads_cuda(alpha, grad_alpha, inv, n_steps, eps, axis)
    if alpha.device.type != "cpu":
        raise ValueError(f"no walk kernel for device {alpha.device}")
    return R.walk_grads_plain(alpha, grad_alpha, inv, n_steps, eps, axis)


def segment_face_grads_cuda(acc_x: torch.Tensor, acc_y: torch.Tensor,
                            face_index: torch.Tensor,
                            bbox: torch.Tensor) -> torch.Tensor:
    """Launch the pixel->face reduction kernel
    (csrc/segment_face_grads.cu).  acc_x / acc_y [B, 3, H, W] float32,
    face_index [B, H, W] int32, bbox [B, F, 4] int32 from `pack_faces`
    (each face's pixel box; it holds every pixel the face can win).
    Returns [B, F, 6], the values of `rasterize.segment_face_grads_plain`
    summed in another (fixed) order."""
    if not acc_x.is_cuda:
        raise ValueError("segment_face_grads_cuda needs CUDA tensors")
    if face_index.dim() != 3 or bbox.dim() != 3 or bbox.shape[2] != 4:
        raise ValueError(f"face_index must be [B, H, W] and bbox [B, F, 4], "
                         f"got {tuple(face_index.shape)}, {tuple(bbox.shape)}")
    B, H, W = face_index.shape
    F = bbox.shape[1]
    dev = acc_x.device
    _check_planes("acc_x", acc_x, (B, 3, H, W), torch.float32, dev)
    _check_planes("acc_y", acc_y, (B, 3, H, W), torch.float32, dev)
    _check_planes("face_index", face_index, (B, H, W), torch.int32, dev)
    _check_planes("bbox", bbox, (B, F, 4), torch.int32, dev)
    out = torch.empty((B, F, 6), dtype=torch.float32, device=dev)
    if B * F == 0:
        return out
    with torch.cuda.device(dev):
        _launch("segment_face_grads", acc_x.data_ptr(), acc_y.data_ptr(),
                face_index.data_ptr(), bbox.data_ptr(), B, F, H, W,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    segment_face_grads_cuda.launches += 1
    return out


segment_face_grads_cuda.launches = 0


def segment_face_grads(acc_x: torch.Tensor, acc_y: torch.Tensor,
                       face_index: torch.Tensor, num_faces: int,
                       boxes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel->face reduction [B, F, 6] on the device of `acc_x`: the
    kernel for a CUDA tensor, over `boxes` (the forward's `pack_faces`
    boxes of the F faces, which the kernel needs); the plain version for
    a CPU tensor."""
    if acc_x.is_cuda:
        if boxes is None or boxes.shape[1] != num_faces:
            raise ValueError("the reduction kernel needs the forward's face "
                             "boxes [B, num_faces, 4]")
        return segment_face_grads_cuda(acc_x, acc_y, face_index, boxes)
    if acc_x.device.type != "cpu":
        raise ValueError(f"no reduction kernel for device {acc_x.device}")
    return R.segment_face_grads_plain(acc_x, acc_y, face_index, num_faces)

"""Wrapper of the CUDA forward rasterizer (csrc/rasterize.cu).

`rasterize_face_index` dispatches on the device of its input: for a CPU
tensor it runs the plain PyTorch version (ops/rasterize.py); for a CUDA
tensor it launches the kernel or raises.  There is no fallback from one
to the other.

The kernel is built at first use with nvcc (route (b): a plain C entry
point loaded with ctypes) into `sdn3d_tpu_torch/_build/`, named by a hash
of the source and flags so an edited source is never served stale.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import torch

from sdn3d_tpu_torch.ops import rasterize as R

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "rasterize.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -fmad=false: no a*b+c contraction (it flips boundary pixels against the
# plain version); IEEE division stays on (no --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
CHUNK = 256          # faces per culling chunk; equals kChunk in the source
_FACE_FLOATS = 18

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_seconds: Optional[float] = None
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA rasterizer needs the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


def build() -> str:
    """Compile csrc/rasterize.cu into a shared library (once per source
    and flags hash) and return its path.  The compiler's output, with
    ptxas' register / shared-memory / spill report, is kept in
    `build_log`."""
    global build_seconds, build_log
    with open(_SOURCE, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"librasterize_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, _SOURCE],
        capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.sdn3d_rasterize_forward.argtypes = [
                p, p, p, p, i, i, i, f, f, p, p, p, p]
            lib.sdn3d_rasterize_forward.restype = ctypes.c_int
            _lib = lib
    return _lib


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
                              colors: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel.  faces [B, F, 3, 3] float32 CUDA;
    face_valid [B, F] bool or None; colors [B, F, 3] float32 or None.
    Returns (face_index [B, S, S] i32, depth [B, S, S] f32
    [, rgb [B, 3, S, S] f32])."""
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
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.sdn3d_rasterize_forward(
            fdata.data_ptr(), bbox.data_ptr(), cbbox.data_ptr(),
            colors.data_ptr() if colors is not None else None,
            B, F, S, float(near), float(far), fi.data_ptr(),
            depth.data_ptr(), rgb.data_ptr() if rgb is not None else None,
            stream)
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: cudaError {err}")
    rasterize_face_index_cuda.launches += 1
    if rgb is not None:
        return fi, depth, rgb
    return fi, depth


rasterize_face_index_cuda.launches = 0


def rasterize_face_index(faces: torch.Tensor,
                         face_valid: Optional[torch.Tensor],
                         image_size: int,
                         near: float = R.DEFAULT_NEAR,
                         far: float = R.DEFAULT_FAR,
                         colors: Optional[torch.Tensor] = None):
    """Forward rasterization on the device of `faces`: the CUDA kernel for
    a CUDA tensor, the plain PyTorch version for a CPU tensor.  Returns
    (face_index, depth[, rgb planar [B, 3, S, S]]) as
    rasterize_face_index_cuda does."""
    if faces.is_cuda:
        return rasterize_face_index_cuda(faces, face_valid, image_size,
                                         near, far, colors)
    if faces.device.type != "cpu":
        raise ValueError(f"no rasterizer for device {faces.device}")
    fi, depth = R.rasterize_face_maps(faces, face_valid, image_size, near,
                                      far)
    if colors is None:
        return fi, depth
    rgb = R._gather_face_colors(fi, colors.float()).permute(0, 3, 1, 2)
    return fi, depth, rgb.contiguous()

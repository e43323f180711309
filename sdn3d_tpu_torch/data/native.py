"""ctypes bindings of the native host-data library (native/sdn3d_host.cpp).

Counterpart of sdn3d_tpu/data/native.py, with a loader of its own: the
library is built at first use from the repository's native/sdn3d_host.cpp
with g++ and native/Makefile's flags into `sdn3d_tpu_torch/_build/`, named
by a hash of source and flags (native/ is never written).  On a machine
without g++ (or without the source) every entry point takes its numpy
path, which is the JAX package's numpy path; a compiler that fails on the
source raises.  This is host code (data preparation), not a device kernel.

  scenegt_decode       scenegt RGB -> ids via a sorted lookup table
  crop_square_resize   the per-ROI square crop + PIL-exact bilinear
                       resize (the library's resize_bilinear_f32) +
                       per-channel normalisation
  nms_cpu              greedy suppression (nms.c parity)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "sdn3d_host.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# native/Makefile's CXXFLAGS, plus -shared from its link rule
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_state = {"tried": False, "lib": None}


def library_path() -> str:
    """_build/libsdn3d_host_{hash of source and flags}.so"""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsdn3d_host_{tag}.so")


def build() -> str:
    """Compile native/sdn3d_host.cpp once per source and flags hash;
    returns the library's path.  Raises if g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([shutil.which("g++"), *CXX_FLAGS, "-o", tmp,
                           SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        if shutil.which("g++") is None or not os.path.exists(SOURCE):
            _state["tried"] = True
            return None
        lib = ctypes.CDLL(build())          # a failed build raises each time
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        c_int, c_float = ctypes.c_int, ctypes.c_float
        lib.scenegt_decode.argtypes = [u8p, c_int, c_int, u32p, i32p, c_int,
                                       i32p]
        lib.resize_bilinear_f32.argtypes = [f32p, c_int, c_int, c_int, f32p,
                                            c_int, c_int]
        lib.crop_square_resize.argtypes = [f32p, c_int, c_int, c_int, i32p,
                                           c_float, c_int, f32p, f32p, f32p]
        lib.nms_cpu.argtypes = [f32p, c_int, c_float, u8p]
        for fn in (lib.scenegt_decode, lib.resize_bilinear_f32,
                   lib.crop_square_resize, lib.nms_cpu):
            fn.restype = None
        _state.update(tried=True, lib=lib)
        return lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def scenegt_decode(img: np.ndarray, keys: np.ndarray,
                   vals: np.ndarray) -> np.ndarray:
    """img [H, W, 3] uint8; keys sorted uint32 (r<<16|g<<8|b); vals int32.
    Returns the id map [H, W] int32, -1 where a colour has no key."""
    lib = _load()
    if lib is None:
        return scenegt_decode_np(img, keys, vals)
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img, np.uint8)
    keys = np.ascontiguousarray(keys, np.uint32)
    vals = np.ascontiguousarray(vals, np.int32)
    if img.shape != (h, w, 3) or keys.shape != vals.shape:
        raise ValueError(f"image {img.shape}, keys {keys.shape}, "
                         f"vals {vals.shape}")
    out = np.empty((h, w), np.int32)
    lib.scenegt_decode(img, h, w, keys, vals, len(keys), out)
    return out


def scenegt_decode_np(img: np.ndarray, keys: np.ndarray,
                      vals: np.ndarray) -> np.ndarray:
    """The numpy path of scenegt_decode: a sorted-key search over the
    packed 24-bit colours."""
    img = np.ascontiguousarray(img, np.uint8)
    keys = np.ascontiguousarray(keys, np.uint32)
    vals = np.ascontiguousarray(vals, np.int32)
    flat = ((img[..., 0].astype(np.uint32) << 16)
            | (img[..., 1].astype(np.uint32) << 8)
            | img[..., 2].astype(np.uint32)).ravel()
    idx = np.clip(np.searchsorted(keys, flat), 0, len(keys) - 1)
    out = np.where(keys[idx] == flat, vals[idx], -1)
    return out.reshape(img.shape[:2]).astype(np.int32)


def crop_square_resize(img: np.ndarray, roi: Sequence[int], size: int,
                       fill: float = 0.5, mean=(0.5, 0.5, 0.5),
                       std=(0.25, 0.25, 0.25)) -> np.ndarray:
    """img [H, W, C] float32 in [0, 1]; roi (y1, x1, y2, x2) ints.
    Returns the square crop (padded with `fill`), resized to
    [size, size, C] and normalised ((v - mean) / std)."""
    lib = _load()
    if lib is None:
        return crop_square_resize_np(img, roi, size, fill, mean, std)
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    roi = np.ascontiguousarray(np.asarray(roi, np.int32))
    mean = np.ascontiguousarray(np.asarray(mean, np.float32))
    std = np.ascontiguousarray(np.asarray(std, np.float32))
    if roi.shape != (4,) or mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"roi {roi.shape}, mean {mean.shape}, std "
                         f"{std.shape} for {c} channels")
    out = np.empty((size, size, c), np.float32)
    lib.crop_square_resize(img, h, w, c, roi, fill, size, mean, std, out)
    return out


def crop_square_resize_np(img: np.ndarray, roi: Sequence[int], size: int,
                          fill: float = 0.5, mean=(0.5, 0.5, 0.5),
                          std=(0.25, 0.25, 0.25)) -> np.ndarray:
    """The numpy + PIL path of crop_square_resize."""
    from sdn3d_tpu_torch.data.vkitti import crop_square, resize_bilinear_np
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    crop = crop_square(np.ascontiguousarray(img, np.float32),
                       np.asarray(roi, np.int32), fill=fill)
    crop = resize_bilinear_np(crop, size)
    return ((crop - mean) / std).astype(np.float32)


def nms_cpu(boxes: np.ndarray, threshold: float) -> np.ndarray:
    """Score-sorted boxes [N, 4] -> keep mask [N] bool (nms.c parity)."""
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float32)
    n = len(boxes)
    if lib is not None:
        if boxes.shape != (n, 4):
            raise ValueError(f"boxes {boxes.shape}")
        keep = np.empty((n,), np.uint8)
        lib.nms_cpu(boxes, n, threshold, keep)
        return keep.astype(bool)
    keep = np.ones(n, bool)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            yy1 = max(boxes[i, 0], boxes[j, 0])
            xx1 = max(boxes[i, 1], boxes[j, 1])
            yy2 = min(boxes[i, 2], boxes[j, 2])
            xx2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, yy2 - yy1 + 1) * max(0.0, xx2 - xx1 + 1)
            if inter / (areas[i] + areas[j] - inter) > threshold:
                keep[j] = False
    return keep

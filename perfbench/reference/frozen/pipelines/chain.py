# Frozen copy of sdn3d_tpu_torch/pipelines/chain.py at commit 48e7a10, the package name
# rewritten and the code that no check reaches taken out; part of the
# benchmark's plain reference.  Do not edit.
"""Fused single-process edit chain: semantic -> geometric -> textural.

PyTorch counterpart of sdn3d_tpu/pipelines/chain.py.  The reference runs
the three branches as separate processes glued by the filesystem (label
PNGs, instance/normal/depth PNGs and per-object JSON; README.md:75-114,
geometric/scripts/main.py:530-622, textural/edit_vkitti.py:41-107).  Here
one process holds every branch's model on the device and passes the
inter-branch artifacts in memory, quantized with the same math
`save_outputs` uses for the PNG files, so the output equals driving the
three CLIs through the filesystem.  The frozen copy keeps the serial
`edit_frame` and its stages; the batched and pipelined chains, the
file contract and the builders from checkpoints are taken out.

The geometric stage's re-render goes through render_targets, once per
frame.  With `ChainConfig.small_fetch` (the default, as in the JAX
package) the instance and normal planes are downsized on the device to
the textural conditioning resolution and fetched at that size; the
outputs are those of the full fetch.  A request without `dets` would get
its objects from a Mask R-CNN detector, which the frozen copy never
holds.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perfbench.reference.frozen.models.layers import as_dtype
from perfbench.reference.frozen.pipelines.semantic import EVAL_SCALES
from perfbench.reference.frozen.utils import phases

_NO_DETECTOR = "EditChain built without a detector; pass dets= to edit_frame"


@dataclasses.dataclass
class ChainConfig:
    """The JAX package's ChainConfig: the same fields and defaults."""
    # semantic (cli/semantic_test defaults)
    num_class: int = 14
    scales: Sequence[int] = EVAL_SCALES
    # geometric (DerenderInferConfig / cli/geometric_main defaults)
    image_size: int = 256
    render_size: int = 384
    num_opts: int = 0
    mode: str = "extend"
    # textural (cli/edit_benchmark defaults)
    load_size: int = 624
    fine_width: int = 624
    fine_height: int = 192
    compute_dtype: str = "float32"
    # max source frames whose per-source intermediates (labels, derender
    # encode, textural transforms + feature table) stay resident
    cache_sources: int = 4
    # downsize the instance/normal planes ON THE DEVICE to the textural
    # conditioning resolution (ops/pil_resize, byte-equal to the host PIL
    # transform) and fetch those instead of the full-resolution maps:
    # 0.48 MB instead of 2.79 MB a 375x1242 pair.  The outputs are the
    # same; the full-resolution file contract (`dump`) needs it off.
    small_fetch: bool = True


class _SourceCache:
    """Insertion-ordered cache bounded to `cap` entries, refreshed on hit.

    Benchmark pairs sharing a source arrive consecutively, so a small cap
    gives full recompute elision; the bound keeps a long streaming run from
    pinning every source's intermediates in host memory."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._d: Dict[str, object] = {}

    def get(self, key: str):
        v = self._d.get(key)
        if v is not None:                      # refresh recency
            self._d.pop(key)
            self._d[key] = v
        return v

    def put(self, key: str, value) -> None:
        self._d.pop(key, None)
        self._d[key] = value
        while len(self._d) > self.cap:
            self._d.pop(next(iter(self._d)))

    def __contains__(self, key: str) -> bool:
        return key in self._d


class EditChain:
    """All three branch models resident in one process, on one device.

    Build from the models: `semantic` a SemanticModel, `derender` a (Derenderer, DeviceMeshBank) tuple,
    `textural` a TexturalTrainer, `detector` None or a MaskRCNNDetector,
    all on `device`), then call `edit_frame` per (source image,
    operations) pair.  Stage wall-clock accumulates in `self.stage_s`."""

    def __init__(self, cfg: ChainConfig, semantic, derender, textural,
                 device="cuda", detector=None):
        as_dtype(cfg.compute_dtype)          # float32 or bfloat16
        self.cfg = cfg
        self.device = device
        self.semantic_model = semantic
        self.derender_model, self.bank = derender
        self.textural_trainer = textural
        self.detector = detector
        self.stage_s = {"semantic": 0.0, "geometric": 0.0, "textural": 0.0}
        self._label_cache = _SourceCache(cfg.cache_sources)
        # per-source textural inputs (transformed image, transformed label,
        # feature-code table) — recompute elision for pairs sharing a source
        self._src_cache = _SourceCache(cfg.cache_sources)
        # per-source de-render encode (objs, blob) — edit-independent
        self._encode_cache = _SourceCache(cfg.cache_sources)

        from perfbench.reference.frozen.models.derenderer import TargetType
        from perfbench.reference.frozen.pipelines.derender_infer import \
            DerenderInferConfig
        self.infer_cfg = DerenderInferConfig(
            image_size=cfg.image_size, render_size=cfg.render_size,
            num_opts=cfg.num_opts, mode=TargetType.BY_NAME[cfg.mode])
        # what the textural functions read off the args namespace
        self._tex_args = SimpleNamespace(load_size=cfg.load_size)
        self._wh = (cfg.fine_width, cfg.fine_height)
        self._plan_cache: Dict[Tuple[int, int], object] = {}

    def _small_plan(self, image_shape):
        """The device-downsize plan for this frame shape; None without
        small_fetch, or where transform_plan finds that PIL would pad
        (the chain then fetches the full planes and resizes on the host,
        as the JAX package does)."""
        if not self.cfg.small_fetch:
            return None
        key = tuple(image_shape[:2])
        if key not in self._plan_cache:
            from perfbench.reference.frozen.ops.pil_resize import transform_plan
            H, W = key
            self._plan_cache[key] = transform_plan(
                (W, H), self.cfg.load_size, self._wh)
        return self._plan_cache[key]

    # -- construction -----------------------------------------------------

    # -- stages -----------------------------------------------------------

    def labels(self, image_rgb: np.ndarray,
               cache_key: Optional[str] = None) -> np.ndarray:
        """Semantic stage: multi-scale argmax labels [H, W] uint8
        (cli/semantic_test.infer_image)."""
        if cache_key is not None:
            cached = self._label_cache.get(cache_key)
            if cached is not None:
                return cached
        t0 = time.perf_counter()
        from perfbench.reference.frozen.cli.semantic_test import infer_image
        with phases.phase("sem.infer"):
            pred = infer_image(self.semantic_model, image_rgb,
                               SimpleNamespace(scales=tuple(self.cfg.scales)))
            phases.add_bytes("sem.infer", pred)
        self.stage_s["semantic"] += time.perf_counter() - t0
        if cache_key is not None:
            self._label_cache.put(cache_key, pred)
        return pred

    def _detector(self):
        if self.detector is None:
            raise ValueError(_NO_DETECTOR)
        return self.detector

    def detect(self, image_rgb: np.ndarray):
        """Mask R-CNN objects of one frame, capped to the derenderer's
        slots as cli/geometric_main caps them."""
        from perfbench.reference.frozen.pipelines.derender_infer import \
            keep_largest_detections
        with phases.phase("det.detect"):
            return keep_largest_detections(
                self.infer_cfg, *self._detector().detect(image_rgb))

    def _encoded(self, image_rgb: np.ndarray, dets,
                 cache_key: Optional[str]):
        """The frame's derender_encode (object prep + encoder +
        refinement), from the per-source cache when it holds the frame."""
        from perfbench.reference.frozen.pipelines.derender_infer import derender_encode
        encoded = (self._encode_cache.get(cache_key)
                   if cache_key is not None else None)
        if encoded is None:
            class_ids, masks, rois = dets
            encoded = derender_encode(self.derender_model, image_rgb,
                                      class_ids, masks, rois, self.infer_cfg,
                                      device=self.device, bank=self.bank)
            if cache_key is not None:
                self._encode_cache.put(cache_key, encoded)
        return encoded

    def derender(self, image_rgb: np.ndarray, dets,
                 operations: Optional[List[dict]] = None,
                 cache_key: Optional[str] = None) -> Dict[str, object]:
        """Geometric stage: de-render + edit ops + re-render + composite
        (pipelines/derender_infer.derender_image).  With `cache_key` the
        edit-independent encode (object prep + encoder + refinement) is
        cached per source frame; only the ops and the re-render replay."""
        t0 = time.perf_counter()
        from perfbench.reference.frozen.pipelines.derender_infer import derender_image
        class_ids, masks, rois = dets
        encoded = self._encoded(image_rgb, dets, cache_key)
        out = derender_image(self.derender_model, self.bank, image_rgb,
                             class_ids, masks, rois, self.infer_cfg,
                             operations=operations, encoded=encoded,
                             device=self.device,
                             small_plan=self._small_plan(image_rgb.shape))
        self.stage_s["geometric"] += time.perf_counter() - t0
        return out

    def _source_inputs(self, image_rgb: np.ndarray, label: np.ndarray,
                       cache_key: Optional[str]):
        """The textural source inputs (transforms + feature encode), from
        the per-source cache when it holds the frame."""
        from PIL import Image

        from perfbench.reference.frozen.cli.edit_vkitti import prepare_source_inputs
        cached = (self._src_cache.get(cache_key)
                  if cache_key is not None else None)
        if cached is None:
            with phases.phase("tex.prepare"):
                cached = prepare_source_inputs(
                    self.textural_trainer, Image.fromarray(image_rgb),
                    Image.fromarray(label.astype(np.uint8)),
                    self.cfg.load_size, self._wh)
            if cache_key is not None:
                self._src_cache.put(cache_key, cached)
        return cached

    @staticmethod
    def _tex_item(source_inputs, geo: Dict[str, object]) -> Dict[str, object]:
        """One generate_edit_batch item: the source inputs and the edited
        planes, device-downsized (`instance_small`) or the full-resolution
        bytes the host resizes with PIL."""
        from PIL import Image
        base_img_t, base_label, feats = source_inputs
        with phases.phase("tex.quantize"):
            item = {"base_img_t": base_img_t, "base_label": base_label,
                    "json_obj": geo["json_obj"], "feats": feats}
            if "instance_small" in geo:
                item["inst_small"] = geo["instance_small"]
                item["normal_small"] = geo["normal_small"]
            else:
                item["inst_img"] = Image.fromarray(geo["instance_png"])
                item["normal_img"] = Image.fromarray(geo["normal_png"])
        return item

    def _generate_items(self, items):
        from perfbench.reference.frozen.cli.edit_vkitti import generate_edit_batch
        return generate_edit_batch(self.textural_trainer, items, self._wh,
                                   self._tex_args)

    def generate(self, image_rgb: np.ndarray, label: np.ndarray,
                 geo_out: Dict[str, object],
                 cache_key: Optional[str] = None) -> Tuple[np.ndarray, Dict]:
        """Textural stage: regenerate RGB from the source codes and the
        edited maps, which arrive quantized with save_outputs' math (the
        device-packed planes, full or downsized).  With `cache_key` the
        source-side inputs (transforms + feature encode) are cached per
        source."""
        t0 = time.perf_counter()
        item = self._tex_item(self._source_inputs(image_rgb, label,
                                                  cache_key), geo_out)
        fakes, maps = self._generate_items([item])
        self.stage_s["textural"] += time.perf_counter() - t0
        return fakes[0], maps[0]

    # -- fused frame ------------------------------------------------------

    def edit_frame(self, image_rgb: np.ndarray,
                   operations: Optional[List[dict]] = None,
                   dets=None, label: Optional[np.ndarray] = None,
                   cache_key: Optional[str] = None) -> Dict[str, object]:
        """One source frame through all three branches, in memory.

        `dets` is (class_ids, masks, rois) (e.g. VKITTI GT); when None
        the chain's Mask R-CNN detector runs.  Returns label, geometric
        outputs, and the generated frame [fine_h, fine_w, 3] in [-1, 1]."""
        if label is None:
            label = self.labels(image_rgb, cache_key=cache_key)
        if dets is None:
            dets = self.detect(image_rgb)
        geo = self.derender(image_rgb, dets, operations, cache_key=cache_key)
        fake, maps = self.generate(image_rgb, label, geo, cache_key=cache_key)
        return {"label": label, "geo": geo, "fake": fake, "maps": maps}

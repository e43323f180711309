"""Fused single-process edit chain: semantic -> geometric -> textural.

PyTorch counterpart of the serial path of sdn3d_tpu/pipelines/chain.py.
The reference runs the three branches as separate processes glued by the
filesystem (label PNGs, instance/normal/depth PNGs and per-object JSON;
README.md:75-114, geometric/scripts/main.py:530-622,
textural/edit_vkitti.py:41-107).  Here one process holds every branch's
model on the device and passes the inter-branch artifacts in memory,
quantized with the same math `save_outputs` uses for the PNG files, so
the output equals driving the three CLIs through the filesystem.  `dump`
writes the file contract as a side effect.

The geometric stage's re-render goes through render_targets, which on the
card launches the forward rasterizer kernel (csrc/rasterize.cu) once per
frame.  Not ported yet, each raising NotImplementedError: the
device-downsized planes (small_fetch), the batched and pipelined chains
(edit_frames, edit_frames_pipelined) and the Mask R-CNN source.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sdn3d_tpu_torch.pipelines.semantic import EVAL_SCALES
from sdn3d_tpu_torch.utils import phases

_BATCHED = ("the batched and pipelined chains wait for a later slice "
            "(ROADMAP.md A, edit_frames / pipelined)")
_DETECT = ("Mask R-CNN detection is not ported yet (ROADMAP.md A, "
           "detection as the chain's source); pass dets=")


@dataclasses.dataclass
class ChainConfig:
    """The JAX package's ChainConfig, with the same fields and defaults
    but `small_fetch`, which is False until the device-downsized planes
    are ported (True raises NotImplementedError)."""
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
    # the JAX package downsizes the instance/normal planes on the device
    # to the conditioning resolution and fetches those (output-identical
    # to the full fetch); not ported yet (ROADMAP.md A, small_fetch), so
    # the port fetches the full-resolution planes and False is the default
    small_fetch: bool = False


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

    Build once with `EditChain.build(...)` (or from the models: `semantic`
    a SemanticModel, `derender` a (Derenderer, DeviceMeshBank) tuple,
    `textural` a TexturalTrainer, all on `device`), then call `edit_frame`
    per (source image, operations) pair.  Stage wall-clock accumulates in
    `self.stage_s`."""

    def __init__(self, cfg: ChainConfig, semantic, derender, textural,
                 device="cuda"):
        if cfg.small_fetch:
            raise NotImplementedError(
                "small_fetch (device-downsized planes, ops/pil_resize and "
                "small_plan) is not ported yet (ROADMAP.md A, small_fetch); "
                "outputs are identical with small_fetch=False")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("chain compute_dtype: float32 only")
        self.cfg = cfg
        self.device = device
        self.semantic_model = semantic
        self.derender_model, self.bank = derender
        self.textural_trainer = textural
        self.stage_s = {"semantic": 0.0, "geometric": 0.0, "textural": 0.0}
        self._label_cache = _SourceCache(cfg.cache_sources)
        # per-source textural inputs (transformed image, transformed label,
        # feature-code table) — recompute elision for pairs sharing a source
        self._src_cache = _SourceCache(cfg.cache_sources)
        # per-source de-render encode (objs, blob) — edit-independent
        self._encode_cache = _SourceCache(cfg.cache_sources)

        from sdn3d_tpu_torch.models.derenderer import TargetType
        from sdn3d_tpu_torch.pipelines.derender_infer import \
            DerenderInferConfig
        self.infer_cfg = DerenderInferConfig(
            image_size=cfg.image_size, render_size=cfg.render_size,
            num_opts=cfg.num_opts, mode=TargetType.BY_NAME[cfg.mode])
        # what the textural functions read off the args namespace
        self._tex_args = SimpleNamespace(load_size=cfg.load_size)
        self._wh = (cfg.fine_width, cfg.fine_height)

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, cfg: ChainConfig, shapenet_root: str,
              semantic_ckpt: Optional[str] = None,
              derender_ckpt: Optional[str] = None,
              textural_ckpt: Optional[str] = None,
              maskrcnn_ckpt: Optional[str] = None,
              with_detector: bool = False, device="cuda",
              seed: int = 0) -> "EditChain":
        """The three loaders of the per-stage CLIs, on `device`; random
        weights come from `seed`, drawn inside torch.random.fork_rng (the
        global generator is left as it was)."""
        if with_detector or maskrcnn_ckpt:
            raise NotImplementedError(_DETECT)
        from sdn3d_tpu_torch.cli.edit_vkitti import load_trainer
        from sdn3d_tpu_torch.cli.geometric_main import load_derenderer
        from sdn3d_tpu_torch.cli.semantic_test import load_model

        common = dict(device=device, seed=seed)
        semantic = load_model(SimpleNamespace(
            num_class=cfg.num_class, ckpt_dir=semantic_ckpt, **common))
        derender = load_derenderer(SimpleNamespace(
            image_size=cfg.image_size, ckpt_dir=derender_ckpt,
            shapenet_root=shapenet_root, **common))
        textural = load_trainer(SimpleNamespace(ckpt_dir=textural_ckpt,
                                                **common))
        return cls(cfg, semantic, derender, textural, device=device)

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
        from sdn3d_tpu_torch.cli.semantic_test import infer_image
        with phases.phase("sem.infer"):
            pred = infer_image(self.semantic_model, image_rgb,
                               SimpleNamespace(scales=tuple(self.cfg.scales)))
            phases.add_bytes("sem.infer", pred)
        self.stage_s["semantic"] += time.perf_counter() - t0
        if cache_key is not None:
            self._label_cache.put(cache_key, pred)
        return pred

    def detect(self, image_rgb: np.ndarray):
        raise NotImplementedError(_DETECT)

    def derender(self, image_rgb: np.ndarray, dets,
                 operations: Optional[List[dict]] = None,
                 cache_key: Optional[str] = None) -> Dict[str, object]:
        """Geometric stage: de-render + edit ops + re-render + composite
        (pipelines/derender_infer.derender_image).  With `cache_key` the
        edit-independent encode (object prep + encoder + refinement) is
        cached per source frame; only the ops and the re-render replay."""
        t0 = time.perf_counter()
        from sdn3d_tpu_torch.pipelines.derender_infer import (derender_encode,
                                                              derender_image)
        class_ids, masks, rois = dets
        encoded = (self._encode_cache.get(cache_key)
                   if cache_key is not None else None)
        if encoded is None:
            encoded = derender_encode(self.derender_model, image_rgb,
                                      class_ids, masks, rois, self.infer_cfg,
                                      device=self.device, bank=self.bank)
            if cache_key is not None:
                self._encode_cache.put(cache_key, encoded)
        out = derender_image(self.derender_model, self.bank, image_rgb,
                             class_ids, masks, rois, self.infer_cfg,
                             operations=operations, encoded=encoded,
                             device=self.device)
        self.stage_s["geometric"] += time.perf_counter() - t0
        return out

    def generate(self, image_rgb: np.ndarray, label: np.ndarray,
                 geo_out: Dict[str, object],
                 cache_key: Optional[str] = None) -> Tuple[np.ndarray, Dict]:
        """Textural stage: regenerate RGB from the source codes and the
        edited maps, which arrive quantized with save_outputs' math (the
        device-packed `*_png` planes).  With `cache_key` the source-side
        inputs (transforms + feature encode) are cached per source."""
        t0 = time.perf_counter()
        from PIL import Image

        from sdn3d_tpu_torch.cli.edit_vkitti import (
            generate_edit_from_images, prepare_source_inputs)

        args, wh = self._tex_args, self._wh
        cached = (self._src_cache.get(cache_key)
                  if cache_key is not None else None)
        if cached is not None:
            base_img_t, base_label, feats = cached
        else:
            with phases.phase("tex.prepare"):
                base_img_t, base_label, feats = prepare_source_inputs(
                    self.textural_trainer, Image.fromarray(image_rgb),
                    Image.fromarray(label.astype(np.uint8)),
                    args.load_size, wh)
            if cache_key is not None:
                self._src_cache.put(cache_key,
                                    (base_img_t, base_label, feats))
        with phases.phase("tex.quantize"):
            inst_img = Image.fromarray(geo_out["instance_png"])
            normal_img = Image.fromarray(geo_out["normal_png"])
        fake, maps = generate_edit_from_images(
            self.textural_trainer, base_img_t, base_label, inst_img,
            geo_out["json_obj"], normal_img, wh, args, feats=feats)
        self.stage_s["textural"] += time.perf_counter() - t0
        return fake, maps

    # -- fused frame ------------------------------------------------------

    def edit_frame(self, image_rgb: np.ndarray,
                   operations: Optional[List[dict]] = None,
                   dets=None, label: Optional[np.ndarray] = None,
                   cache_key: Optional[str] = None) -> Dict[str, object]:
        """One source frame through all three branches, in memory.

        `dets` is (class_ids, masks, rois) (e.g. VKITTI GT).  Returns
        label, geometric outputs, and the generated frame
        [fine_h, fine_w, 3] in [-1, 1]."""
        if label is None:
            label = self.labels(image_rgb, cache_key=cache_key)
        if dets is None:
            dets = self.detect(image_rgb)
        geo = self.derender(image_rgb, dets, operations, cache_key=cache_key)
        fake, maps = self.generate(image_rgb, label, geo, cache_key=cache_key)
        return {"label": label, "geo": geo, "fake": fake, "maps": maps}

    def edit_frames(self, requests):
        raise NotImplementedError(_BATCHED)

    def edit_frames_pipelined(self, chunks):
        raise NotImplementedError(_BATCHED)

    def dump(self, label: np.ndarray, geo: Dict[str, object],
             segm_dir: str, geo_dir: str, source_name: str,
             target_name: str) -> None:
        """Write the inter-branch file contract as a side effect (the bytes
        of the per-stage CLIs): the label PNG keyed by the SOURCE frame,
        the geometric outputs by the TARGET name."""
        import os

        from PIL import Image

        from sdn3d_tpu_torch.cli.geometric_main import save_outputs
        os.makedirs(segm_dir, exist_ok=True)
        Image.fromarray(label.astype(np.uint8)).save(
            os.path.join(segm_dir, f"{source_name}.png"))
        save_outputs(geo, geo_dir, target_name)

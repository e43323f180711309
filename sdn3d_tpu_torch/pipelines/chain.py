"""Fused single-process edit chain: semantic -> geometric -> textural.

PyTorch counterpart of sdn3d_tpu/pipelines/chain.py.  The reference runs
the three branches as separate processes glued by the filesystem (label
PNGs, instance/normal/depth PNGs and per-object JSON; README.md:75-114,
geometric/scripts/main.py:530-622, textural/edit_vkitti.py:41-107).  Here
one process holds every branch's model on the device and passes the
inter-branch artifacts in memory, quantized with the same math
`save_outputs` uses for the PNG files, so the output equals driving the
three CLIs through the filesystem.  `dump` writes the file contract as a
side effect.

The geometric stage's re-render goes through render_targets, which on the
card launches the forward rasterizer kernel (csrc/rasterize.cu) once per
frame (`edit_frame`) or once per chunk of N frames (`edit_frames`,
`edit_frames_pipelined`, at 16 * N slot images).  With
`ChainConfig.small_fetch` (the default, as in the JAX package) the
instance and normal planes are downsized on the device to the textural
conditioning resolution and fetched at that size; the outputs are those
of the full fetch.  A request without `dets` gets its objects from the
chain's Mask R-CNN detector (pipelines/detect.py; build with
`with_detector` or `maskrcnn_ckpt`), once a request as in the JAX package:
one frame at a time in `edit_frame`, every det-less request of a chunk in
one batched pass in `edit_frames` and the pipelined chain's stage A.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sdn3d_tpu_torch.models.layers import as_dtype
from sdn3d_tpu_torch.pipelines.semantic import EVAL_SCALES
from sdn3d_tpu_torch.utils import phases

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

    Build once with `EditChain.build(...)` (or from the models: `semantic`
    a SemanticModel, `derender` a (Derenderer, DeviceMeshBank) tuple,
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

        from sdn3d_tpu_torch.models.derenderer import TargetType
        from sdn3d_tpu_torch.pipelines.derender_infer import \
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
            from sdn3d_tpu_torch.ops.pil_resize import transform_plan
            H, W = key
            self._plan_cache[key] = transform_plan(
                (W, H), self.cfg.load_size, self._wh)
        return self._plan_cache[key]

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, cfg: ChainConfig, shapenet_root: str,
              semantic_ckpt: Optional[str] = None,
              derender_ckpt: Optional[str] = None,
              textural_ckpt: Optional[str] = None,
              maskrcnn_ckpt: Optional[str] = None,
              with_detector: bool = False, device="cuda",
              seed: int = 0) -> "EditChain":
        """The three loaders of the per-stage CLIs, on `device`, each
        computing in cfg.compute_dtype (JAX chain.py:150-184); random
        weights come from `seed`, drawn inside torch.random.fork_rng (the
        global generator is left as it was).  Each checkpoint is a
        checkpoint directory (core/checkpoint) or a torch file, as the
        per-stage CLIs take them.  With `with_detector` or `maskrcnn_ckpt`
        the chain also holds the Mask R-CNN detector
        (cli/geometric_main.make_detector)."""
        from sdn3d_tpu_torch.cli.edit_vkitti import load_trainer
        from sdn3d_tpu_torch.cli.geometric_main import (load_derenderer,
                                                         make_detector)
        from sdn3d_tpu_torch.cli.semantic_test import load_model

        common = dict(device=device, seed=seed,
                      compute_dtype=cfg.compute_dtype)
        semantic = load_model(SimpleNamespace(
            num_class=cfg.num_class, ckpt_dir=semantic_ckpt, **common))
        derender = load_derenderer(SimpleNamespace(
            image_size=cfg.image_size, ckpt_dir=derender_ckpt,
            shapenet_root=shapenet_root, **common))
        textural = load_trainer(SimpleNamespace(ckpt_dir=textural_ckpt,
                                                **common))
        detector = None
        if with_detector or maskrcnn_ckpt:
            detector = make_detector(SimpleNamespace(
                maskrcnn_ckpt=maskrcnn_ckpt, **common))
        return cls(cfg, semantic, derender, textural, device=device,
                   detector=detector)

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

    def _detector(self):
        if self.detector is None:
            raise ValueError(_NO_DETECTOR)
        return self.detector

    def detect(self, image_rgb: np.ndarray):
        """Mask R-CNN objects of one frame, capped to the derenderer's
        slots as cli/geometric_main caps them."""
        from sdn3d_tpu_torch.pipelines.derender_infer import \
            keep_largest_detections
        with phases.phase("det.detect"):
            return keep_largest_detections(
                self.infer_cfg, *self._detector().detect(image_rgb))

    def detect_begin(self, image_rgb: np.ndarray):
        """Enqueue one frame's detection (its copy in flight);
        detect_finish(pending) equals detect(image_rgb)."""
        with phases.phase("det.detect"):
            return self._detector().detect_begin(image_rgb)

    def detect_finish(self, pending):
        from sdn3d_tpu_torch.pipelines.derender_infer import \
            keep_largest_detections
        with phases.phase("det.detect"):
            return keep_largest_detections(
                self.infer_cfg, *self._detector().detect_finish(pending))

    def detect_missing_begin(self, requests, dets_list):
        """Enqueue ONE batched detection pass for every request whose dets
        are None, padded to the chunk's size (detect_begin_batch), so the
        serial and pipelined chains at one --batch_pairs run the same
        batch.  Returns the pending handle, None when nothing is missing."""
        idx = [i for i, d in enumerate(dets_list) if d is None]
        if not idx:
            return None
        with phases.phase("det.detect"):
            pending = self._detector().detect_begin_batch(
                [requests[i]["image_rgb"] for i in idx],
                pad_to=len(requests))
        return (idx, pending)

    def detect_missing_finish(self, handle, dets_list):
        """Fill dets_list in place from detect_missing_begin's copy."""
        if handle is None:
            return dets_list
        from sdn3d_tpu_torch.pipelines.derender_infer import \
            keep_largest_detections
        idx, pending = handle
        with phases.phase("det.detect"):
            outs = self._detector().detect_finish_batch(pending)
            for i, out in zip(idx, outs):
                dets_list[i] = keep_largest_detections(self.infer_cfg, *out)
        return dets_list

    def _encoded(self, image_rgb: np.ndarray, dets,
                 cache_key: Optional[str]):
        """The frame's derender_encode (object prep + encoder +
        refinement), from the per-source cache when it holds the frame."""
        from sdn3d_tpu_torch.pipelines.derender_infer import derender_encode
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
        from sdn3d_tpu_torch.pipelines.derender_infer import derender_image
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

        from sdn3d_tpu_torch.cli.edit_vkitti import prepare_source_inputs
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
        from sdn3d_tpu_torch.cli.edit_vkitti import generate_edit_batch
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

    def edit_frames(self, requests: Sequence[Dict[str, object]]
                    ) -> List[Dict[str, object]]:
        """Batched fused chain: N (source, operations) pairs with ONE
        render of the N frames' slots (derender_images_batch: one
        forward-rasterizer launch at 16 * N images) and ONE generator
        forward (generate_edit_batch).  Each request takes edit_frame's
        keys (image_rgb, operations, dets, label, cache_key); the outputs
        are edit_frame's, pair by pair."""
        from sdn3d_tpu_torch.pipelines.derender_infer import \
            derender_images_batch

        # detection for every det-less request in one batched pass, its
        # copy in flight while the semantic passes run
        dets_list = [r.get("dets") for r in requests]
        det_handle = self.detect_missing_begin(requests, dets_list)
        labels = [r["label"] if r.get("label") is not None else
                  self.labels(r["image_rgb"], cache_key=r.get("cache_key"))
                  for r in requests]
        self.detect_missing_finish(det_handle, dets_list)

        t0 = time.perf_counter()
        frames = []
        for r, dets in zip(requests, dets_list):
            class_ids, masks, rois = dets
            frames.append({
                "image_rgb": r["image_rgb"], "class_ids": class_ids,
                "image_masks": masks, "rois": rois,
                "operations": r.get("operations"),
                "encoded": self._encoded(r["image_rgb"], dets,
                                         r.get("cache_key"))})
        geos = derender_images_batch(
            self.derender_model, self.bank, frames, self.infer_cfg,
            small_plan=self._small_plan(frames[0]["image_rgb"].shape),
            device=self.device)
        self.stage_s["geometric"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        items = [self._tex_item(self._source_inputs(
            r["image_rgb"], label, r.get("cache_key")), geo)
            for r, label, geo in zip(requests, labels, geos)]
        fakes, maps_list = self._generate_items(items)
        self.stage_s["textural"] += time.perf_counter() - t0
        return [{"label": label, "geo": geo, "fake": fake, "maps": maps}
                for label, geo, fake, maps in
                zip(labels, geos, fakes, maps_list)]

    # -- pipelined fused chain ---------------------------------------------

    def _stage_a(self, requests: Sequence[Dict[str, object]]):
        """Pipeline stage A: enqueue the chunk's semantic passes, detect
        (one batched pass for the det-less requests; the crops need its
        masks, so stage A waits for it), prepare the object crops and
        enqueue the encoders, each copy to the host started without
        waiting (HostFetch).  Returns as soon as the
        card's queue holds the work.  Requests of one source (one cache
        key) in the chunk share one semantic pass and one encode: the
        per-source caches are filled only in stage B."""
        from sdn3d_tpu_torch.pipelines.derender_infer import (
            derender_encode_batch_begin)
        from sdn3d_tpu_torch.pipelines.semantic import multiscale_labels_begin

        t0 = time.perf_counter()
        labels = []                  # ("host", np) | ("dev", HostFetch)
        fetches = {}                 # cache key -> the chunk's HostFetch
        for r in requests:
            lab = r.get("label")
            key = r.get("cache_key")
            if lab is None and key is not None:
                lab = self._label_cache.get(key)
            if lab is not None:
                labels.append(("host", lab))
                continue
            if key is None or key not in fetches:
                with phases.phase("sem.infer"):
                    fetch = multiscale_labels_begin(
                        self.semantic_model,
                        np.ascontiguousarray(r["image_rgb"]),
                        scales=tuple(self.cfg.scales), device=self.device)
                    phases.add_bytes("sem.infer", fetch)
                if key is not None:
                    fetches[key] = fetch
            labels.append(("dev", fetches.get(key, fetch)))
        self.stage_s["semantic"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        dets_list = [r.get("dets") for r in requests]
        self.detect_missing_finish(
            self.detect_missing_begin(requests, dets_list), dets_list)
        enc_frames, enc_slots = [], []   # enc_slots: request indices each
        by_key = {}                      # cache key -> its enc_slots entry
        encoded_list: List[object] = []
        for i, (r, dets) in enumerate(zip(requests, dets_list)):
            key = r.get("cache_key")
            encoded = self._encode_cache.get(key) if key is not None \
                else None
            if encoded is None and self.infer_cfg.num_opts:
                # refinement has no overlapped path: encode now
                encoded = self._encoded(r["image_rgb"], dets, key)
            encoded_list.append(encoded)
            if encoded is None:
                if key is not None and key in by_key:
                    by_key[key].append(i)
                    continue
                class_ids, masks, rois = dets
                enc_frames.append({
                    "image_rgb": r["image_rgb"], "class_ids": class_ids,
                    "image_masks": masks, "rois": rois})
                enc_slots.append([i])
                if key is not None:
                    by_key[key] = enc_slots[-1]
        enc_pending = (derender_encode_batch_begin(
            self.derender_model, enc_frames, self.infer_cfg,
            device=self.device) if enc_frames else [])
        self.stage_s["geometric"] += time.perf_counter() - t0
        return {"requests": requests, "labels": labels,
                "dets_list": dets_list, "encoded_list": encoded_list,
                "enc_pending": enc_pending, "enc_slots": enc_slots}

    def _stage_b(self, a):
        """Pipeline stage B: take stage A's copies, apply the edit ops on
        the host, enqueue the chunk's render (its copy started), and
        prepare the textural source inputs (every source's netE enqueued
        before any copy is waited for)."""
        from PIL import Image

        from sdn3d_tpu_torch.cli.edit_vkitti import (prepare_source_begin,
                                                     prepare_source_finish)
        from sdn3d_tpu_torch.pipelines.derender_infer import (
            derender_encode_batch_finish, derender_render_begin)

        requests = a["requests"]
        t0 = time.perf_counter()
        labels = []
        for r, (kind, lab) in zip(requests, a["labels"]):
            if kind == "dev":
                lab = lab.result()
                key = r.get("cache_key")
                if key is not None:
                    self._label_cache.put(key, lab)
            labels.append(lab)
        self.stage_s["semantic"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        encoded_list = list(a["encoded_list"])
        for slots, encoded in zip(a["enc_slots"],
                                  derender_encode_batch_finish(
                                      a["enc_pending"])):
            for slot in slots:
                encoded_list[slot] = encoded
            key = requests[slots[0]].get("cache_key")
            if key is not None:
                self._encode_cache.put(key, encoded)
        frames = []
        for r, dets, encoded in zip(requests, a["dets_list"], encoded_list):
            class_ids, masks, rois = dets
            frames.append({
                "image_rgb": r["image_rgb"], "class_ids": class_ids,
                "image_masks": masks, "rois": rois,
                "operations": r.get("operations"), "encoded": encoded})
        pending_render = derender_render_begin(
            self.derender_model, self.bank, frames, self.infer_cfg,
            small_plan=self._small_plan(frames[0]["image_rgb"].shape),
            device=self.device)
        self.stage_s["geometric"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        prepared, pending = [], []
        first = {}                   # cache key -> first request index
        for i, (r, label) in enumerate(zip(requests, labels)):
            key = r.get("cache_key")
            cached = self._src_cache.get(key) if key is not None else None
            if cached is None and key is not None and key in first:
                pending.append(first[key])      # this chunk's own prepare
            elif cached is None:
                with phases.phase("tex.prepare"):
                    pending.append(prepare_source_begin(
                        self.textural_trainer, Image.fromarray(r["image_rgb"]),
                        Image.fromarray(label.astype(np.uint8)),
                        self.cfg.load_size, self._wh))
                if key is not None:
                    first[key] = i
            else:
                pending.append(None)
            prepared.append(cached)
        for i, p in enumerate(pending):
            if isinstance(p, int):
                prepared[i] = prepared[p]
            elif p is not None:
                with phases.phase("tex.prepare"):
                    prepared[i] = prepare_source_finish(p)
                key = requests[i].get("cache_key")
                if key is not None:
                    self._src_cache.put(key, prepared[i])
        self.stage_s["textural"] += time.perf_counter() - t0
        return {"labels": labels, "pending_render": pending_render,
                "prepared": prepared}

    def _stage_c(self, b) -> List[Dict[str, object]]:
        """Pipeline stage C: take the chunk's packed render, assemble the
        textural conditioning and generate."""
        from sdn3d_tpu_torch.pipelines.derender_infer import (
            derender_render_finish)

        t0 = time.perf_counter()
        geos = derender_render_finish(b["pending_render"])
        self.stage_s["geometric"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        items = [self._tex_item(prep, geo)
                 for prep, geo in zip(b["prepared"], geos)]
        fakes, maps_list = self._generate_items(items)
        self.stage_s["textural"] += time.perf_counter() - t0
        return [{"label": label, "geo": geo, "fake": fake, "maps": maps}
                for label, geo, fake, maps in
                zip(b["labels"], geos, fakes, maps_list)]

    def edit_frames_pipelined(self, chunks):
        """Generator: run chunks of requests through a 3-deep software
        pipeline and yield each chunk's outputs in order.

        Stage A (semantic + detection + crop prep + encoder, copies in
        flight) runs two chunks ahead of the yield; stage B (edit ops +
        the chunk's render + textural source prep) one chunk ahead; stage
        C (the
        packed planes + generate) yields.  The card's queue holds the
        next chunks' work while the host packages and scores the current
        one.  The outputs are edit_frames' per chunk (the same
        operations on the same inputs; only the host's order differs).
        The per-stage stage_s walls overlap under this scheduling and no
        longer sum to the wall clock; with the phase records on,
        phases.block synchronises the card, so phase times are
        attribution only."""
        a_prev = None
        b_prev = None
        for chunk in chunks:
            a_new = self._stage_a(chunk)
            if b_prev is not None:
                yield self._stage_c(b_prev)
                b_prev = None
            if a_prev is not None:
                b_prev = self._stage_b(a_prev)
            a_prev = a_new
        if a_prev is not None:
            if b_prev is not None:
                yield self._stage_c(b_prev)
            yield self._stage_c(self._stage_b(a_prev))

    def dump(self, label: np.ndarray, geo: Dict[str, object],
             segm_dir: str, geo_dir: str, source_name: str,
             target_name: str) -> None:
        """Write the inter-branch file contract as a side effect (the bytes
        of the per-stage CLIs): the label PNG keyed by the SOURCE frame,
        the geometric outputs by the TARGET name."""
        import os

        from PIL import Image

        from sdn3d_tpu_torch.cli.geometric_main import save_outputs
        if "instance_png" not in geo:
            raise ValueError("dump needs the full-resolution contract; build "
                             "the chain with ChainConfig(small_fetch=False) "
                             "when dumping")
        os.makedirs(segm_dir, exist_ok=True)
        Image.fromarray(label.astype(np.uint8)).save(
            os.path.join(segm_dir, f"{source_name}.png"))
        save_outputs(geo, geo_dir, target_name)

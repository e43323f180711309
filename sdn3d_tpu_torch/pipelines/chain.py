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

The chain runs a frame at a time (`edit_frame`) or a chunk of N frames
through three stages (`_stage_a`, `_b`, `_c`): `edit_frames` runs one
chunk through them, `edit_frames_pipelined` overlaps successive chunks.
Requests of one source (one cache key) in a chunk share one semantic
pass, one encode and one source prep (`_SourceCache.lookup`).  The
geometric stage's re-render goes through render_targets, which on the
card launches the forward rasterizer kernel (csrc/rasterize.cu) once per
frame or once per chunk (at 16 * N slot images).  With
`ChainConfig.small_fetch` (the default, as in the JAX package) the
instance and normal planes are downsized on the device to the textural
conditioning resolution and fetched at that size; the outputs are those
of the full fetch.  A request without `dets` gets its objects from the
chain's Mask R-CNN detector (pipelines/detect.py; build with
`with_detector` or `maskrcnn_ckpt`), once a request as in the JAX package:
one frame at a time in `edit_frame`, every det-less request of a chunk in
one batched pass in stage A.  Each request's result carries the `dets`
its geometric stage used, given or detected; a detection runs inside a
`stage.detect` span and counts the objects it keeps (`count.det.kept`).

The textural stage is pipelines/textural_edit.  Only `build` (the
per-stage CLIs' loaders) and `dump` (cli/geometric_main.save_outputs, the
file contract) import from cli/.
"""

from __future__ import annotations

import contextlib
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
    pinning every source's intermediates in host memory.  Each lookup
    counts `count.cache.<name>.hit` or `.miss` (utils/phases)."""

    def __init__(self, cap: int, name: str):
        self.cap = max(1, int(cap))
        self._d: Dict[str, object] = {}
        self._hit = f"count.cache.{name}.hit"
        self._miss = f"count.cache.{name}.miss"

    def get(self, key: str):
        v = self._d.get(key)
        if v is None:
            phases.count(self._miss)
            return None
        phases.count(self._hit)
        self._d.pop(key)                       # refresh recency
        self._d[key] = v
        return v

    def put(self, key: str, value) -> None:
        self._d.pop(key, None)
        self._d[key] = value
        while len(self._d) > self.cap:
            self._d.pop(next(iter(self._d)))

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def lookup(self, keys: Sequence[Optional[str]],
               given: Optional[Sequence[object]] = None):
        """The chunk's rule for per-source work: each request's key looked
        up once (a hit or a miss counted), except where `given[i]` is not
        None or the key is None.  Returns (values, misses): values[i] the
        given or cached value, None for a miss; misses the request indices
        grouped by key in the order of first appearance, one piece of work
        a group (a request without a key is a group of its own)."""
        values, misses, by_key = [], [], {}
        for i, key in enumerate(keys):
            v = given[i] if given is not None else None
            if v is None and key is not None:
                v = self.get(key)
            values.append(v)
            if v is None and key in by_key:
                by_key[key].append(i)
            elif v is None:
                misses.append([i])
                if key is not None:
                    by_key[key] = misses[-1]
        return values, misses

    def fill(self, keys, values, misses, results) -> list:
        """`values` with each group of `misses` given its result (in
        order), each result kept under its key."""
        values = list(values)
        for group, result in zip(misses, results):
            for i in group:
                values[i] = result
            if keys[group[0]] is not None:
                self.put(keys[group[0]], result)
        return values


class EditChain:
    """All three branch models resident in one process, on one device.

    Build once with `EditChain.build(...)` (or from the models: `semantic`
    a SemanticModel, `derender` a (Derenderer, DeviceMeshBank) tuple,
    `textural` a TexturalTrainer, `detector` None or a MaskRCNNDetector,
    all on `device`), then call `edit_frame` per (source image,
    operations) pair, or `edit_frames` / `edit_frames_pipelined` per
    chunk of pairs.  Stage wall-clock accumulates in `self.stage_s`, the
    seconds of the `stage.*` spans (utils/phases; "detect" from the first
    detection on); each `edit_frame` request is a `chain.request` span and
    each chunk's stages `chain.stage_a`, `_b` and `_c` spans, by a running
    count."""

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
        self._label_cache = _SourceCache(cfg.cache_sources, "label")
        # per-source textural inputs (transformed image, transformed label,
        # feature-code table, and the label plane and codes by label value
        # on the device: textural_edit.SourceInputs) — recompute elision
        # for pairs sharing a source
        self._src_cache = _SourceCache(cfg.cache_sources, "source")
        # per-source de-render encode (objs, blob) — edit-independent
        self._encode_cache = _SourceCache(cfg.cache_sources, "encode")
        self._requests = 0
        self._chunks = 0

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

    @contextlib.contextmanager
    def _stage(self, name: str):
        """The `stage.<name>` span; its wall seconds add to stage_s."""
        t0 = time.time_ns()
        with phases.phase("stage." + name):
            yield
        self.stage_s[name] = (self.stage_s.get(name, 0.0)
                              + (time.time_ns() - t0) / 1e9)

    def labels(self, image_rgb: np.ndarray,
               cache_key: Optional[str] = None) -> np.ndarray:
        """Semantic stage: multi-scale argmax labels [H, W] uint8 (one
        device pass from the uint8 frame)."""
        if cache_key is not None:
            cached = self._label_cache.get(cache_key)
            if cached is not None:
                return cached
        from sdn3d_tpu_torch.pipelines.semantic import multiscale_labels_fused
        with self._stage("semantic"), phases.phase("sem.infer"):
            pred = multiscale_labels_fused(
                self.semantic_model, np.ascontiguousarray(image_rgb),
                scales=tuple(self.cfg.scales), device=self.device)
            phases.add_bytes("sem.infer", pred)
        phases.count("count.semantic_pass")
        if cache_key is not None:
            self._label_cache.put(cache_key, pred)
        return pred

    def _detector(self):
        if self.detector is None:
            raise ValueError(_NO_DETECTOR)
        return self.detector

    def _kept(self, unmolded):
        """One frame's unmolded detections capped to the derenderer's
        slots as cli/geometric_main caps them, pasted and counted."""
        from sdn3d_tpu_torch.pipelines.derender_infer import \
            keep_largest_unmolded
        dets = keep_largest_unmolded(self.infer_cfg, unmolded)
        phases.count("count.det.kept", len(dets[0]))
        return dets

    def detect(self, image_rgb: np.ndarray):
        """Mask R-CNN objects of one frame, capped to the derenderer's
        slots."""
        with self._stage("detect"), phases.phase("det.detect"):
            det = self._detector()
            return self._kept(det.unmold(det.detect_begin(image_rgb)))

    def detect_missing(self, requests, dets_list) -> list:
        """`dets_list` with every None filled by ONE batched detection
        pass over those requests, padded to the chunk's size
        (detect_begin_batch), so every chunk of a size runs the same
        batch; nothing runs when none is missing."""
        idx = [i for i, d in enumerate(dets_list) if d is None]
        if not idx:
            return dets_list
        dets_list = list(dets_list)
        with self._stage("detect"), phases.phase("det.detect"):
            det = self._detector()
            outs = det.unmold_batch(det.detect_begin_batch(
                [requests[i]["image_rgb"] for i in idx],
                pad_to=len(requests)))
            for i, out in zip(idx, outs):
                dets_list[i] = self._kept(out)
        return dets_list

    def _encoded(self, image_rgb: np.ndarray, dets,
                 cache_key: Optional[str]):
        """The frame's derender_encode (object prep + encoder +
        refinement), from the per-source cache when it holds the frame,
        else run and put there."""
        encoded = (self._encode_cache.get(cache_key)
                   if cache_key is not None else None)
        if encoded is None:
            from sdn3d_tpu_torch.pipelines.derender_infer import \
                derender_encode
            class_ids, masks, rois = dets
            encoded = derender_encode(self.derender_model, image_rgb,
                                      class_ids, masks, rois, self.infer_cfg,
                                      device=self.device, bank=self.bank)
            phases.count("count.encode")
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
        from sdn3d_tpu_torch.pipelines.derender_infer import derender_image
        class_ids, masks, rois = dets
        with self._stage("geometric"):
            encoded = self._encoded(image_rgb, dets, cache_key)
            return derender_image(
                self.derender_model, self.bank, image_rgb, class_ids, masks,
                rois, self.infer_cfg, operations=operations, encoded=encoded,
                device=self.device,
                small_plan=self._small_plan(image_rgb.shape))

    def _source_inputs(self, image_rgb: np.ndarray, label: np.ndarray,
                       cache_key: Optional[str]):
        """The textural source inputs (transforms + feature encode), from
        the per-source cache when it holds the frame."""
        from PIL import Image

        from sdn3d_tpu_torch.pipelines.textural_edit import \
            prepare_source_inputs
        cached = (self._src_cache.get(cache_key)
                  if cache_key is not None else None)
        if cached is None:
            with phases.phase("tex.prepare"):
                cached = prepare_source_inputs(
                    self.textural_trainer, Image.fromarray(image_rgb),
                    Image.fromarray(label.astype(np.uint8)),
                    self.cfg.load_size, self._wh)
            phases.count("count.source_prep")
            if cache_key is not None:
                self._src_cache.put(cache_key, cached)
        return cached

    @staticmethod
    def _tex_item(source_inputs, geo: Dict[str, object]) -> Dict[str, object]:
        """One generate_edit_batch item: the source inputs and the edited
        planes, device-downsized (`instance_small`) or the full-resolution
        bytes the host resizes with PIL."""
        from PIL import Image
        with phases.phase("tex.quantize"):
            item = {"base_img_t": source_inputs.image,
                    "base_label": source_inputs.label,
                    "json_obj": geo["json_obj"],
                    "feats": source_inputs.feats,
                    "source": source_inputs.table}
            if "instance_small" in geo:
                item["inst_small"] = geo["instance_small"]
                item["normal_small"] = geo["normal_small"]
            else:
                item["inst_img"] = Image.fromarray(geo["instance_png"])
                item["normal_img"] = Image.fromarray(geo["normal_png"])
        return item

    def _generate_items(self, items):
        from sdn3d_tpu_torch.pipelines.textural_edit import \
            generate_edit_batch
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
        with self._stage("textural"):
            item = self._tex_item(self._source_inputs(image_rgb, label,
                                                      cache_key), geo_out)
            fakes, maps = self._generate_items([item])
        return fakes[0], maps[0]

    # -- fused frame ------------------------------------------------------

    def edit_frame(self, image_rgb: np.ndarray,
                   operations: Optional[List[dict]] = None,
                   dets=None, label: Optional[np.ndarray] = None,
                   cache_key: Optional[str] = None) -> Dict[str, object]:
        """One source frame through all three branches, in memory.

        `dets` is (class_ids, masks, rois) (e.g. VKITTI GT); when None
        the chain's Mask R-CNN detector runs.  Returns label, the dets the
        geometric stage used, geometric outputs, and the generated frame
        [fine_h, fine_w, 3] in [-1, 1]."""
        self._requests += 1
        with phases.phase("chain.request", self._requests):
            if label is None:
                label = self.labels(image_rgb, cache_key=cache_key)
            if dets is None:
                dets = self.detect(image_rgb)
            geo = self.derender(image_rgb, dets, operations,
                                cache_key=cache_key)
            fake, maps = self.generate(image_rgb, label, geo,
                                       cache_key=cache_key)
        return {"label": label, "dets": dets, "geo": geo, "fake": fake,
                "maps": maps}

    def edit_frames(self, requests: Sequence[Dict[str, object]]
                    ) -> List[Dict[str, object]]:
        """One chunk of N (source, operations) pairs through the three
        stages: ONE render of the N frames' slots (one forward-rasterizer
        launch at 16 * N images) and ONE generator forward
        (generate_edit_batch).  Each request takes edit_frame's keys
        (image_rgb, operations, dets, label, cache_key); the outputs are
        edit_frame's, pair by pair."""
        return self._stage_c(self._stage_b(self._stage_a(requests)))

    # -- the chunk's stages -------------------------------------------------

    @staticmethod
    def _frame(request, dets, encoded=None) -> Dict[str, object]:
        """A request's frame for derender_encode_batch_begin and
        derender_render_begin."""
        class_ids, masks, rois = dets
        return {"image_rgb": request["image_rgb"], "class_ids": class_ids,
                "image_masks": masks, "rois": rois,
                "operations": request.get("operations"), "encoded": encoded}

    def _stage_a(self, requests: Sequence[Dict[str, object]]):
        """Stage A: enqueue the chunk's semantic passes, detect (one
        batched pass for the det-less requests; the crops need its masks,
        so stage A waits for it), prepare the object crops and enqueue the
        encoders, each copy to the host started without waiting
        (HostFetch).  Returns as soon as the card's queue holds the work.
        A request that carries `label` runs no semantic pass; under
        refinement (num_opts > 0) a missed encode runs at once."""
        from sdn3d_tpu_torch.pipelines.derender_infer import (
            derender_encode_batch_begin)
        from sdn3d_tpu_torch.pipelines.semantic import multiscale_labels_begin

        self._chunks += 1
        keys = [r.get("cache_key") for r in requests]
        with phases.phase("chain.stage_a", self._chunks):
            with self._stage("semantic"):
                labels, label_misses = self._label_cache.lookup(
                    keys, given=[r.get("label") for r in requests])
                label_fetches = []
                for i, *_ in label_misses:
                    with phases.phase("sem.infer"):
                        fetch = multiscale_labels_begin(
                            self.semantic_model,
                            np.ascontiguousarray(requests[i]["image_rgb"]),
                            scales=tuple(self.cfg.scales),
                            device=self.device)
                        phases.add_bytes("sem.infer", fetch)
                    phases.count("count.semantic_pass")
                    label_fetches.append(fetch)

            with self._stage("geometric"):
                dets_list = self.detect_missing(
                    requests, [r.get("dets") for r in requests])
                given = None
                if self.infer_cfg.num_opts:
                    # refinement has no overlapped path: encode now
                    given = [self._encoded(r["image_rgb"], dets, key)
                             for r, dets, key in zip(requests, dets_list,
                                                     keys)]
                encoded, enc_misses = self._encode_cache.lookup(
                    keys, given=given)
                frames = [self._frame(requests[i], dets_list[i])
                          for i, *_ in enc_misses]
                enc_pending = (derender_encode_batch_begin(
                    self.derender_model, frames, self.infer_cfg,
                    device=self.device) if frames else [])
                phases.count("count.encode", len(frames))
        return {"requests": requests, "keys": keys, "labels": labels,
                "label_misses": label_misses, "label_fetches": label_fetches,
                "dets_list": dets_list, "encoded": encoded,
                "enc_misses": enc_misses, "enc_pending": enc_pending,
                "chunk": self._chunks}

    def _stage_b(self, a):
        """Stage B: take stage A's copies, apply the edit ops on the host,
        enqueue the chunk's render (its copy started), and prepare the
        textural source inputs (every source's netE enqueued before any
        copy is waited for)."""
        from PIL import Image

        from sdn3d_tpu_torch.pipelines.derender_infer import (
            derender_encode_batch_finish, derender_render_begin)
        from sdn3d_tpu_torch.pipelines.textural_edit import (
            prepare_source_begin, prepare_source_finish)

        requests, keys = a["requests"], a["keys"]
        with phases.phase("chain.stage_b", a["chunk"]):
            with self._stage("semantic"):
                labels = self._label_cache.fill(
                    keys, a["labels"], a["label_misses"],
                    [fetch.result() for fetch in a["label_fetches"]])

            with self._stage("geometric"):
                encoded = self._encode_cache.fill(
                    keys, a["encoded"], a["enc_misses"],
                    derender_encode_batch_finish(a["enc_pending"]))
                frames = [self._frame(r, dets, enc) for r, dets, enc in
                          zip(requests, a["dets_list"], encoded)]
                pending_render = derender_render_begin(
                    self.derender_model, self.bank, frames, self.infer_cfg,
                    small_plan=self._small_plan(frames[0]["image_rgb"].shape),
                    device=self.device)

            with self._stage("textural"):
                prepared, misses = self._src_cache.lookup(keys)
                pending = []
                for i, *_ in misses:
                    with phases.phase("tex.prepare"):
                        pending.append(prepare_source_begin(
                            self.textural_trainer,
                            Image.fromarray(requests[i]["image_rgb"]),
                            Image.fromarray(labels[i].astype(np.uint8)),
                            self.cfg.load_size, self._wh))
                    phases.count("count.source_prep")
                results = []
                for p in pending:
                    with phases.phase("tex.prepare"):
                        results.append(prepare_source_finish(p))
                prepared = self._src_cache.fill(keys, prepared, misses,
                                                results)
        return {"labels": labels, "dets_list": a["dets_list"],
                "pending_render": pending_render,
                "prepared": prepared, "chunk": a["chunk"]}

    def _stage_c(self, b) -> List[Dict[str, object]]:
        """Stage C: take the chunk's packed render, assemble the textural
        conditioning and generate."""
        from sdn3d_tpu_torch.pipelines.derender_infer import (
            derender_render_finish)

        with phases.phase("chain.stage_c", b["chunk"]):
            with self._stage("geometric"):
                geos = derender_render_finish(b["pending_render"])

            with self._stage("textural"):
                items = [self._tex_item(prep, geo)
                         for prep, geo in zip(b["prepared"], geos)]
                fakes, maps_list = self._generate_items(items)
        return [{"label": label, "dets": dets, "geo": geo, "fake": fake,
                 "maps": maps}
                for label, dets, geo, fake, maps in
                zip(b["labels"], b["dets_list"], geos, fakes, maps_list)]

    def edit_frames_pipelined(self, chunks):
        """Generator: run chunks of requests through a 3-deep software
        pipeline and yield each chunk's outputs in order.

        Stage A (semantic + detection + crop prep + encoder, copies in
        flight) runs two chunks ahead of the yield; stage B (edit ops +
        the chunk's render + textural source prep) one chunk ahead; stage
        C (the packed planes + generate) yields.  The card's queue holds
        the next chunks' work while the host packages and scores the
        current one.  Each chunk runs the stages of edit_frames, so its
        outputs are edit_frames'; only the host's order differs.  The
        per-stage stage_s walls overlap under this scheduling and no
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

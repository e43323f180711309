"""The edit-time textural conditioning built from lookup tables
(sdn3d_tpu_torch/ops/edit_conditioning.py) against the host assembly it
replaces on the serving path: the plain twin array for array against the
JAX package's assemble_edit_conditioning and against `host_assembly`
below (the same numpy assembly over the port's textural_data, which the
port's generate_edit_batch ran before), and generate_edit_batch's fakes
and maps against the host-assembled generator input.  CPU only; the
kernel's side is in tests/test_torch_cuda.py, which imports the cases and
the JAX-free helpers from here."""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from sdn3d_tpu_torch.cli import edit_vkitti as TE
from sdn3d_tpu_torch.data.textural_data import (POSE_BINS,
                                                assemble_condition_maps,
                                                dense_instance_slots,
                                                transform_image)
from sdn3d_tpu_torch.ops import edit_conditioning as EC
from sdn3d_tpu_torch.pipelines import textural as TT
from sdn3d_tpu_torch.utils import phases
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FEAT = 5


def _source(rng, H, W, values):
    """A source label plane over `values` in blocks of columns."""
    cols = np.array_split(np.arange(W), len(values))
    lab = np.zeros((H, W), np.int32)
    for v, c in zip(values, cols):
        lab[:, c] = v
    noise = rng.rand(H, W) < 0.1
    lab[noise] = rng.choice(values, noise.sum())
    return lab


def _cars(rng, H, W, ks, json_ks=None, int_keys=False, classes=None,
          alphas=None):
    """An instance plane with a box per k in `ks` (later boxes occlude
    earlier ones) and the JSON of `json_ks` (default: ks)."""
    inst = np.zeros((H, W), np.uint8)
    for k in ks:
        y, x = rng.randint(0, H - 4), rng.randint(0, W - 6)
        inst[y:y + rng.randint(3, max(4, H // 3)),
             x:x + rng.randint(5, max(6, W // 3))] = k
    json_ks = list(ks) if json_ks is None else json_ks
    obj = {}
    for j, k in enumerate(json_ks):
        obj[k if int_keys else str(k)] = {
            "class_id": classes[j] if classes else 1,
            "alpha": alphas[j] if alphas else float(rng.uniform(-np.pi,
                                                                np.pi))}
    return inst, obj


def _normal(rng, H, W):
    return rng.randint(0, 256, (H, W, 3)).astype(np.uint8)


EDGES = [-np.pi, np.pi, 0.0] + [float(e * np.pi) for e in POSE_BINS] + [
    float(np.nextafter(e * np.pi, np.inf)) for e in POSE_BINS]

CASES = ("cars0", "cars5", "cars16", "int_keys", "absent", "van_unknown",
         "bin_edges", "labels_13_14_255", "overflow", "no_normal",
         "two_sources")


def make_case(name, H, W, seed=0):
    """(sources: list of [H, W] int32 label maps, frames: list of dicts
    with inst [H, W] uint8, normal uint8 or None, json_obj, src index)."""
    rng = np.random.RandomState(seed + sum(map(ord, name)))
    base = [0, 1, 3, 9, 10, 11, 12]          # car 1 -> 2 -> 5, van 11 -> 12
    sources = [_source(rng, H, W, base)]
    frames = []
    if name == "cars0":
        frames.append({"inst": np.zeros((H, W), np.uint8), "json_obj": {}})
    elif name in ("cars5", "cars16", "int_keys", "no_normal"):
        n = 16 if name == "cars16" else 5
        inst, obj = _cars(rng, H, W, range(1, n + 1),
                          int_keys=name != "cars5")
        frames.append({"inst": inst, "json_obj": obj})
    elif name == "absent":
        inst, obj = _cars(rng, H, W, [1, 2, 9], json_ks=[1, 2, 7])
        frames.append({"inst": inst, "json_obj": obj})
    elif name == "van_unknown":
        inst, obj = _cars(rng, H, W, [1, 2, 3], classes=[2, 5, 1])
        frames.append({"inst": inst, "json_obj": obj})
    elif name == "bin_edges":
        ks = list(range(1, len(EDGES) + 1))
        inst, obj = _cars(rng, H, W, ks, alphas=EDGES)
        frames.append({"inst": inst, "json_obj": obj})
    elif name == "labels_13_14_255":
        sources = [_source(rng, H, W, [1, 11, 13, 14, 255])]
        inst, obj = _cars(rng, H, W, [1, 4])
        frames.append({"inst": inst, "json_obj": obj})
    elif name == "overflow":
        # 70 label values + 3 cars: more ids than the default 64 slots
        sources = [_source(rng, H, W, list(range(70)))]
        inst, obj = _cars(rng, H, W, [1, 2, 3])
        frames.append({"inst": inst, "json_obj": obj})
    elif name == "two_sources":
        sources.append(_source(rng, H, W, [2, 4, 6, 8, 11]))
        for src in (0, 1, 0):
            inst, obj = _cars(rng, H, W, range(1, 4 + src))
            frames.append({"inst": inst, "json_obj": obj, "src": src})
    for f in frames:
        f.setdefault("src", 0)
        f["normal"] = None if name == "no_normal" else _normal(rng, H, W)
    return sources, frames


def twin_inputs(sources, frames, feats, max_instances, device):
    """The twin's / kernel's inputs for a case: each frame's planes and
    object table, each source's label plane and code table."""
    tables = [EC.source_table(s, dense_instance_slots(s, max_instances)[1],
                              torch.from_numpy(f).to(device))
              for s, f in zip(sources, feats)]
    dev = torch.device(device)
    inst = torch.from_numpy(np.stack([f["inst"] for f in frames])).to(dev)
    src_labels = torch.stack([t.label for t in tables])
    src_index = torch.tensor([f["src"] for f in frames], dtype=torch.int32,
                             device=dev)
    obj = torch.from_numpy(np.stack([EC.frame_table(f["json_obj"])
                                     for f in frames])).to(dev)
    codes = torch.stack([t.codes for t in tables])
    return inst, src_labels, src_index, obj, codes


def host_assembly(base_label, inst_raw, json_obj, normal_u8, feats,
                  max_instances):
    """One frame's conditioning assembled on the host, numpy throughout
    (edit_vkitti.py:62-107): assemble_condition_maps, dense_instance_slots
    of the target ids and of the source's, and each target slot's source
    code by matching id.  Returns (maps, slots, feat_table)."""
    maps = assemble_condition_maps(base_label, inst_raw, json_obj, normal_u8)
    if normal_u8 is None:
        maps["normal"] = np.zeros(base_label.shape + (3,), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        slots, mapping = dense_instance_slots(maps["inst"], max_instances)
        _, src_mapping = dense_instance_slots(np.asarray(base_label),
                                              max_instances)
    feat_table = np.zeros((max_instances, feats.shape[1]), np.float32)
    for inst_id, slot in mapping.items():
        src_slot = src_mapping.get(inst_id)
        if src_slot is not None:
            feat_table[slot] = feats[src_slot]
    return maps, slots, feat_table


def host_frames(sources, frames, feats, max_instances):
    """host_assembly of each frame of a case."""
    return [host_assembly(sources[f["src"]], f["inst"], f["json_obj"],
                          f["normal"], feats[f["src"]], max_instances)
            for f in frames]


def jax_frames(sources, frames, feats, max_instances):
    """The JAX package's assemble_edit_conditioning of each frame (its
    device-downsized planes' entry), with the case's source code tables:
    (maps, slots, feat_table, normal_u8, inst_raw) a frame."""
    from sdn3d_tpu.cli import edit_vkitti as JE

    trainer = SimpleNamespace(cfg=SimpleNamespace(
        max_instances=max_instances, feat_num=FEAT))
    H, W = frames[0]["inst"].shape
    args = SimpleNamespace(load_size=W)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for f in frames:
            out.append(JE.assemble_edit_conditioning(
                trainer, None, np.zeros((H, W, 3), np.float32),
                sources[f["src"]], None, f["json_obj"], None, (W, H), args,
                feats=feats[f["src"]], inst_small=f["inst"],
                normal_small=f["normal"]))
    return out


def case_feats(sources, max_instances, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (max_instances, FEAT)).astype(np.float32)
            for _ in sources]


def assert_matches_host(cond, host, frames):
    """Each frame of a Conditioning (numpy-able tensors) against its host
    assembly (maps, slots, feat_table, ...): the label as the generator
    was given it (uint8, so 256 is 0), the id map the generator rebuilds
    from it and the raw instance plane, pose, slots and the code table."""
    for i, (maps, slots, feat_table, *_) in enumerate(host):
        label = cond.label[i].cpu().numpy()
        np.testing.assert_array_equal(label, maps["label"].astype(np.uint8),
                                      err_msg="label")
        k = frames[i]["inst"].astype(np.int32)
        full = np.where(k == 0, np.where(label == 0, 256,
                                         label.astype(np.int32)), k * 1000)
        np.testing.assert_array_equal(full, maps["inst"], err_msg="inst")
        np.testing.assert_array_equal(cond.pose[i].cpu().numpy(),
                                      maps["pose"], err_msg="pose")
        np.testing.assert_array_equal(cond.slots[i].cpu().numpy(), slots,
                                      err_msg="inst_slots")
        np.testing.assert_array_equal(cond.feat[i].cpu().numpy(),
                                      feat_table, err_msg="feature table")
        assert int(cond.nids[i]) == len(np.unique(maps["inst"]))


@pytest.mark.parametrize("name", CASES)
def test_plain_twin_matches_host_assembly(name):
    """label, inst, pose, inst_slots and the code table of the twin equal
    the JAX package's assemble_edit_conditioning's, frame by frame, at 64
    slots, and so does host_assembly (with the uint8 planes the JAX
    function returns equal to the case's)."""
    M = 64
    sources, frames = make_case(name, 48, 80)
    feats = case_feats(sources, M)
    cond = EC.edit_conditioning(*twin_inputs(sources, frames, feats, M,
                                             "cpu"), M)
    assert cond.label.dtype == cond.pose.dtype == cond.slots.dtype \
        == torch.uint8
    jax = jax_frames(sources, frames, feats, M)
    assert_matches_host(cond, jax, frames)
    for f, (maps, slots, feat_table, normal_u8, inst_raw), mine in zip(
            frames, jax, host_frames(sources, frames, feats, M)):
        np.testing.assert_array_equal(inst_raw, f["inst"])
        if f["normal"] is None:
            assert normal_u8 is None
        else:
            np.testing.assert_array_equal(normal_u8, f["normal"])
        for a, b in zip(mine, (maps, slots, feat_table)):
            if isinstance(b, dict):
                assert set(a) == set(b)
                for key in b:
                    np.testing.assert_array_equal(a[key], b[key],
                                                  err_msg=key)
            else:
                np.testing.assert_array_equal(a, b)
    if name == "overflow":
        assert int(cond.nids[0]) > M
        ids = jax[0][0]["inst"]
        over = np.isin(ids, np.unique(ids)[M:])
        assert over.any() and (cond.slots[0].numpy()[over] == 0).all()
    if name == "labels_13_14_255":
        assert (jax[0][0]["label"] == 256).any()


def test_frame_table_follows_the_json_order_and_ignores_foreign_indices():
    """A later entry of one index wins (int and str keys of one object),
    an index outside the uint8 plane marks nothing, and the pose bins are
    np.digitize's on each alpha / pi."""
    obj = {"3": {"class_id": 1, "alpha": 0.5},
           3: {"class_id": 2, "alpha": -3.0},
           "300": {"class_id": 2, "alpha": 0.1},
           "-1": {"class_id": 2, "alpha": 0.1}}
    t = EC.frame_table(obj)
    assert t.shape == (2, EC.TABLE) and t.dtype == np.uint8
    assert t[0, 3] == 12 and t[1, 3] == np.digitize(-3.0 / np.pi, POSE_BINS)
    assert np.count_nonzero(t) == 2


def _small_trainer(max_instances=8):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return TT.TexturalTrainer(TT.TexturalConfig(
            **dict(TT.SMALL_NET_OVERRIDES, max_instances=max_instances)))


def host_generate(trainer, items, wh, args):
    """The host-assembled generator input, as generate_edit_batch built it
    before the device conditioning: host_assembly a frame (the PIL
    transform first for full-resolution planes), its maps uploaded at
    uint8 with the raw instance plane (which fake_inference rebuilds to
    k * 1000), then fake_inference.  Returns (fakes [N, H, W, 3], the
    frames' maps)."""
    M = trainer.cfg.max_instances
    frames = []
    for it in items:
        inst, normal = it.get("inst_small"), it.get("normal_small")
        if inst is None:
            inst = (np.asarray(transform_image(
                it["inst_img"], args.load_size, wh, nearest=True,
                normalize=False)) * 255.0).astype(np.int32)[..., 0]
            if it.get("normal_img") is not None:
                normal = (np.asarray(transform_image(
                    it["normal_img"].convert("RGB"), args.load_size, wh,
                    normalize=False)) * 255.0).astype(np.uint8)
        inst = np.asarray(inst).astype(np.uint8)
        frames.append((inst, normal) + host_assembly(
            np.asarray(it["base_label"]), inst, it["json_obj"], normal,
            np.asarray(it["feats"], np.float32), M))
    host = {
        "label": np.stack([f[2]["label"] for f in frames]).astype(np.uint8),
        "inst": np.stack([f[0] for f in frames]),
        "inst_slots": np.stack([f[3] for f in frames]).astype(np.uint8),
        "pose": np.stack([f[2]["pose"] for f in frames]).astype(np.uint8),
        "normal": np.stack([
            f[1] if f[1] is not None
            else np.zeros(it["base_img_t"].shape, np.uint8)
            for f, it in zip(frames, items)]),
        "normal_valid": np.asarray([f[1] is not None for f in frames],
                                   np.float32)}
    dev = trainer.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    table = torch.from_numpy(np.stack([f[4] for f in frames])).to(dev)
    fakes = trainer.fake_inference(batch, table).cpu().numpy()
    return fakes, [f[2] for f in frames]


def case_items(name, H, W, max_instances, seed=0):
    """generate_edit_batch items of a case (device-downsized planes)."""
    sources, frames = make_case(name, H, W, seed)
    feats = case_feats(sources, max_instances)
    rng = np.random.RandomState(seed + 7)
    images = [rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
              for _ in sources]
    return [{"base_img_t": images[f["src"]], "base_label": sources[f["src"]],
             "feats": feats[f["src"]], "json_obj": f["json_obj"],
             "inst_small": f["inst"], "normal_small": f["normal"]}
            for f in frames]


def assert_same_output(got, want):
    (fakes, maps), (wfakes, wmaps) = got, want
    np.testing.assert_array_equal(np.stack(fakes), wfakes)
    for m, w in zip(maps, wmaps):
        assert set(m) == set(w)
        for k in w:
            np.testing.assert_array_equal(m[k], w[k], err_msg=k)
            assert m[k].dtype == w[k].dtype, k


@pytest.mark.parametrize("name", ["cars0", "cars5", "absent", "van_unknown",
                                  "labels_13_14_255", "no_normal",
                                  "two_sources"])
def test_generate_edit_batch_equals_the_host_assembly(name):
    """generate_edit_batch through the device conditioning (the twin on the
    CPU) gives the host-assembled path's fakes to the bit and its maps,
    raw label 255 included (label 256, given to the generator as 0)."""
    trainer = _small_trainer()
    H, W = 32, 48
    items = case_items(name, H, W, 8)
    args = SimpleNamespace(load_size=W)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = host_generate(trainer, items, (W, H), args)
        got = TE.generate_edit_batch(trainer, items, (W, H), args)
    assert_same_output(got, want)


def test_generate_edit_from_images_full_resolution_planes():
    """The full-resolution PIL planes (the file contract's entry) go
    through the host transform and the same device conditioning: fakes and
    maps equal the host assembly's, with and without a normal map, with
    the source prepared once (SourceInputs) or built from base_label and
    the code table."""
    rng = np.random.RandomState(6)
    trainer = _small_trainer()
    H, W, wh = 120, 200, (80, 48)
    src = Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8))
    lab = Image.fromarray(rng.randint(0, 4, (H, W)).astype(np.uint8))
    inst = np.zeros((H, W), np.uint8)
    inst[40:90, 30:120] = 1
    inst[60:110, 100:180] = 2
    normal = Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8))
    json_obj = {"1": {"class_id": 1, "alpha": 0.4},
                "2": {"class_id": 2, "alpha": -2.0}}
    args = SimpleNamespace(load_size=80)
    prepared = TE.prepare_source_inputs(trainer, src, lab, 80, wh)
    for nimg in (normal, None):
        item = {"base_img_t": prepared.image, "base_label": prepared.label,
                "feats": prepared.feats, "json_obj": json_obj,
                "inst_img": Image.fromarray(inst), "normal_img": nimg}
        want = host_generate(trainer, [item], wh, args)
        for source in (prepared.table, None):
            fake, maps = TE.generate_edit_from_images(
                trainer, prepared.image, prepared.label,
                Image.fromarray(inst), json_obj, nimg, wh, args,
                feats=prepared.feats, source=source)
            assert_same_output(([fake], [maps]), want)


def test_overflow_warns_from_the_fetched_count():
    """More distinct ids than slots: generate_edit_batch warns as
    dense_instance_slots does, and the fakes still equal the host path's
    (overflow ids at slot 0 on both)."""
    trainer = _small_trainer()
    items = case_items("overflow", 32, 48, 8)
    args = SimpleNamespace(load_size=48)
    with pytest.warns(UserWarning, match="overflow ids share slot 0"):
        got = TE.generate_edit_batch(trainer, items, (48, 32), args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = host_generate(trainer, items, (48, 32), args)
    assert_same_output(got, want)


def test_counters_and_lazy_maps():
    """The twin on the CPU counts its frames in `count.tex.assemble.host`
    and none on the device; the maps are computed on first access only,
    from host arrays: a kept result holds no tensor."""
    trainer = _small_trainer()
    items = case_items("two_sources", 32, 48, 8)
    args = SimpleNamespace(load_size=48)
    phases.reset(True)
    try:
        _, maps = TE.generate_edit_batch(trainer, items, (48, 32), args)
        snap = phases.snapshot()
    finally:
        phases.reset(False)
    assert snap["count.tex.assemble.host"]["n"] == 3
    assert "count.tex.assemble.device" not in snap
    assert "tex.assemble" in snap and "tex.generate" in snap
    assert maps[0]._maps is None
    assert not any(isinstance(v, torch.Tensor) for v in maps[0]._src)
    assert "normal" in maps[0] and maps[0]._maps is None
    assert maps[0]["label"].dtype == np.int32 and maps[0]._maps is not None
    assert list(maps[0]) == ["label", "inst", "pose", "normal"]


def test_source_table_rejects_labels_outside_a_byte():
    with pytest.raises(ValueError, match="source label values"):
        EC.source_table(np.full((2, 2), 256, np.int32), {256: 0},
                        torch.zeros(8, FEAT))

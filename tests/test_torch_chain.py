"""The port's fused edit chain (sdn3d_tpu_torch.pipelines.chain,
cli.edit_chain) against the JAX package's, on the CPU, on the synthetic
VKITTI fixture at the shapes of tests/test_chain.py (scale 100, image and
render size 64, 160x96 textural frames, SMALL_NET_OVERRIDES): both chains
are built from the same models — JAX's random weights, converted with
utils/port — and the same synthetic mesh bank."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

# two edit pairs sharing a source frame, and their reconstruction twins
# (tests/test_chain.py:22-43)
ITEMS = [
    {"world": "0006", "topic": "fog", "source": "00055",
     "target": "00050",
     "operations": [
         {"type": "modify", "from": {"u": "750.9", "v": "213.9"},
          "to": {"u": "804.4", "v": "227.1",
                 "roi": [194, 756, 269, 865]},
          "zoom": "1.338", "ry": "0.007"},
         {"type": "delete", "from": {"u": "300.0", "v": "200.0"},
          "to": None, "zoom": None, "ry": None}]},
    {"world": "0006", "topic": "fog", "source": "00055",
     "target": "00060",
     "operations": [
         {"type": "modify", "from": {"u": "750.9", "v": "213.9"},
          "to": {"u": "650.0", "v": "210.0",
                 "roi": [190, 600, 260, 700]},
          "zoom": "0.9", "ry": "0.4"}]},
    {"world": "0006", "topic": "fog", "source": "00055",
     "target": "00055", "operations": []},
    {"world": "0006", "topic": "fog", "source": "00060",
     "target": "00060", "operations": []},
]
SMALL = dict(scales=(100,), image_size=64, render_size=64, load_size=160,
             fine_width=160, fine_height=96)

# The fake [48, 160, 3] in [-1, 1] and its L1 on the same conditioning:
# the two generators' float32 sums (measured max |diff| 1.2e-5 .. 2.2e-5).
FAKE_ATOL = 1e-4
L1_ATOL = 1e-5
# Where the conditioning differs by a few normal bytes or instance pixels
# (measured max |diff| up to 3.7e-3, mean up to 6e-5):
FAKE_E2E_MAX = 5e-2
FAKE_E2E_MEAN = 1e-3


def _mesh_bank_files(root):
    """The synthetic bank of tests/test_torch_derender_infer.py in the
    ShapeNet layout, so both packages' loaders read the same meshes."""
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    v, f = make_sphere_mesh(6, 12)
    for cls, obj in SHAPENET_CARS:
        d = os.path.join(root, cls, obj, "models")
        os.makedirs(d, exist_ok=True)
        save_obj(os.path.join(d, "model_normalized.obj"), v, f)
    return root


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from make_vkitti_fixture import build_fixture

    work = tmp_path_factory.mktemp("torch_chain")
    root = str(work / "vkitti")
    edit_json = str(work / "edit.json")
    with open(edit_json, "w") as f:
        json.dump(ITEMS, f)
    build_fixture(root, edit_json)
    shapenet = _mesh_bank_files(str(work / "shapenet"))
    return work, root, edit_json, shapenet


@pytest.fixture(scope="module")
def chains(env):
    """(JAX EditChain, port EditChain) built from tuples of the same
    models: the full-width SemanticModel, the 8-class derenderer with the
    synthetic bank, and the textural nets at SMALL_NET_OVERRIDES."""
    from sdn3d_tpu.geometry.assets import load_shapenet_bank as j_load_bank
    from sdn3d_tpu.models.derenderer import Derenderer as JDerenderer
    from sdn3d_tpu.models.derenderer import DeviceMeshBank as JBank
    from sdn3d_tpu.models.semantic import SemanticModel as JSemantic
    from sdn3d_tpu.pipelines import chain as JC
    from sdn3d_tpu.pipelines import textural as JT
    from sdn3d_tpu_torch.geometry.assets import load_shapenet_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
    from sdn3d_tpu_torch.models.semantic import SemanticModel
    from sdn3d_tpu_torch.pipelines import chain as TC
    from sdn3d_tpu_torch.pipelines import textural as TT
    from sdn3d_tpu_torch.utils import port

    _, _, _, shapenet = env
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jsem = JSemantic(num_class=14)
    sv = tree(jsem.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        train=False))
    jder = JDerenderer(num_classes=8)
    dv = tree(jder.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
                        jnp.zeros((1, 2)), jnp.zeros((1, 2)), train=False))
    tcfg = JT.TexturalConfig(**JT.SMALL_NET_OVERRIDES)
    jtex = JT.TexturalTrainer(tcfg)
    pg = tree(jtex.netG.init(jax.random.PRNGKey(2), jnp.zeros(
        (1, 96, 160, tcfg.netG_input_nc)))["params"])
    pe = tree(jtex.netE.init(jax.random.PRNGKey(3),
                             jnp.zeros((1, 96, 160, 3)))["params"])
    state = JT.TexturalState(step=jnp.zeros((), jnp.int32), params_g=pg,
                             params_d={}, params_e=pe, vgg={}, opt_g={},
                             opt_d={}, params_ge={})
    jchain = JC.EditChain(JC.ChainConfig(small_fetch=False, **SMALL),
                          (jsem, sv),
                          (jder, dv, JBank.from_host(j_load_bank(shapenet))),
                          (jtex, state))

    tsem = SemanticModel(num_class=14)
    enc, dec = port.semantic_state_dicts_from_jax(sv)
    tsem.encoder.load_state_dict(enc)
    tsem.decoder.load_state_dict(dec)
    tder = Derenderer(num_classes=8)
    tder.load_state_dict(port.derenderer_state_dict_from_jax(dv))
    ttex = TT.TexturalTrainer(TT.TexturalConfig(**TT.SMALL_NET_OVERRIDES))
    ttex.load_state_dicts(
        port.global_generator_state_dict_from_jax(
            pg, tcfg.n_downsample_global, tcfg.n_blocks_global),
        port.encoder_state_dict_from_jax(pe, tcfg.n_downsample_e))
    tchain = TC.EditChain(
        TC.ChainConfig(**SMALL), tsem.eval(),
        (tder.eval(), DeviceMeshBank.from_host(load_shapenet_bank(shapenet),
                                               device="cpu")),
        ttex.to("cpu"), device="cpu")
    return jchain, tchain, sv, jsem


def _requests(root, edit_json):
    from PIL import Image

    from sdn3d_tpu_torch.cli.geometric_main import _keep_largest
    from sdn3d_tpu_torch.data import vkitti as VK
    from sdn3d_tpu_torch.pipelines.derender_infer import DerenderInferConfig

    table = VK.get_tables("inst", root)
    out = []
    for item in VK.benchmark_split(VK.load_edit_json(edit_json)):
        frame = int(item.source)
        image = np.asarray(Image.open(VK.rgb_path(
            root, item.world, item.topic, frame)).convert("RGB"))
        dets = _keep_largest(DerenderInferConfig(), *VK.gt_objects(
            root, item.world, item.topic, frame, table))
        out.append((item, image, dets))
    return out


def test_vkitti_tables_and_gt_objects_match_jax(env):
    """get_tables, decode_scenegt (the port's numpy lookup against JAX's,
    native or not), gt_objects and benchmark_split on the fixture:
    equal."""
    from PIL import Image

    from sdn3d_tpu.data import vkitti as JV
    from sdn3d_tpu_torch.data import vkitti as TV

    _, root, edit_json, _ = env
    for opt in ("inst", "segm"):
        assert TV.get_tables(opt, root) == JV.get_tables(opt, root)
    table = JV.get_tables("inst", root)
    scene = np.asarray(Image.open(TV.scenegt_path(root, "0006", "fog", 55)))
    np.testing.assert_array_equal(
        TV.decode_scenegt(scene, "0006", "fog", table),
        JV.decode_scenegt(scene, "0006", "fog", table))
    got = TV.gt_objects(root, "0006", "fog", 55, table)
    want = JV.gt_objects(root, "0006", "fog", 55, table)
    assert len(got[0]) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert TV.rgb_path(root, "0006", "fog", 55) == JV.rgb_path(
        root, "0006", "fog", 55)
    assert [i.target_name for i in TV.benchmark_split(
        TV.load_edit_json(edit_json))] == [
        i.target_name for i in JV.benchmark_split(
            JV.load_edit_json(edit_json))]
    for k in ("WORLD_IDS", "SCENE_IDS", "CATEGORIES"):
        assert getattr(TV, k) == getattr(JV, k)


def test_write_vkitti_root_gives_its_cars_back(tmp_path):
    """The synthetic VKITTI root of data/synthetic.py (what the card's
    smoke run and card test write, without the JAX package's fixture
    script) reads back through both packages' data layers: the GT objects
    are the written boxes, in scenegt order, equal in both."""
    from sdn3d_tpu.data import vkitti as JV
    from sdn3d_tpu_torch.data import vkitti as TV
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root

    boxes = [(180, 300, 260, 440), (200, 700, 300, 900), (150, 20, 200, 90)]
    root = str(tmp_path)
    write_vkitti_root(root, {("0020", "rain", "00007"): boxes,
                             ("0020", "rain", "00008"): []}, seed=3)
    table = TV.get_tables("inst", root)
    assert table == JV.get_tables("inst", root)
    got = TV.gt_objects(root, "0020", "rain", 7, table)
    want = JV.gt_objects(root, "0020", "rain", 7, table)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], np.asarray(boxes, np.float32))
    np.testing.assert_array_equal(got[0], [1, 1, 1])
    assert len(TV.gt_objects(root, "0020", "rain", 8, table)[0]) == 0


def test_edit_frame_matches_jax(env, chains):
    """EditChain.edit_frame over both pairs (the second hits the per-source
    caches), stage by stage.  Labels: equal but where JAX's top two
    averaged probabilities lie within 1e-4 (tests/test_torch_semantic.py's
    raw-frame tolerance).  Geometric and textural stages on JAX's label and
    JAX's encoded blob: instance_png, the JSON keys and the conditioning
    maps equal; normal/depth planes byte-equal but for +-1 on at most 0.1%
    of values (ROADMAP.md C).  The textural stage on JAX's label and
    planes: the fake within FAKE_ATOL, its L1 against the target within
    L1_ATOL.  A normal byte off by one moves the fake near it and, through
    the instance norms, a little everywhere, so the fake on the port's own
    planes, and end to end on the port's own labels and encoder (where
    ulp differences in the crops and encoder sums may flip a few boundary
    pixels; instance maps agree on >= 99.9%), is held to FAKE_E2E_MAX
    (max |diff|) and FAKE_E2E_MEAN (mean)."""
    from PIL import Image

    from sdn3d_tpu.data.semantic_data import MEAN_BGR, STD_BGR
    from sdn3d_tpu.pipelines import semantic as JP
    from sdn3d_tpu_torch.data.textural_data import transform_image

    _, root, edit_json, _ = env
    jchain, tchain, sv, jsem = chains
    for item, image, dets in _requests(root, edit_json):
        src = item.source_name
        kw = dict(operations=item.operations, dets=dets)
        want = jchain.edit_frame(image, cache_key=src, **kw)

        label = tchain.labels(image, cache_key=src)
        flips = label != want["label"]
        print(f"{item.target_name}: label flips {int(flips.sum())} of "
              f"{flips.size}")
        if flips.any():
            norm = (image.astype(np.float32)[:, :, ::-1]
                    - np.asarray(MEAN_BGR, np.float32)) / np.asarray(
                        STD_BGR, np.float32)
            p = np.sort(np.asarray(JP.multiscale_probs_device(
                sv, jsem, norm, SMALL["scales"])), axis=-1)
            assert ((p[..., -1] - p[..., -2])[flips] <= 1e-4).all()
        assert flips.mean() < 0.01

        tchain._encode_cache.put(src, jchain._encode_cache.get(src))
        got = tchain.edit_frame(image, label=want["label"], cache_key=src,
                                **kw)
        gg, wg = got["geo"], want["geo"]
        np.testing.assert_array_equal(gg["instance_png"], wg["instance_png"])
        assert (gg["instance_png"] > 0).any()
        for k in ("normal_png", "depth_png"):
            d = np.abs(gg[k].astype(np.int64) - wg[k].astype(np.int64))
            print(f"{item.target_name}: {k} {int((d > 0).sum())} of {d.size} "
                  f"values off by one")
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, d.sum())
        assert gg["json_obj"].keys() == wg["json_obj"].keys()
        for k in ("label", "inst", "pose"):
            np.testing.assert_array_equal(got["maps"][k], want["maps"][k])
        # scale_width(160) of a 1242x375 frame is 160x48, below the
        # 160x96 fine size, so no crop: the fake is 48x160
        assert got["fake"].shape == want["fake"].shape == (48, 160, 3)
        # the textural stage on exactly JAX's conditioning (its label and
        # its planes)
        same, _ = tchain.generate(image, want["label"], wg)
        np.testing.assert_allclose(same, want["fake"], rtol=0,
                                   atol=FAKE_ATOL)
        tgt = transform_image(Image.open(os.path.join(
            root, "vkitti_1.3.1_rgb", item.world, item.topic,
            f"{item.target}.png")).convert("RGB"), 160, (160, 96))
        np.testing.assert_allclose(np.abs(same - tgt).mean(),
                                   np.abs(want["fake"] - tgt).mean(),
                                   rtol=0, atol=L1_ATOL)

        e2e = tchain.edit_frame(image, **kw)
        agree = (e2e["geo"]["instance_png"] == wg["instance_png"]).mean()
        d = np.abs(got["fake"] - want["fake"])
        d_e2e = np.abs(e2e["fake"] - want["fake"])
        print(f"{item.target_name}: fake max |diff| "
              f"{float(np.abs(same - want['fake']).max()):.3g} on JAX's "
              f"conditioning, {d.max():.3g} on the port's planes; end to end "
              f"instance agreement {agree:.6f}, fake max |diff| "
              f"{d_e2e.max():.3g}, mean {d_e2e.mean():.3g}")
        assert d.max() <= FAKE_E2E_MAX and d.mean() <= FAKE_E2E_MEAN
        assert agree >= 0.999
        assert e2e["geo"]["json_obj"].keys() == wg["json_obj"].keys()
        assert d_e2e.max() <= FAKE_E2E_MAX and d_e2e.mean() <= FAKE_E2E_MEAN
    assert set(tchain.stage_s) == {"semantic", "geometric", "textural"}
    assert all(v > 0 for v in tchain.stage_s.values())


def test_source_caches_change_no_answer(env, chains):
    """A pair served from the per-source caches (labels, encode, textural
    source inputs) equals the same pair computed afresh; the caches are
    bounded LRUs."""
    from sdn3d_tpu_torch.pipelines.chain import _SourceCache

    _, root, edit_json, _ = env
    _, tchain, _, _ = chains
    item, image, dets = _requests(root, edit_json)[1]
    kw = dict(operations=item.operations, dets=dets)
    # a key of its own: the caches filled by the port alone, then hit
    key = f"cache-test:{item.source_name}"
    tchain.edit_frame(image, cache_key=key, **kw)
    assert key in tchain._encode_cache and key in tchain._src_cache
    cached = tchain.edit_frame(image, cache_key=key, **kw)
    fresh = tchain.edit_frame(image, **kw)
    np.testing.assert_array_equal(cached["label"], fresh["label"])
    for k in ("instance_png", "normal_png", "depth_png"):
        np.testing.assert_array_equal(cached["geo"][k], fresh["geo"][k])
    np.testing.assert_array_equal(cached["fake"], fresh["fake"])

    c = _SourceCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # refreshes 'a'
    c.put("c", 3)                   # evicts 'b' (least recent)
    assert "b" not in c and c.get("a") == 1 and c.get("c") == 3


def test_chain_config_matches_cli_and_jax_defaults():
    """The port's ChainConfig defaults equal its CLIs' defaults and the
    JAX package's ChainConfig field by field, small_fetch True in both;
    EditChain rejects a compute_dtype outside {float32, bfloat16}."""
    import dataclasses

    from sdn3d_tpu.pipelines.chain import ChainConfig as JConfig
    from sdn3d_tpu_torch.cli.edit_chain import build_argparser as chain_ap
    from sdn3d_tpu_torch.cli.geometric_main import build_argparser as geo_ap
    from sdn3d_tpu_torch.cli.semantic_test import build_argparser as sem_ap
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain

    cfg = ChainConfig()
    geo = geo_ap().parse_args([])
    sem = sem_ap().parse_args(["--test_img", "x"])
    ch = chain_ap().parse_args(["--edit_json", "x"])
    assert (cfg.image_size, cfg.render_size, cfg.num_opts, cfg.mode) == (
        geo.image_size, geo.render_size, geo.num_opts, geo.mode)
    assert cfg.num_class == sem.num_class
    assert tuple(cfg.scales) == tuple(sem.scales) == tuple(ch.scales)
    for k in ("image_size", "render_size", "num_opts", "mode", "load_size",
              "fine_width", "fine_height", "compute_dtype"):
        assert getattr(cfg, k) == getattr(ch, k), k
    assert cfg.compute_dtype == geo.compute_dtype == sem.compute_dtype
    assert cfg.small_fetch is (not ch.full_fetch) is True
    jcfg = JConfig()
    names = [f.name for f in dataclasses.fields(JConfig)]
    assert names == [f.name for f in dataclasses.fields(ChainConfig)]
    for k in names:
        assert tuple(np.ravel(getattr(cfg, k))) == tuple(
            np.ravel(getattr(jcfg, k))), k
    assert cfg.small_fetch is True and jcfg.small_fetch is True
    with pytest.raises(ValueError, match="compute dtype"):
        EditChain(ChainConfig(compute_dtype="float16"), None, (None, None),
                  None)


def test_edit_chain_cli_writes_benchmark(env, tmp_path):
    """cli.edit_chain --device cpu at the small shapes (full-width models,
    random weights from --seed) writes benchmark.json with the pairs and
    finite metrics (LPIPS on a random-init backbone), the gallery and the
    dumped file contract (a full fetch); again with --batch_pairs 2
    --pipeline --lpips_ckpt (an official-layout LPIPS checkpoint), whose
    L1 / SSIM / PSNR equal the serial run's and whose LPIPS is the loaded
    model's; without --device it runs on cuda, so here it raises.  (The
    --source maskrcnn runs are tests/test_torch_chain_maskrcnn.py's.)"""
    from sdn3d_tpu_torch.cli import edit_chain

    _, root, edit_json, shapenet = env
    common = ["--edit_json", edit_json, "--data_root", root,
              "--shapenet_root", shapenet, "--scales", "100",
              "--image_size", "64", "--render_size", "64",
              "--load_size", "160", "--fine_width", "160",
              "--fine_height", "96"]
    out = str(tmp_path / "out")
    before = torch.random.get_rng_state()
    res = edit_chain.main(common + ["--device", "cpu", "--results_dir", out,
                                    "--dump_dirs", str(tmp_path / "dump"),
                                    "--phases"])
    assert torch.equal(torch.random.get_rng_state(), before)
    with open(os.path.join(out, "benchmark.json")) as f:
        saved = json.load(f)
    assert saved["pairs"] == res["pairs"] == 2
    for k in ("mean_L1", "mean_LPIPS", "mean_SSIM", "mean_PSNR", "chain_s",
              "edits_per_sec", "steady_s_per_pair"):
        assert np.isfinite(saved[k]), k
    assert saved["lpips_backbone"] == "random-init (uncalibrated)"
    assert (saved["batch_pairs"], saved["pipelined"]) == (1, False)
    assert set(saved["stage_s"]) == {"semantic", "geometric", "textural"}
    assert {"sem.infer", "geo.render", "tex.generate"} <= set(
        saved["phase_breakdown"])
    assert os.path.exists(os.path.join(out, "index.html"))
    name = "0006_fog_00055_00050"
    for suffix in (".png", "-normal.png", "-depth.png", ".json", ".pkl"):
        assert os.path.exists(tmp_path / "dump" / "geo" / f"{name}{suffix}")
    assert os.path.exists(tmp_path / "dump" / "segm" / "0006_fog_00055.png")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            edit_chain.main(common + ["--results_dir", out])
    from sdn3d_tpu_torch.models.lpips import init_lpips
    from sdn3d_tpu_torch.utils import metrics

    ckpt = str(tmp_path / "lpips_vgg.pth")
    torch.save(init_lpips(5, "cpu").state_dict(), ckpt)
    out2 = str(tmp_path / "out2")
    res2 = edit_chain.main(common + ["--device", "cpu", "--results_dir", out2,
                                     "--batch_pairs", "2", "--pipeline",
                                     "--lpips_ckpt", ckpt])
    assert (res2["batch_pairs"], res2["pipelined"]) == (2, True)
    assert res2["pairs"] == 2 and res2["lpips_backbone"] == "ported"
    for k in ("mean_L1", "mean_SSIM", "mean_PSNR"):
        assert res2[k] == res[k], k
    assert np.isfinite(res2["mean_LPIPS"])
    assert res2["mean_LPIPS"] != res["mean_LPIPS"]
    assert metrics.lpips(np.zeros((32, 32, 3)), np.zeros((32, 32, 3)),
                         device="cpu") == 0.0


# fine 160x48 is scale_width(160) of a 1242x375 frame, so the transform
# plan exists and the chain fetches the device-downsized planes (at the
# 160x96 of SMALL the plan is None: PIL would pad, and the chain takes
# the full fetch, as the JAX package's does)
SMALL48 = dict(SMALL, fine_height=48)


def _port_chain(tchain, **cfg):
    """A fresh port EditChain (empty caches) over tchain's models."""
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain
    return EditChain(ChainConfig(**cfg), tchain.semantic_model,
                     (tchain.derender_model, tchain.bank),
                     tchain.textural_trainer, device="cpu")


def _request_dicts(root, edit_json):
    return [{"image_rgb": image, "operations": item.operations,
             "dets": dets, "cache_key": item.source_name}
            for item, image, dets in _requests(root, edit_json)]


def _assert_same_pair(a, b):
    """Two chain outputs of one pair, bit for bit."""
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_array_equal(a["fake"], b["fake"])
    assert a["geo"]["json_obj"] == b["geo"]["json_obj"]
    for k in ("instance_png", "normal_png", "depth_png", "instance_small",
              "normal_small"):
        assert (k in a["geo"]) == (k in b["geo"]), k
        if k in a["geo"]:
            np.testing.assert_array_equal(a["geo"][k], b["geo"][k])
    for k in ("label", "inst", "pose", "normal"):
        np.testing.assert_array_equal(a["maps"][k], b["maps"][k])


def test_transform_plan_none_takes_the_full_fetch(env, chains):
    """At 160x96 (taller than scale_width(160) of the 1242x375 frame) the
    plan is None in both packages and the default (small_fetch) chain
    fetches the full-resolution planes; at 160x48 it has a plan."""
    import dataclasses

    from sdn3d_tpu.ops.pil_resize import transform_plan as j_plan
    from sdn3d_tpu_torch.ops.pil_resize import transform_plan

    _, root, edit_json, _ = env
    _, tchain, _, _ = chains
    assert tchain.cfg.small_fetch and tchain._small_plan((375, 1242)) is None
    assert j_plan((1242, 375), 160, (160, 96)) is None
    r = _request_dicts(root, edit_json)[0]
    out = tchain.edit_frame(r["image_rgb"], operations=r["operations"],
                            dets=r["dets"], cache_key=r["cache_key"])
    assert "instance_png" in out["geo"] and "instance_small" not in out["geo"]
    small = _port_chain(tchain, **SMALL48)
    assert small._small_plan((375, 1242)) == transform_plan(
        (1242, 375), 160, (160, 48))
    assert dataclasses.astuple(transform_plan((1242, 375), 160, (160, 48))) \
        == dataclasses.astuple(j_plan((1242, 375), 160, (160, 48)))


def test_small_fetch_matches_full_fetch_and_jax(env, chains):
    """The serving contract (small_fetch at 160x48): instance_small and
    normal_small byte-equal to the PIL transform of the full fetch's
    planes, the fake and JSON bit-equal to the full fetch's, the packed
    copy 6x smaller; and against the JAX package's small-fetch chain on
    JAX's label and encode: instance_small equal, normal_small within the
    +-1 of the full-resolution normal bytes (ROADMAP.md C) on at most
    0.5% of values."""
    from PIL import Image

    from sdn3d_tpu.pipelines import chain as JC

    _, root, edit_json, _ = env
    jchain, tchain, _, _ = chains
    small = _port_chain(tchain, **SMALL48)
    full = _port_chain(tchain, small_fetch=False, **SMALL48)
    on_jax = _port_chain(tchain, **SMALL48)   # JAX's encodes injected
    jsmall = JC.EditChain(
        JC.ChainConfig(small_fetch=True, **SMALL48),
        (jchain.semantic_model, jchain.semantic_vars),
        (jchain.derender_model, jchain.derender_vars, jchain.bank),
        (jchain.textural_trainer, jchain.textural_state))
    for r in _request_dicts(root, edit_json):
        kw = dict(operations=r["operations"], dets=r["dets"],
                  cache_key=r["cache_key"])
        s = small.edit_frame(r["image_rgb"], **kw)
        f = full.edit_frame(r["image_rgb"], **kw)
        assert "instance_small" in s["geo"] and "instance_png" in f["geo"]
        assert "instance_png" not in s["geo"]
        np.testing.assert_array_equal(
            s["geo"]["instance_small"], np.asarray(Image.fromarray(
                f["geo"]["instance_png"]).resize((160, 48), Image.NEAREST)))
        np.testing.assert_array_equal(
            s["geo"]["normal_small"], np.asarray(Image.fromarray(
                f["geo"]["normal_png"]).resize((160, 48), Image.BICUBIC)))
        np.testing.assert_array_equal(s["fake"], f["fake"])
        assert s["geo"]["json_obj"] == f["geo"]["json_obj"]

        want = jsmall.edit_frame(r["image_rgb"], **kw)
        key = r["cache_key"]
        on_jax._encode_cache.put(key, jsmall._encode_cache.get(key))
        got = on_jax.edit_frame(r["image_rgb"], label=want["label"],
                               operations=r["operations"], dets=r["dets"],
                               cache_key=key)
        np.testing.assert_array_equal(got["geo"]["instance_small"],
                                      want["geo"]["instance_small"])
        d = np.abs(got["geo"]["normal_small"].astype(np.int64)
                   - want["geo"]["normal_small"])
        print(f"{key}: normal_small {int((d > 0).sum())} of {d.size} values "
              f"off by one")
        assert d.max() <= 1 and (d > 0).mean() <= 5e-3
        assert got["geo"]["json_obj"].keys() == want["geo"]["json_obj"].keys()
        dd = np.abs(got["fake"] - want["fake"])
        assert dd.max() <= FAKE_E2E_MAX and dd.mean() <= FAKE_E2E_MEAN


@pytest.mark.parametrize("cfg", [SMALL48, dict(SMALL, small_fetch=False)],
                         ids=["small_fetch", "full_fetch"])
def test_edit_frames_match_edit_frame(env, chains, cfg):
    """edit_frames (one render of the chunk's slots, one generator
    forward) over the two pairs and a padded tail (the second pair
    repeated, as the CLI pads) equals edit_frame pair by pair, bit for
    bit; the padded output equals its original; the batched encode equals
    derender_encode."""
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        derender_encode, derender_encode_batch)

    _, root, edit_json, _ = env
    _, tchain, _, _ = chains
    requests = _request_dicts(root, edit_json)
    serial = _port_chain(tchain, **cfg)
    want = [serial.edit_frame(r["image_rgb"], operations=r["operations"],
                              dets=r["dets"], cache_key=r["cache_key"])
            for r in requests]
    got = _port_chain(tchain, **cfg).edit_frames(requests + requests[-1:])
    assert len(got) == 3
    for a, b in zip(got, want + want[-1:]):
        _assert_same_pair(a, b)

    frames = [{"image_rgb": r["image_rgb"], "class_ids": r["dets"][0],
               "image_masks": r["dets"][1], "rois": r["dets"][2]}
              for r in requests]
    for (objs, blob), fr in zip(derender_encode_batch(
            serial.derender_model, frames, serial.infer_cfg, device="cpu"),
            frames):
        objs1, blob1 = derender_encode(
            serial.derender_model, fr["image_rgb"], fr["class_ids"],
            fr["image_masks"], fr["rois"], serial.infer_cfg, device="cpu")
        assert blob.keys() == blob1.keys()
        for k in blob:
            np.testing.assert_array_equal(blob[k], blob1[k])


def test_pipelined_matches_batched(env, chains):
    """edit_frames_pipelined equals edit_frames bit for bit: two
    one-pair chunks (the pipeline staggers: stage A runs two chunks ahead
    of the yield) and one two-pair chunk, each on a chain with empty
    caches."""
    _, root, edit_json, _ = env
    _, tchain, _, _ = chains
    requests = _request_dicts(root, edit_json)
    batched = _port_chain(tchain, **SMALL48).edit_frames(requests)
    staggered = [outs[0] for outs in _port_chain(
        tchain, **SMALL48).edit_frames_pipelined([[r] for r in requests])]
    chunked = next(iter(_port_chain(tchain, **SMALL48).edit_frames_pipelined(
        [requests])))
    assert len(staggered) == len(chunked) == len(requests)
    for a, b, c in zip(batched, staggered, chunked):
        _assert_same_pair(a, b)
        _assert_same_pair(a, c)


def test_edit_frames_match_jax(env, chains):
    """The port's edit_frames against the JAX package's edit_frames over
    the same two pairs, on JAX's labels and JAX's encodes: the tolerances
    of test_edit_frame_matches_jax (instance planes and conditioning maps
    equal, normal/depth bytes +-1 on at most 0.1%, the fake within
    FAKE_E2E_MAX / FAKE_E2E_MEAN)."""
    _, root, edit_json, _ = env
    jchain, tchain, _, _ = chains
    requests = _request_dicts(root, edit_json)
    want = jchain.edit_frames(requests)
    port = _port_chain(tchain, small_fetch=False, **SMALL)
    for r in requests:
        key = r["cache_key"]
        port._encode_cache.put(key, jchain._encode_cache.get(key))
    got = port.edit_frames([dict(r, label=w["label"])
                            for r, w in zip(requests, want)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["geo"]["instance_png"],
                                      w["geo"]["instance_png"])
        for k in ("normal_png", "depth_png"):
            d = np.abs(g["geo"][k].astype(np.int64)
                       - w["geo"][k].astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, k
        assert g["geo"]["json_obj"].keys() == w["geo"]["json_obj"].keys()
        for k in ("label", "inst", "pose"):
            np.testing.assert_array_equal(g["maps"][k], w["maps"][k])
        d = np.abs(g["fake"] - w["fake"])
        assert d.max() <= FAKE_E2E_MAX and d.mean() <= FAKE_E2E_MEAN

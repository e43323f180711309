"""The reference's per-stage file contract in the port, on the CPU:
semantic_test -> geometric_main --vkitti_root [--edit_json | --split] ->
edit_benchmark / textural_test / edit_vkitti, against the port's fused
edit_chain (--dump_dirs: the same bytes) and against the JAX package's
CLIs on the same root and weights.  The weights are JAX's random ones,
saved once as JAX (orbax) step directories and, converted with
utils/port, as the port's step directories (core/checkpoint); the
textural nets are small through the checkpoint's meta.  Shapes: scale
100, 64^2 crops and renders, 160x96 textural frames."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_chain import FAKE_ATOL, L1_ATOL
from tests.test_torch_vkitti import same_crop_path  # noqa: F401 (autouse)

BOXES = {"00360": [(180, 300, 260, 440), (200, 700, 300, 900),
                   (150, 20, 200, 90)],
         "00370": [(170, 500, 250, 650), (190, 900, 280, 1100)]}


def _center(box):
    return {"u": str((box[1] + box[3]) / 2), "v": str((box[0] + box[2]) / 2)}


# two edit pairs sharing a source, and the reconstruction twins of both
# sources (the second half of a benchmark JSON); every frame lies in world
# 0001's test range, and the sources have motgt rows (--split test)
ITEMS = [
    {"world": "0001", "topic": "clone", "source": "00360", "target": "00361",
     "operations": [{"type": "modify", "from": _center(BOXES["00360"][0]),
                     "to": {}, "zoom": "1.3", "ry": "0.4"},
                    {"type": "delete", "from": _center(BOXES["00360"][2])}]},
    {"world": "0001", "topic": "clone", "source": "00360", "target": "00362",
     "operations": [{"type": "modify", "from": _center(BOXES["00360"][1]),
                     "to": {}, "zoom": "0.9", "ry": "-0.3"}]},
    {"world": "0001", "topic": "clone", "source": "00360", "target": "00360",
     "operations": []},
    {"world": "0001", "topic": "clone", "source": "00370", "target": "00370",
     "operations": []},
]
SEM = ["--scales", "100"]
GEO = ["--image_size", "64", "--render_size", "64"]
TEX = ["--load_size", "160", "--fine_width", "160", "--fine_height", "96"]
CPU = ["--device", "cpu"]
CONTRACT = (".png", "-normal.png", "-depth.png", ".json")
# geometric outputs of the two packages from the raw frames (the same
# native crops, each package's own encoder): the JSON's floats within
# JSON_RTOL (the encoders' sums are reassociated; measured 1.2e-6;
# tests/test_torch_derender_infer.py end to end: 1e-4); normal / depth
# bytes differ on at most BYTE_FLIPS of values (XLA's FMA contraction,
# tests/test_torch_derender_infer.py), and by more than one on at most
# EDGE_PIXELS of pixels: the blobs' last bits move the meshes by ulps, and
# a pixel on an edge between two faces then takes the other face's normal
# (measured 14 of 465,750 pixels, by up to 10, on one frame of --split
# test; none from JAX's own blob, tests/test_torch_derender_infer.py)
BYTE_FLIPS = 1e-3
EDGE_PIXELS = 1e-4
JSON_RTOL = 1e-4
# benchmark.json on identical inputs: the fakes within FAKE_ATOL move the
# uint8 images SSIM / PSNR / LPIPS read by a byte where a value sits on a
# rounding boundary (measured: SSIM 2.1e-7, PSNR 3.5e-6 dB, LPIPS 1.5e-6;
# LPIPS of the same checkpoint agrees to 1e-4, tests/test_torch_lpips.py)
SSIM_ATOL = 1e-4
PSNR_ATOL = 1e-3
LPIPS_ATOL = 1e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The root, the edit JSONs, the mesh bank, an LPIPS checkpoint, and
    each model's weights as a JAX step directory and a port one."""
    from sdn3d_tpu.core import checkpoint as JC
    from sdn3d_tpu.models.derenderer import Derenderer as JDerenderer
    from sdn3d_tpu.models.semantic import SemanticModel as JSemantic
    from sdn3d_tpu.pipelines import textural as JT
    from sdn3d_tpu_torch.core import checkpoint as TC
    from sdn3d_tpu_torch.data.synthetic import write_vkitti_root
    from sdn3d_tpu_torch.models.lpips import init_lpips
    from sdn3d_tpu_torch.utils import port
    from tests.test_torch_chain import _mesh_bank_files

    work = str(tmp_path_factory.mktemp("file_chain"))
    root = os.path.join(work, "vkitti")
    frames = {("0001", "clone", s): b for s, b in BOXES.items()}
    frames.update({("0001", "clone", t): [] for t in ("00361", "00362")})
    write_vkitti_root(root, frames, seed=0)
    paths = {"root": root, "work": work,
             "shapenet": _mesh_bank_files(os.path.join(work, "shapenet")),
             "edit_json": os.path.join(work, "edit.json"),
             "geo_json": os.path.join(work, "geo.json"),
             "lpips": os.path.join(work, "lpips.pth")}
    for key, items in (("edit_json", ITEMS), ("geo_json", ITEMS[:2])):
        with open(paths[key], "w") as fh:
            json.dump(items, fh)
    torch.save(init_lpips(1, "cpu").state_dict(), paths["lpips"])

    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    sv = tree(JSemantic(num_class=14).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    dv = tree(JDerenderer(num_classes=8).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)),
        jnp.zeros((1, 2)), train=False))
    tcfg = JT.TexturalConfig(use_vgg_loss=False, **JT.SMALL_NET_OVERRIDES)
    state = JT.TexturalTrainer(tcfg).init(jax.random.PRNGKey(2), 96, 160)
    meta = {"small": True, "no_vgg": True}
    enc, dec = port.semantic_state_dicts_from_jax(sv)
    for name, jstate, jmeta, nets, tmeta in (
            ("sem", sv, None, {"encoder": enc, "decoder": dec}, None),
            ("der", dv, None,
             {"derenderer": port.derenderer_state_dict_from_jax(dv)}, None),
            ("tex", state, meta, {
                "netG": port.global_generator_state_dict_from_jax(
                    tree(state.params_g), tcfg.n_downsample_global,
                    tcfg.n_blocks_global),
                "netE": port.encoder_state_dict_from_jax(
                    tree(state.params_e), tcfg.n_downsample_e)}, meta)):
        paths[f"{name}_jax"] = os.path.join(work, f"{name}_jax")
        JC.save_checkpoint(paths[f"{name}_jax"], 0, jstate, meta=jmeta)
        paths[name] = os.path.join(work, name)
        TC.save_checkpoint(paths[name], 0, nets, meta=tmeta)
    return paths


def _cli(pkg, name):
    """(module, checkpoint suffix, device args) of CLI `name` of package
    `pkg` ("port" or "jax")."""
    import importlib
    if pkg == "port":
        return importlib.import_module(f"sdn3d_tpu_torch.cli.{name}"), "", CPU
    return importlib.import_module(f"sdn3d_tpu.cli.{name}"), "_jax", []


def _semantic(pkg, env, segm):
    """semantic_test --test_img benchmark of `pkg` into `segm`."""
    cli, ck, dev = _cli(pkg, "semantic_test")
    cli.main(["--test_img", "benchmark", "--edit_json", env["edit_json"],
              "--data_root", env["root"], "--result", segm, "--ckpt_dir",
              env["sem" + ck]] + SEM + dev)
    return segm


def _geometric(pkg, env, geo, mode):
    """geometric_main --vkitti_root --source gt of `pkg` into `geo`,
    `mode` being --edit_json's or --split's arguments."""
    cli, ck, dev = _cli(pkg, "geometric_main")
    cli.main(["--source", "gt", "--vkitti_root", env["root"],
              "--output_dir", geo, "--ckpt_dir", env["der" + ck],
              "--shapenet_root", env["shapenet"]] + mode + GEO + dev)
    return geo


@pytest.fixture(scope="module")
def port_files(env):
    """The port's per-stage chain: labels, the edit pairs' geometric
    outputs, and edit_benchmark's benchmark.json with --chain_times."""
    from sdn3d_tpu_torch.cli import edit_benchmark

    out = os.path.join(env["work"], "port")
    segm = _semantic("port", env, os.path.join(out, "segm"))
    geo = _geometric("port", env, os.path.join(out, "geo"),
                     ["--edit_json", env["geo_json"]])
    times = os.path.join(out, "times.json")
    with open(times, "w") as fh:
        json.dump({"semantic_s": 1.5, "geometric_s": 2.5, "other": 9}, fh)
    bench = edit_benchmark.main([
        "--edit_json", env["edit_json"], "--data_root", env["root"],
        "--segm_dir", segm, "--geo_dir", geo, "--ckpt_dir", env["tex"],
        "--results_dir", os.path.join(out, "bench"), "--chain_times", times,
        "--lpips_ckpt", env["lpips"]] + TEX + CPU)
    return segm, geo, bench


@pytest.fixture(scope="module")
def jax_files(env):
    """The JAX package's semantic_test and geometric_main, edit_json mode
    and --split test mode, on the same root and weights."""
    out = os.path.join(env["work"], "jax")
    return (_semantic("jax", env, os.path.join(out, "segm")),
            _geometric("jax", env, os.path.join(out, "geo"),
                       ["--edit_json", env["geo_json"]]),
            _geometric("jax", env, os.path.join(out, "split"),
                       ["--split", "test"]))


def _same_geo_files(got_dir, want_dir, names):
    """The contract files of `names` in two geometric output dirs: the
    instance PNG equal; normal / depth bytes differing on at most
    BYTE_FLIPS of values, by more than one on at most EDGE_PIXELS of
    pixels; the JSON's keys and classes equal, its floats within
    JSON_RTOL."""
    from PIL import Image

    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(d, f"{name}.png")))
                for d in (got_dir, want_dir))
        np.testing.assert_array_equal(a, b, err_msg=name)
        for suffix in ("-normal.png", "-depth.png"):
            a, b = (np.asarray(Image.open(os.path.join(d, name + suffix)),
                               np.int64) for d in (got_dir, want_dir))
            diff = np.abs(a - b).reshape(a.shape[0], a.shape[1], -1)
            assert a.shape == b.shape and (diff > 0).mean() <= BYTE_FLIPS \
                and (diff.max(-1) > 1).mean() <= EDGE_PIXELS, (name, suffix)
        ja, jb = (json.load(open(os.path.join(d, f"{name}.json")))
                  for d in (got_dir, want_dir))
        assert ja.keys() == jb.keys() and ja, name
        for k in ja:
            assert ja[k].keys() == jb[k].keys()
            assert ja[k]["class_id"] == jb[k]["class_id"]
            for f in ("depth", "alpha"):
                np.testing.assert_allclose(ja[k][f], jb[k][f],
                                           rtol=JSON_RTOL)


def test_geometric_main_dataset_mode_matches_jax(env, port_files, jax_files):
    """geometric_main --vkitti_root: with --edit_json (outputs named by
    target_name, GT from scenegt) and with --split test (every motgt frame
    of the test ranges, named {world}_{topic}_{frame}), the port's files
    against the JAX package's; the labels equal."""
    from PIL import Image

    p_segm, p_geo, _ = port_files
    j_segm, j_geo, j_split = jax_files
    names = ["0001_clone_00360_00361", "0001_clone_00360_00362"]
    assert sorted(n for n in os.listdir(p_geo) if n.endswith(".json")) == \
        sorted(n for n in os.listdir(j_geo) if n.endswith(".json")) == \
        [n + ".json" for n in names]
    _same_geo_files(p_geo, j_geo, names)
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(p_segm, "0001_clone_00360.png"))),
        np.asarray(Image.open(os.path.join(j_segm, "0001_clone_00360.png"))))

    p_split = _geometric("port", env,
                         os.path.join(env["work"], "port", "split"),
                         ["--split", "test"])
    names = ["0001_clone_00360", "0001_clone_00370"]
    for d in (p_split, j_split):
        assert sorted(n for n in os.listdir(d) if n.endswith(".pkl")) == \
            [n + ".pkl" for n in names]
    _same_geo_files(p_split, j_split, names)


def _recording(monkeypatch, module, name, out):
    """Wrap module.name so each call's fake (the first element of its
    result) is appended to `out`."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        out.append(np.asarray(res[0], np.float32))
        return res
    monkeypatch.setattr(module, name, wrapped)


def test_edit_benchmark_matches_jax(env, jax_files, monkeypatch):
    """edit_benchmark of both packages on the JAX package's label and
    geometric dirs, the same textural weights and LPIPS checkpoint: each
    pair's fake within FAKE_ATOL and its L1 within L1_ATOL; benchmark.json
    with the same keys, mean_L1 within L1_ATOL, SSIM / PSNR / LPIPS within
    their stated bounds, --chain_times' two stage times taken (and nothing
    else of the file) in both."""
    from sdn3d_tpu.cli import edit_benchmark as JB
    from sdn3d_tpu.cli import edit_vkitti as JEV
    from sdn3d_tpu_torch.cli import edit_benchmark as TB
    from sdn3d_tpu_torch.cli import edit_vkitti as TEV

    j_segm, j_geo, _ = jax_files
    out = os.path.join(env["work"], "bench_vs_jax")
    os.makedirs(out)
    times = os.path.join(out, "times.json")
    with open(times, "w") as fh:
        json.dump({"semantic_s": 3.0, "geometric_s": 4.0, "mean_L1": 7}, fh)
    dirs = ["--edit_json", env["edit_json"], "--data_root", env["root"],
            "--segm_dir", j_segm, "--geo_dir", j_geo] + TEX
    common = dirs + ["--chain_times", times, "--lpips_ckpt", env["lpips"]]
    fakes = {"port": [], "jax": []}
    _recording(monkeypatch, TEV, "generate_edit_frame", fakes["port"])
    _recording(monkeypatch, JEV, "generate_edit_frame", fakes["jax"])
    got = TB.main(common + ["--ckpt_dir", env["tex"], "--results_dir",
                            os.path.join(out, "port")] + CPU)
    JB.main(common + ["--ckpt_dir", env["tex_jax"], "--results_dir",
                      os.path.join(out, "jax")])
    with open(os.path.join(out, "jax", "benchmark.json")) as fh:
        want = json.load(fh)
    assert len(fakes["port"]) == len(fakes["jax"]) == got["pairs"] == 2
    for a, b in zip(fakes["port"], fakes["jax"]):
        assert a.shape == (48, 160, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=FAKE_ATOL)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["mean_L1"], want["mean_L1"], atol=L1_ATOL)
    for k, tol in (("mean_SSIM", SSIM_ATOL), ("mean_PSNR", PSNR_ATOL),
                   ("mean_LPIPS", LPIPS_ATOL)):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
    for r in (got, want):
        assert (r["semantic_s"], r["geometric_s"]) == (3.0, 4.0)
        assert r["lpips_backbone"] == "ported"
        np.testing.assert_allclose(r["chain_s"], r["textural_s"] + 7.0)
    with open(os.path.join(out, "port", "benchmark.json")) as fh:
        assert json.load(fh) == got
    # without --chain_times the headline is not the three-stage rate, and
    # without --lpips_ckpt the LPIPS backbone is the random one
    bare = TB.main(dirs + ["--ckpt_dir", env["tex"], "--results_dir",
                           os.path.join(out, "bare")] + CPU)
    assert bare["edits_per_sec"] is None and "chain_s" not in bare
    assert bare["lpips_backbone"] == "random-init (uncalibrated)"
    assert bare["mean_L1"] == got["mean_L1"]


def test_file_chain_equals_fused_chain(env, port_files):
    """The port's per-stage chain against its fused edit_chain
    --dump_dirs on the same root and step directories: the label PNG and
    the four contract files of every pair byte-equal, mean L1 / SSIM /
    PSNR / LPIPS within 1e-6; edits_per_sec over the three stages."""
    from sdn3d_tpu_torch.cli import edit_chain

    segm, geo, bench = port_files
    dump = os.path.join(env["work"], "dump")
    fused = edit_chain.main([
        "--edit_json", env["edit_json"], "--data_root", env["root"],
        "--shapenet_root", env["shapenet"], "--dump_dirs", dump,
        "--results_dir", os.path.join(env["work"], "fused"),
        "--semantic_ckpt", env["sem"], "--derender_ckpt", env["der"],
        "--textural_ckpt", env["tex"], "--lpips_ckpt", env["lpips"]]
        + SEM + GEO + TEX + CPU)
    assert fused["pairs"] == bench["pairs"] == 2
    for k in ("mean_L1", "mean_SSIM", "mean_PSNR", "mean_LPIPS"):
        np.testing.assert_allclose(fused[k], bench[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    fn = "0001_clone_00360.png"
    with open(os.path.join(segm, fn), "rb") as a, \
            open(os.path.join(dump, "segm", fn), "rb") as b:
        assert a.read() == b.read()
    for target in ("00361", "00362"):
        for suffix in CONTRACT:
            fn = f"0001_clone_00360_{target}{suffix}"
            with open(os.path.join(geo, fn), "rb") as a, \
                    open(os.path.join(dump, "geo", fn), "rb") as b:
                assert a.read() == b.read(), fn
    assert (bench["semantic_s"], bench["geometric_s"]) == (1.5, 2.5)
    assert "other" not in bench
    np.testing.assert_allclose(bench["edits_per_sec"],
                               2 / (bench["textural_s"] + 4.0))


def test_textural_test_matches_jax(env, port_files, jax_files, monkeypatch,
                                   capsys):
    """textural_test of both packages over the test list on the JAX
    package's --split test outputs with the same labels: the same frames
    (those without a label PNG skipped), each frame's fake within
    FAKE_ATOL and L1 within L1_ATOL, `avg:` printed; --limit honoured."""
    from sdn3d_tpu.cli import edit_vkitti as JEV
    from sdn3d_tpu.cli import textural_test as JTT
    from sdn3d_tpu_torch.cli import textural_test as TTT

    segm, _, _ = port_files                    # labels of 00360 only
    _, _, j_split = jax_files
    out = os.path.join(env["work"], "textural_test")
    common = ["--data_root", env["root"], "--segm_dir", segm, "--geo_dir",
              j_split] + TEX
    jfakes = []
    load = JEV.load_trainer

    def recording_trainer(args):
        trainer, state = load(args)
        fn = trainer.fake_inference_jit
        trainer.fake_inference_jit = lambda *a: jfakes.append(
            np.asarray(fn(*a))) or jnp.asarray(jfakes[-1])
        return trainer, state
    monkeypatch.setattr(JEV, "load_trainer", recording_trainer)
    tfakes = []
    from sdn3d_tpu_torch.pipelines.textural import TexturalTrainer
    orig = TexturalTrainer.fake_inference
    monkeypatch.setattr(TexturalTrainer, "fake_inference",
                        lambda self, *a: tfakes.append(orig(self, *a))
                        or tfakes[-1])
    capsys.readouterr()
    got = TTT.main(common + ["--ckpt_dir", env["tex"], "--results_dir",
                             os.path.join(out, "port")] + CPU)
    printed = capsys.readouterr().out
    JTT.main(common + ["--ckpt_dir", env["tex_jax"], "--results_dir",
                       os.path.join(out, "jax")])
    assert list(got) == ["0001_clone_00360"] and len(jfakes) == 1
    np.testing.assert_allclose(tfakes[0].numpy(), jfakes[0], rtol=0,
                               atol=FAKE_ATOL)
    real = got["0001_clone_00360"]
    assert np.isfinite(real)
    assert f"avg: {real:.4f} over 1 frames" in printed
    assert TTT.main(common + ["--ckpt_dir", env["tex"], "--limit", "5",
                              "--results_dir", os.path.join(out, "lim")]
                    + CPU) == {}


def test_edit_vkitti_main_matches_jax(env, port_files, monkeypatch):
    """The README's single-frame route: geometric_main --input_image
    --edit_json --input_masks writes stems 00000, 00001; edit_vkitti.main
    of both packages over them (the source's label PNG, the same textural
    weights): each frame's fake within FAKE_ATOL, the galleries written."""
    from sdn3d_tpu.cli import edit_vkitti as JEV
    from sdn3d_tpu_torch.cli import edit_vkitti as TEV
    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.data import vkitti as VK

    segm, _, _ = port_files
    out = os.path.join(env["work"], "single")
    os.makedirs(out)
    src = VK.rgb_path(env["root"], "0001", "clone", 360)
    class_ids, masks, rois = VK.gt_objects(env["root"], "0001", "clone", 360,
                                           VK.get_tables("inst", env["root"]))
    npz = os.path.join(out, "gt.npz")
    np.savez(npz, class_ids=class_ids, masks=masks, rois=rois)
    geo = os.path.join(out, "geo")
    geometric_main.main(["--source", "gt", "--input_image", src,
                         "--edit_json", env["geo_json"], "--input_masks",
                         npz, "--output_dir", geo, "--ckpt_dir", env["der"],
                         "--shapenet_root", env["shapenet"]] + GEO + CPU)
    common = ["--edit_source", src, "--segm_path",
              os.path.join(segm, "0001_clone_00360.png"), "--edit_dir", geo,
              "--edit_num", "2"] + TEX
    got = TEV.main(common + ["--ckpt_dir", env["tex"], "--results_dir",
                             os.path.join(out, "port")] + CPU)
    want = []
    _recording(monkeypatch, JEV, "generate_edit_frame", want)
    JEV.main(common + ["--ckpt_dir", env["tex_jax"], "--results_dir",
                       os.path.join(out, "jax")])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=FAKE_ATOL)
    for pkg in ("port", "jax"):
        assert os.path.exists(os.path.join(out, pkg, "index.html"))
        assert len(os.listdir(os.path.join(out, pkg, "images"))) == 6


@pytest.mark.parametrize("cli", ["semantic_test", "geometric_main",
                                 "edit_benchmark", "edit_vkitti",
                                 "textural_test", "edit_chain"])
def test_clis_need_a_card_by_default(tmp_path, monkeypatch, cli):
    """Without --device cpu every CLI runs on cuda, and there is no card
    here: it raises, and nothing falls back to the CPU."""
    import importlib

    argv = {
        "semantic_test": ["--test_img", "x.png"],
        "geometric_main": ["--source", "gt", "--input_image", "x.png",
                           "--input_masks", "x.npz"],
        "edit_benchmark": ["--edit_json", "x", "--segm_dir", "x",
                           "--geo_dir", "x"],
        "edit_vkitti": ["--edit_source", "x", "--segm_path", "x",
                        "--edit_dir", "x"],
        "textural_test": ["--segm_dir", "x", "--geo_dir", "x"],
        "edit_chain": ["--edit_json", "x"],
    }[cli]
    mod = importlib.import_module(f"sdn3d_tpu_torch.cli.{cli}")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)

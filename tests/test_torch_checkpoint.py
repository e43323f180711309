"""The port's checkpoints (sdn3d_tpu_torch.core.checkpoint) against the JAX
package's layout, the textural config a checkpoint's meta rebuilds
(pipelines/textural.config_from_train_meta) against JAX's, and the CLIs'
loaders reading step directories."""

import functools
import json
import os
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.core import checkpoint as JC
from sdn3d_tpu_torch.core import checkpoint as TC


def _same_state(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_layout_newest_step_and_round_trip(tmp_path):
    """Steps under DIR/step-{N}, the manifest {"step", "meta"} of the last
    save as JAX writes it, the newest step restored by default (JAX's
    latest_step reads the same directory alike), any step on request;
    an empty directory raises."""
    d = str(tmp_path / "ck")
    states = {s: {"net": {"w": torch.full((2, 3), float(s)),
                          "n": torch.tensor(s)}, "step": s}
              for s in (1, 10, 2)}
    for s, st in states.items():
        path = TC.save_checkpoint(d, s, st, meta={"small": True, "s": s})
        assert path == os.path.join(d, f"step-{s}")
    os.makedirs(os.path.join(d, "step-x"))          # not a step: skipped
    assert TC.latest_step(d) == JC.latest_step(d) == 10
    assert TC.load_meta(d) == {"step": 2, "meta": {"small": True, "s": 2}}
    jd = str(tmp_path / "jax")
    JC.save_checkpoint(jd, 2, {"w": np.zeros(3, np.float32)},
                       meta={"small": True, "s": 2})
    assert JC.load_meta(jd) == TC.load_meta(d)
    got, step = TC.restore_checkpoint(d)
    assert step == 10 and got["step"] == 10
    _same_state(got["net"], states[10]["net"])
    got, step = TC.restore_checkpoint(d, step=1)
    assert step == 1
    _same_state(got["net"], states[1]["net"])
    # saving a step again replaces it
    TC.save_checkpoint(d, 1, {"net": {"w": torch.ones(1)}})
    assert list(TC.restore_checkpoint(d, step=1)[0]) == ["net"]
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(str(tmp_path / "empty"))


def test_restore_variables_takes_the_nets_of_a_train_state(tmp_path):
    """A train-state step (nets, step count, optimizer state):
    restore_variables returns the named nets only, as JAX's takes params /
    batch_stats out of a train state; a missing net raises naming it."""
    g = torch.nn.Linear(3, 2)
    e = torch.nn.Conv2d(3, 4, 3)
    opt = torch.optim.Adam(list(g.parameters()) + list(e.parameters()))
    g(torch.ones(1, 3)).sum().backward()
    opt.step()
    d = str(tmp_path / "ck")
    TC.save_checkpoint(d, 5, {"step": 5, "netG": g.state_dict(),
                              "netE": e.state_dict(),
                              "optimizer": opt.state_dict()})
    nets, step = TC.restore_variables(d, ["netG", "netE"])
    assert step == 5 and list(nets) == ["netG", "netE"]
    _same_state(nets["netG"], g.state_dict())
    _same_state(nets["netE"], e.state_dict())
    with pytest.raises(ValueError, match="netD"):
        TC.restore_variables(d, ["netG", "netD"])


def test_orbax_directories_are_refused(tmp_path):
    """A JAX (orbax) step directory is not readable by the port: a
    ValueError that names it, not a wrong restore."""
    d = str(tmp_path / "orbax")
    JC.save_checkpoint(d, 0, {"params": {"w": np.ones(3, np.float32)}})
    assert TC.latest_step(d) == 0
    with pytest.raises(ValueError, match="orbax"):
        TC.restore_variables(d, ["derenderer"])


def test_load_state_dicts_reads_files_and_directories(tmp_path):
    """A CLI's checkpoint argument: a step directory (newest step), or a
    torch file holding the bare state_dict (one net) or a dict keyed by
    the nets (several)."""
    a, b = torch.nn.Linear(2, 2).state_dict(), torch.nn.Linear(3, 1).state_dict()
    torch.save(a, tmp_path / "one.pt")
    torch.save({"encoder": a, "decoder": b}, tmp_path / "two.pt")
    d = str(tmp_path / "ck")
    TC.save_checkpoint(d, 0, {"encoder": b, "decoder": a})
    TC.save_checkpoint(d, 3, {"encoder": a, "decoder": b})
    _same_state(TC.load_state_dicts(str(tmp_path / "one.pt"),
                                    ["derenderer"])["derenderer"], a)
    for path in (str(tmp_path / "two.pt"), d):
        got = TC.load_state_dicts(path, ["encoder", "decoder"])
        _same_state(got["encoder"], a)
        _same_state(got["decoder"], b)


@pytest.mark.parametrize("meta", [
    {}, {"small": True}, {"small": False, "lr": 1e-3},
    {"small": True, "pool_size": 4, "lr": 5e-4, "no_vgg": True},
    {"no_vgg": False, "use_global_encoder": False}])
def test_config_from_train_meta_matches_jax(meta):
    """Every field of the port's TexturalConfig equals JAX's for the same
    meta and overrides."""
    import dataclasses

    from sdn3d_tpu.pipelines import textural as JT
    from sdn3d_tpu_torch.pipelines import textural as TT

    for over in ({}, {"compute_dtype": "bfloat16", "use_vgg_loss": False}):
        got = TT.config_from_train_meta(meta, **over)
        want = JT.config_from_train_meta(meta, **over)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.netG_input_nc == want.netG_input_nc


def test_global_encoder_checkpoints_raise():
    from sdn3d_tpu_torch.pipelines.textural import config_from_train_meta
    with pytest.raises(NotImplementedError, match="A8"):
        config_from_train_meta({"small": True, "use_global_encoder": True})


def test_load_trainer_rebuilds_small_nets_from_meta(tmp_path):
    """edit_vkitti.load_trainer on a step directory written from a JAX
    textural train state at SMALL_NET_OVERRIDES (converted with utils/port,
    meta as cli/textural_train persists it): the nets come back small, with
    the converted weights; the argument's compute_dtype wins over meta."""
    from sdn3d_tpu.pipelines import textural as JT
    from sdn3d_tpu_torch.cli.edit_vkitti import load_trainer
    from sdn3d_tpu_torch.pipelines.textural import (SMALL_NET_OVERRIDES,
                                                    TexturalConfig)
    from sdn3d_tpu_torch.utils import port

    jcfg = JT.TexturalConfig(use_vgg_loss=False, **JT.SMALL_NET_OVERRIDES)
    state = JT.TexturalTrainer(jcfg).init(jax.random.PRNGKey(0), 48, 64)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    g = port.global_generator_state_dict_from_jax(
        tree(state.params_g), jcfg.n_downsample_global, jcfg.n_blocks_global)
    e = port.encoder_state_dict_from_jax(tree(state.params_e),
                                         jcfg.n_downsample_e)
    meta = {"small": True, "no_vgg": True, "pool_size": 0, "lr": 2e-4}
    d = str(tmp_path / "tex")
    TC.save_checkpoint(d, 0, {"netG": g, "netE": e, "step": 0}, meta=meta)
    TC.save_checkpoint(d, 7, {"netG": g, "netE": e, "step": 7}, meta=meta)
    trainer = load_trainer(NS(device="cpu", seed=3, ckpt_dir=d,
                              compute_dtype="bfloat16"))
    want = TexturalConfig(compute_dtype="bfloat16", use_vgg_loss=False,
                          **SMALL_NET_OVERRIDES)
    assert trainer.cfg == want
    _same_state(trainer.netG.state_dict(), g)
    _same_state(trainer.netE.state_dict(), e)
    # a torch file keeps today's behaviour: the config the caller gives
    f = str(tmp_path / "tex.pt")
    torch.save({"netG": g, "netE": e}, f)
    small = TexturalConfig(**SMALL_NET_OVERRIDES)
    got = load_trainer(NS(device="cpu", seed=3, ckpt_dir=f), small)
    assert got.cfg == small
    _same_state(got.netG.state_dict(), g)


@pytest.mark.parametrize("net", ["semantic", "derenderer", "maskrcnn"])
def test_cli_loaders_read_step_directories(tmp_path, monkeypatch, net):
    """semantic_test.load_model, geometric_main.load_derenderer and
    make_detector given a step directory load its nets (written from other
    seeds' weights), not their random draws."""
    from sdn3d_tpu_torch.cli import geometric_main, semantic_test
    from sdn3d_tpu_torch.models import maskrcnn
    from tests.test_torch_chain import _mesh_bank_files
    from tests.test_torch_detect import SMALL

    monkeypatch.setattr(maskrcnn, "MaskRCNNConfig",
                        functools.partial(maskrcnn.MaskRCNNConfig, **SMALL))
    d = str(tmp_path / "ck")
    args = NS(device="cpu", compute_dtype="float32", num_class=14,
              image_size=64,
              shapenet_root=_mesh_bank_files(str(tmp_path / "sn")))
    if net == "semantic":
        src = semantic_test.load_model(NS(**vars(args), seed=1, ckpt_dir=None))
        TC.save_checkpoint(d, 0, {"encoder": src.encoder.state_dict(),
                                  "decoder": src.decoder.state_dict()})
        got = semantic_test.load_model(NS(**vars(args), seed=2, ckpt_dir=d))
        _same_state(got.state_dict(), src.state_dict())
    elif net == "derenderer":
        src, _ = geometric_main.load_derenderer(
            NS(**vars(args), seed=1, ckpt_dir=None))
        TC.save_checkpoint(d, 0, {"derenderer": src.state_dict()})
        got, _ = geometric_main.load_derenderer(
            NS(**vars(args), seed=2, ckpt_dir=d))
        _same_state(got.state_dict(), src.state_dict())
    else:
        src = geometric_main.make_detector(
            NS(**vars(args), seed=1, maskrcnn_ckpt=None))
        TC.save_checkpoint(d, 0, {"maskrcnn": src.model.state_dict()})
        got = geometric_main.make_detector(
            NS(**vars(args), seed=2, maskrcnn_ckpt=d))
        _same_state(got.model.state_dict(), src.model.state_dict())
    with open(os.path.join(d, "manifest.json")) as fh:
        assert json.load(fh)["step"] == 0

"""The port's textural branch (sdn3d_tpu_torch.models.pix2pixhd,
pipelines.textural, data.textural_data, cli.edit_vkitti) against the JAX
package's, on the CPU: the same numpy inputs and the same weights (JAX's
random init, converted with utils/port) through both."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models import pix2pixhd as JX
from sdn3d_tpu.pipelines import textural as JT
from sdn3d_tpu.utils.port import port_encoder, port_global_generator
from sdn3d_tpu_torch.models import pix2pixhd as TX
from sdn3d_tpu_torch.pipelines import textural as TT
from sdn3d_tpu_torch.utils.port import (encoder_state_dict_from_jax,
                                        global_generator_state_dict_from_jax)

# Generator / encoder outputs (tanh, in [-1, 1]): the two packages sum the
# convolutions' products in different orders.  The full-width generator on
# a 32x48 input instance-normalises its 2x3 bottleneck, over 6 values,
# through 9 blocks, which amplifies float32 rounding: measured 1.7e-4
# between the packages, with each within 1.6e-4 of a float64 run of the
# same net (6e-5 JAX, 1.5e-4 the port); 3.4e-5 at 64x96.  Stated
# tolerances: GEN_ATOL for that generator, NET_ATOL for the rest.
GEN_ATOL = 5e-4
NET_ATOL = 1e-5


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_same_tree(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


@pytest.fixture(scope="module")
def full_nets():
    """The GlobalGenerator (ngf 64, 4 down-samplings, 9 blocks, 48 input
    channels) and the Encoder (nef 16, feat 5, 4 down-samplings) at full
    width, JAX params and the port's nets."""
    cfg = JT.TexturalConfig()
    jg = JX.GlobalGenerator(3, cfg.ngf, cfg.n_downsample_global,
                            cfg.n_blocks_global)
    je = JX.Encoder(cfg.feat_num, cfg.nef, cfg.n_downsample_e)
    pg = _np_tree(jg.init(jax.random.PRNGKey(1),
                          jnp.zeros((1, 32, 48, cfg.netG_input_nc)))["params"])
    pe = _np_tree(je.init(jax.random.PRNGKey(2),
                          jnp.zeros((1, 32, 48, 3)))["params"])
    tg = TX.GlobalGenerator(cfg.netG_input_nc)
    tg.load_state_dict(global_generator_state_dict_from_jax(pg))
    te = TX.Encoder()
    te.load_state_dict(encoder_state_dict_from_jax(pe))
    return (jg, pg, tg.eval()), (je, pe, te.eval())


def test_global_generator_matches_jax(full_nets):
    (jg, pg, tg), _ = full_nets
    x = np.random.RandomState(0).randn(2, 32, 48, 48).astype(np.float32)
    want = np.asarray(jg.apply({"params": pg}, jnp.asarray(x)))
    with torch.no_grad():
        got = tg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=GEN_ATOL)


def test_encoder_matches_jax(full_nets):
    _, (je, pe, te) = full_nets
    x = np.random.RandomState(1).uniform(-1, 1, (1, 32, 48, 3)).astype(
        np.float32)
    want = np.asarray(je.apply({"params": pe}, jnp.asarray(x)))
    with torch.no_grad():
        got = te(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 32, 48, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)


def test_converters_round_trip(full_nets):
    """Each flax -> torch converter, fed back through JAX's
    port_global_generator / port_encoder, gives back the original flax
    tree exactly: the key layout is the reference's `model.N.*`."""
    (_, pg, _), (_, pe, _) = full_nets
    _assert_same_tree(pg, port_global_generator(
        global_generator_state_dict_from_jax(pg))["params"])
    _assert_same_tree(pe, port_encoder(
        encoder_state_dict_from_jax(pe))["params"])


def test_get_edges_matches_jax():
    inst = np.random.RandomState(2).randint(0, 4, (2, 9, 13)).astype(np.int32)
    inst[0, 3:6, 4:9] = 7000
    want = np.asarray(JX.get_edges(jnp.asarray(inst)))[..., 0]
    got = TX.get_edges(torch.from_numpy(inst))[:, 0].numpy()
    np.testing.assert_array_equal(got, want)


def test_one_hot_label_gives_id_14_a_zero_row():
    """Shifted labels reach 14 with label_nc 14: an all-zero row, as
    jax.nn.one_hot gives it (F.one_hot would raise)."""
    lab = np.asarray([[[0, 5, 13, 14]]], np.int32)
    want = np.asarray(JT.one_hot_label(jnp.asarray(lab), 14))
    got = TT.one_hot_label(torch.from_numpy(lab), 14).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 3].sum() == 0 and got[0, 0, 2, 13] == 1


def test_instance_feature_means_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 10, 12, 5).astype(np.float32)
    slots = rng.randint(0, 6, (2, 10, 12)).astype(np.int32)
    wm, wc = JX.instance_feature_means(jnp.asarray(feats), jnp.asarray(slots),
                                       8)
    gm, gc = TX.instance_feature_means(torch.from_numpy(feats),
                                       torch.from_numpy(slots), 8)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=1e-6)


def test_normal_table_matches_jax_compiled_normalisation():
    """The byte -> float table of fake_inference equals, for all 256 bytes,
    JAX's compiled (x/255 - 0.5)/0.5 + 1/255 (textural.py:537-541)."""
    x = jnp.arange(256, dtype=jnp.uint8)
    want = np.asarray(jax.jit(
        lambda n: (n.astype(jnp.float32) / 255.0 - 0.5) / 0.5
        + 1.0 / 255.0)(x))
    np.testing.assert_array_equal(TT._NORMAL_U8_TABLE, want)


@pytest.fixture(scope="module")
def small_trainers():
    """JAX TexturalTrainer nets at SMALL_NET_OVERRIDES (as the chain test
    runs them) and the port's TexturalTrainer with the converted weights."""
    cfg = JT.TexturalConfig(**JT.SMALL_NET_OVERRIDES)
    jt = JT.TexturalTrainer(cfg)
    pg = _np_tree(jt.netG.init(jax.random.PRNGKey(3), jnp.zeros(
        (1, 48, 80, cfg.netG_input_nc)))["params"])
    pe = _np_tree(jt.netE.init(jax.random.PRNGKey(4),
                               jnp.zeros((1, 48, 80, 3)))["params"])
    tt = TT.TexturalTrainer(TT.TexturalConfig(**TT.SMALL_NET_OVERRIDES))
    tt.load_state_dicts(
        global_generator_state_dict_from_jax(pg, cfg.n_downsample_global,
                                             cfg.n_blocks_global),
        encoder_state_dict_from_jax(pe, cfg.n_downsample_e))
    # the inference fields only: D, VGG and the optimizers stay empty
    state = JT.TexturalState(step=jnp.zeros((), jnp.int32), params_g=pg,
                             params_d={}, params_e=pe, vgg={}, opt_g={},
                             opt_d={}, params_ge={})
    return jt, state, tt.to("cpu")


def test_fake_inference_uint8_planes_match_jax(small_trainers):
    """fake_inference on the serving batch (uint8 label / instance plane /
    slots / pose / normal bytes) with one frame's normal_valid 0: the
    instance-plane rebuild and the normal bytes are exact; the fakes within
    NET_ATOL."""
    jt, state, tt = small_trainers
    rng = np.random.RandomState(5)
    B, H, W = 2, 48, 80
    inst = np.zeros((B, H, W), np.uint8)
    inst[:, 10:30, 20:50] = 1
    inst[1, 20:40, 40:70] = 2
    label = rng.randint(1, 5, (B, H, W)).astype(np.uint8)    # < 8 slots
    full = np.where(inst == 0, label.astype(np.int32),
                    inst.astype(np.int32) * 1000)
    slots = np.stack([np.searchsorted(np.unique(f), f) for f in full]
                     ).astype(np.uint8)
    batch = {"label": label, "inst": inst, "inst_slots": slots,
             "pose": rng.randint(0, 25, (B, H, W)).astype(np.uint8),
             "normal": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
             "normal_valid": np.asarray([1.0, 0.0], np.float32)}
    table = rng.uniform(-1, 1, (B, 8, 5)).astype(np.float32)
    want = np.asarray(jt.fake_inference_jit(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(table)))
    got = tt.fake_inference({k: torch.from_numpy(v) for k, v in batch.items()},
                            torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (B, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)


def test_generate_edit_from_images_matches_jax(small_trainers):
    """cli.edit_vkitti end to end from PIL images: the source code table
    (netE + instance means) within 1e-6, the host conditioning (maps,
    slots, code table, uint8 planes) equal, and the fake within NET_ATOL,
    with and without a normal map."""
    from PIL import Image

    from sdn3d_tpu.cli import edit_vkitti as JE
    from sdn3d_tpu_torch.cli import edit_vkitti as TE

    jt, state, tt = small_trainers
    rng = np.random.RandomState(6)
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
    jp = JE.prepare_source_inputs(jt, state, src, lab, 80, wh)
    tp = TE.prepare_source_inputs(tt, src, lab, 80, wh)
    np.testing.assert_array_equal(tp[0], jp[0])
    np.testing.assert_array_equal(tp[1], jp[1])
    np.testing.assert_allclose(tp[2], jp[2], rtol=0, atol=1e-6)
    for nimg in (normal, None):
        ja = JE.assemble_edit_conditioning(jt, state, *jp[:2],
                                           Image.fromarray(inst), json_obj,
                                           nimg, wh, args, feats=jp[2])
        ta = TE.assemble_edit_conditioning(tt, *jp[:2], Image.fromarray(inst),
                                           json_obj, nimg, wh, args,
                                           feats=jp[2])
        for k in ja[0]:
            np.testing.assert_array_equal(ta[0][k], ja[0][k], err_msg=k)
        for a, b in zip(ta[1:], ja[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        want, _ = JE.generate_edit_from_images(
            jt, state, *jp[:2], Image.fromarray(inst), json_obj, nimg, wh,
            args, feats=jp[2])
        got, maps = TE.generate_edit_from_images(
            tt, *jp[:2], Image.fromarray(inst), json_obj, nimg, wh, args,
            feats=jp[2])
        assert got.shape == (48, 80, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)


def test_load_trainer_reads_converted_checkpoint(tmp_path, small_trainers):
    """cli.edit_vkitti.load_trainer --ckpt_dir loads the converters' output
    ({"netG", "netE"} state_dicts) into nets equal to the converted ones;
    without it the weights come from --seed and the global generator is
    left as it was."""
    from types import SimpleNamespace as NS

    from sdn3d_tpu_torch.cli.edit_vkitti import load_trainer

    _, _, tt = small_trainers
    ckpt = tmp_path / "tex.pt"
    torch.save({"netG": tt.netG.state_dict(), "netE": tt.netE.state_dict()},
               ckpt)
    small = TT.TexturalConfig(**TT.SMALL_NET_OVERRIDES)
    got = load_trainer(NS(device="cpu", seed=0, ckpt_dir=str(ckpt)), small)
    for a, b in ((got.netG, tt.netG), (got.netE, tt.netE)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    before = torch.random.get_rng_state()
    r1 = load_trainer(NS(device="cpu", seed=5, ckpt_dir=None), small)
    r2 = load_trainer(NS(device="cpu", seed=5, ckpt_dir=None), small)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(torch.equal(x, y) for x, y in zip(r1.netG.parameters(),
                                                 r2.netG.parameters()))


def test_visualizer_and_metrics_match_jax():
    """tensor2im, tensor2label, psnr and ssim: the port's numpy copies
    equal the JAX package's."""
    from sdn3d_tpu.utils import metrics as JM
    from sdn3d_tpu.utils import visualizer as JV
    from sdn3d_tpu_torch.utils import metrics as TM
    from sdn3d_tpu_torch.utils import visualizer as TV

    rng = np.random.RandomState(7)
    a = rng.uniform(-1.2, 1.2, (24, 40, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (24, 40, 3)).astype(np.float32)
    lab = rng.randint(0, 15, (24, 40))
    np.testing.assert_array_equal(TV.tensor2im(a), JV.tensor2im(a))
    np.testing.assert_array_equal(TV.tensor2label(lab, 14),
                                  JV.tensor2label(lab, 14))
    ia, ib = TV.tensor2im(a), TV.tensor2im(b)
    assert TM.psnr(ia, ib) == JM.psnr(ia, ib)
    assert TM.ssim(ia, ib) == JM.ssim(ia, ib)

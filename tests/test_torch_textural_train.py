"""The port's textural training (sdn3d_tpu_torch.models.pix2pixhd's
discriminators, global encoder and losses, models.vgg, utils.image_pool,
pipelines.textural's trainer, data.textural_data's training dataset,
cli.textural_train) against the JAX package's, on the CPU, at the JAX
tests' small configuration (SMALL_NET_OVERRIDES, 32 x 48 images).

The JAX parameters come from each flax module's own init at tiny shapes
(TexturalTrainer.init costs ~70 s of CPU compiles), and utils/port
converts them.  A training iteration is compared in two parts, as JAX's
own parity test advises (Adam's first step is ~lr * sign(g), so a 1-ulp
difference in a near-zero gradient moves a parameter by up to 2 lr): the
gradients of both packages from identical inputs, read out by an
optimizer that records them and moves nothing; and Adam applied to
identical gradients.  The draws (the global encoder's eps, the device
pool's decisions) are JAX's, handed to the port."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models import pix2pixhd as JX
from sdn3d_tpu.models import vgg as JV
from sdn3d_tpu.pipelines import textural as JT
from sdn3d_tpu.utils import image_pool as JP
from sdn3d_tpu_torch.models import pix2pixhd as TX
from sdn3d_tpu_torch.models import vgg as TV
from sdn3d_tpu_torch.pipelines import textural as TT
from sdn3d_tpu_torch.utils import image_pool as TP
from sdn3d_tpu_torch.utils import port as TPORT

H, W = 32, 48
# Module outputs (D features, VGG taps, the global encoder's heads, the
# pools and the instance average): the two packages sum convolutions and
# reductions in different orders; float32 rounding, relative to the
# output's largest magnitude.
MOD_RTOL = 2e-5
# Losses of a training iteration (relative) and its gradients: each
# parameter's within GRAD_RTOL of the larger of its own largest entry and
# GRAD_FLOOR times the largest gradient of its optimizer, and at cosine
# GRAD_COS where its entries reach that floor.  A bias that an instance
# norm follows has an analytic gradient of zero, and both packages give
# rounding noise there (~1e-6 of the largest gradient).  Measured: losses
# 2e-7, gradients 4e-5 of their scale.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR, GRAD_COS = 1e-3, 1e-2, 0.99999
# Parameters and moments after Adam steps from identical gradients: within
# 2 ulp of optax's (elementwise, optax's order; XLA's CPU backend may fuse
# the moment updates into FMAs), as tests/test_torch_derender_train.py
# holds the derenderer's.  After one whole iteration each parameter moves
# by ~lr, and a near-zero gradient's sign can differ between the packages,
# so they are held to ADAM_ITER_ATOL.
ADAM_ITER_ATOL = 2.5 * 2e-4


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e} of the largest (bound {rtol})"
    return err


def _small_cfg(**kw):
    return (JT.TexturalConfig(**JT.SMALL_NET_OVERRIDES, **kw),
            TT.TexturalConfig(**TT.SMALL_NET_OVERRIDES, **kw))


# -- the modules --------------------------------------------------------------

def test_reflect_pad_forward_and_gradient_equal_f_pad():
    """The concatenation of flipped slices is F.pad's reflection: the
    forward bit for bit, the gradient within 1e-6 (a border pixel sums up
    to four cotangent entries, which the two add in different orders)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 9, 7)
                         .astype(np.float32))
    cot = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 15, 13)
                           .astype(np.float32))
    for p in (1, 3):
        a = x.clone().requires_grad_(True)
        b = x.clone().requires_grad_(True)
        ya, yb = TX.reflect_pad(a, p), F.pad(b, (p,) * 4, mode="reflect")
        assert torch.equal(ya, yb)
        c = cot[..., 3 - p:12 + p, 3 - p:10 + p]
        ga, = torch.autograd.grad(ya, a, c)
        gb, = torch.autograd.grad(yb, b, c)
        torch.testing.assert_close(ga, gb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ndf,n_layers", [(8, 2), (64, 3)])
def test_discriminator_features_match_jax(ndf, n_layers):
    """MultiscaleDiscriminator (2 scales) at the small and the full width:
    every scale's every feature within MOD_RTOL; the converted keys are
    the reference's scale{i}_layer{j}.0."""
    nc = 18
    jd = JX.MultiscaleDiscriminator(ndf, n_layers, 2)
    x = np.random.RandomState(2).uniform(-1, 1, (2, H, W, nc)).astype(
        np.float32)
    params = _np_tree(jd.init(jax.random.PRNGKey(3),
                              jnp.zeros((1, 16, 16, nc)))["params"])
    want = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    td = TX.MultiscaleDiscriminator(nc, ndf, n_layers, 2)
    sd = TPORT.discriminator_state_dict_from_jax(params)
    assert sorted(sd) == sorted(td.state_dict())
    assert "scale1_layer0.0.weight" in sd
    td.load_state_dict(sd)
    with torch.no_grad():
        got = td(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    for i, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws) == n_layers + 2
        for j, (g, w) in enumerate(zip(gs, ws)):
            assert g.dtype == torch.float32
            _close(_nhwc(g), w, MOD_RTOL, f"scale {i} layer {j}")


def test_vgg_taps_and_loss_match_jax():
    """Vgg19Features' five taps and vgg_loss (the real taps detached: no
    gradient reaches the real image) within MOD_RTOL; the converted keys
    are torchvision's features.N."""
    params = _np_tree(JV.Vgg19Features().init(jax.random.PRNGKey(4),
                                              jnp.zeros((1, 16, 16, 3))))
    rng = np.random.RandomState(5)
    fake = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    taps = jax.jit(JV.Vgg19Features().apply)(params, jnp.asarray(fake))
    loss, grad = jax.jit(jax.value_and_grad(
        lambda f: JV.vgg_loss(params, f, jnp.asarray(real))))(
            jnp.asarray(fake))
    tv = TV.Vgg19Features()
    sd = TPORT.vgg19_state_dict_from_jax(params)
    assert sorted(sd) == sorted(tv.state_dict())
    assert "features.28.weight" in sd
    tv.load_state_dict(sd)
    tv.requires_grad_(False)
    f = torch.from_numpy(fake).permute(0, 3, 1, 2).requires_grad_(True)
    r = torch.from_numpy(real).permute(0, 3, 1, 2).requires_grad_(True)
    for k, (g, w) in enumerate(zip(tv(f), taps)):
        _close(_nhwc(g), w, MOD_RTOL, f"tap {k}")
    tl = TV.vgg_loss(tv, f, r)
    np.testing.assert_allclose(float(tl.detach()), float(loss),
                               rtol=LOSS_RTOL)
    gf, = torch.autograd.grad(tl, f)
    assert r.grad is None
    _close(_nhwc(gf), grad, GRAD_RTOL, "d vgg_loss / d fake")


def test_global_encoder_odd_width_matches_jax():
    """GlobalEncoder at 40 x 78, where the pooled shortcut pads odd dims
    at their end (39 -> 20, 5 -> 3) with count_include_pad=False: mu and
    logvar within MOD_RTOL; the input gradient too."""
    je = JX.GlobalEncoder(nz=3, nef=8)
    x = np.random.RandomState(6).uniform(-1, 1, (2, 40, 78, 3)).astype(
        np.float32)
    params = _np_tree(je.init(jax.random.PRNGKey(7),
                              jnp.zeros((1, 16, 16, 3)))["params"])
    mu, logvar = jax.jit(je.apply)({"params": params}, jnp.asarray(x))
    gx = jax.jit(jax.grad(lambda v: jnp.sum(
        je.apply({"params": params}, v)[0] * jnp.arange(1.0, 4.0))))(
            jnp.asarray(x))
    te = TX.GlobalEncoder(3, nz=3, nef=8)
    te.load_state_dict(TPORT.global_encoder_state_dict_from_jax(params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    tmu, tlv = te(xt)
    _close(tmu.detach(), mu, MOD_RTOL, "mu")
    _close(tlv.detach(), logvar, MOD_RTOL, "logvar")
    g, = torch.autograd.grad((tmu * torch.arange(1.0, 4.0)).sum(), xt)
    _close(_nhwc(g), gx, GRAD_RTOL, "d mu / d image")


@pytest.mark.parametrize("hw", [(9, 13), (16, 24)])
def test_avg_pool_3s2_nopad_count_matches_jax(hw):
    x = np.random.RandomState(8).randn(2, *hw, 5).astype(np.float32)
    want = np.asarray(JX.avg_pool_3s2_nopad_count(jnp.asarray(x)))
    got = _nhwc(TX.avg_pool_3s2_nopad_count(
        torch.from_numpy(x).permute(0, 3, 1, 2)))
    _close(got, want, 1e-6, "avg_pool_3s2_nopad_count")


def test_instance_average_and_gradient_match_jax():
    """instance_average (one-hot products both ways) and its gradient
    against JAX's segment sums and gather; an empty slot included."""
    rng = np.random.RandomState(9)
    feats = rng.randn(2, 12, 20, 5).astype(np.float32)
    slots = rng.randint(0, 6, (2, 12, 20)).astype(np.int32)
    slots[1][slots[1] == 3] = 4
    cot = rng.randn(2, 12, 20, 5).astype(np.float32)
    want, vjp = jax.vjp(lambda f: JX.instance_average(
        f, jnp.asarray(slots), 8), jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = TX.instance_average(f, torch.from_numpy(slots), 8)
    _close(got.detach(), want, MOD_RTOL, "instance_average")
    g, = torch.autograd.grad(got, f, torch.from_numpy(cot))
    _close(g, vjp(jnp.asarray(cot))[0], MOD_RTOL, "its gradient")


def test_losses_match_jax():
    """gan_loss_lsgan, feature_matching_loss (the real features
    detached), kl_loss and reparameterize (given JAX's eps)."""
    rng = np.random.RandomState(10)
    shapes = [[(1, 4, 6, 8), (1, 3, 4, 1)], [(1, 3, 4, 8), (1, 2, 3, 1)]]
    fake = [[rng.randn(*s).astype(np.float32) for s in sc] for sc in shapes]
    real = [[rng.randn(*s).astype(np.float32) for s in sc] for sc in shapes]

    def t(tree):
        return [[torch.from_numpy(a).permute(0, 3, 1, 2) for a in sc]
                for sc in tree]

    def j(tree):
        return [[jnp.asarray(a) for a in sc] for sc in tree]
    for real_target in (True, False):
        np.testing.assert_allclose(
            float(TX.gan_loss_lsgan(t(fake), real_target)),
            float(JX.gan_loss_lsgan(j(fake), real_target)), rtol=1e-6)
    tf = t(fake)
    for sc in tf:
        for a in sc:
            a.requires_grad_(True)
    tr = t(real)
    for sc in tr:
        for a in sc:
            a.requires_grad_(True)
    loss = TX.feature_matching_loss(tf, tr, 2, 1, 5.0)
    np.testing.assert_allclose(
        float(loss), float(JX.feature_matching_loss(j(fake), j(real), 2, 1,
                                                    5.0)), rtol=1e-6)
    loss.backward()
    assert all(a.grad is None for sc in tr for a in sc)
    mu = rng.randn(2, 3).astype(np.float32)
    logvar = rng.randn(2, 3).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        float(TX.kl_loss(torch.from_numpy(mu), torch.from_numpy(logvar))),
        float(JX.kl_loss(jnp.asarray(mu), jnp.asarray(logvar))), rtol=1e-6)
    key = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(key, (2, 3)))
    want = np.asarray(JX.reparameterize(jnp.asarray(mu), jnp.asarray(logvar),
                                        key))
    got = torch.from_numpy(mu) + torch.exp(0.5 * torch.from_numpy(logvar)) \
        * torch.from_numpy(eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    z = TX.reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar), g)
    assert z.shape == (2, 3) and torch.isfinite(z).all()


def test_local_enhancer_matches_jax():
    """LocalEnhancer (one enhancer level, small widths): the reference's
    module layout (model, model1_1, model1_2) loaded from the JAX params,
    the output within MOD_RTOL."""
    je = JX.LocalEnhancer(3, ngf=4, n_downsample_global=2,
                          n_blocks_global=2, n_local_enhancers=1,
                          n_blocks_local=1)
    x = np.random.RandomState(12).uniform(-1, 1, (1, H, W, 6)).astype(
        np.float32)
    P = _np_tree(je.init(jax.random.PRNGKey(13),
                         jnp.zeros((1, 16, 16, 6)))["params"])
    want = jax.jit(je.apply)({"params": P}, jnp.asarray(x))
    te = TX.LocalEnhancer(6, 3, ngf=4, n_downsample_global=2,
                          n_blocks_global=2, n_local_enhancers=1,
                          n_blocks_local=1)
    # the trunk is GlobalGenerator's model less its last three modules
    # (reflection pad, conv_out at model.19, tanh)
    sd = TPORT.global_generator_state_dict_from_jax(
        {**P["global"], "conv_out": P["conv_out"]}, 2, 2)
    del sd["model.19.weight"], sd["model.19.bias"]
    TPORT._conv(sd, "model1_1.1", P["enh1_conv_in"])
    TPORT._conv(sd, "model1_1.4", P["enh1_down"])
    TPORT._conv(sd, "model1_2.0.conv_block.1", P["enh1_res0"]["conv1"])
    TPORT._conv(sd, "model1_2.0.conv_block.5", P["enh1_res0"]["conv2"])
    TPORT._conv(sd, "model1_2.1", P["enh1_up"])
    TPORT._conv(sd, "model1_2.5", P["conv_out"])
    te.load_state_dict(sd)
    with torch.no_grad():
        got = te(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(_nhwc(got), want, MOD_RTOL, "LocalEnhancer")


def test_image_pool_equals_jax_bit_for_bit():
    """The host ImagePool: the same numpy RandomState draws, so the same
    outputs and the same history as JAX's, over a fill and swaps."""
    rng = np.random.RandomState(14)
    jp, tp = JP.ImagePool(3, seed=5), TP.ImagePool(3, seed=5)
    for _ in range(6):
        x = rng.randn(2, 4, 5, 3).astype(np.float32)
        np.testing.assert_array_equal(tp.query(x), jp.query(x))
    for a, b in zip(tp.images, jp.images):
        np.testing.assert_array_equal(a, b)
    x = rng.randn(2, 4).astype(np.float32)
    assert TP.ImagePool(0).query(x) is x


def _jax_pool_decisions(key, batch: int, n: int):
    """JAX DeviceImagePool.query's draws for a full buffer of n:
    [(use the history, index)] per sample."""
    out = []
    for k in jax.random.split(key, batch):
        k1, k2 = jax.random.split(k)
        out.append((bool(jax.random.uniform(k1) > 0.5),
                    int(jax.random.randint(k2, (), 0, max(n, 1)))))
    return out


def test_device_image_pool_given_jax_decisions(monkeypatch):
    """DeviceImagePool, handed JAX's decisions, returns the outputs and
    keeps the buffer of JAX's DeviceImagePool, sample by sample (a fill,
    then queries on the full buffer)."""
    P_, shape = 3, (3, 4, 2)
    rng = np.random.RandomState(15)
    jpool = JP.DeviceImagePool.create(P_, shape)
    tpool = TP.DeviceImagePool.create(P_, (2, 3, 4))
    draws = []
    monkeypatch.setattr(TP.DeviceImagePool, "draw", lambda self, g: tuple(
        torch.tensor(v) for v in draws.pop(0)))
    for k in range(5):
        x = rng.randn(2, *shape).astype(np.float32)
        key = jax.random.PRNGKey(100 + k)
        n = tpool.n
        for s, d in enumerate(_jax_pool_decisions(key, 2, P_)):
            if n < P_:                # filling: no draw is used
                n += 1
            else:
                draws.append(d)
        want, jpool = jpool.query(jnp.asarray(x), key)
        got = tpool.query(torch.from_numpy(x).permute(0, 3, 1, 2), None)
        assert not draws
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
        np.testing.assert_array_equal(
            tpool.buf.permute(0, 2, 3, 1).numpy(), np.asarray(jpool.buf))
    assert tpool.n == int(jpool.n) == P_


# -- the trainer ----------------------------------------------------------------

def _recorder():
    """An optax transformation whose state is the last gradient and whose
    update moves nothing: the gradients of a jitted step, read out."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def _jax_state(jt, seed: int, tx_g=None, tx_d=None):
    """A JAX TexturalState from each flax module's own init at 16 x 16
    (tx_g / tx_d initialise the optimizers; the trainer's Adam by
    default)."""
    c = jt.cfg
    kg, kd, ke, kv, kge = jax.random.split(jax.random.PRNGKey(seed), 5)
    z = lambda n: jnp.zeros((1, 16, 16, n))  # noqa: E731
    pg = jt.netG.init(kg, z(c.netG_input_nc))["params"]
    pd = jt.netD.init(kd, z(c.netD_input_nc))["params"]
    pe = jt.netE.init(ke, z(3))["params"]
    vgg = JV.Vgg19Features().init(kv, z(3))
    pge = jt.netGlobalE.init(kge, z(3))["params"] if c.use_global_encoder \
        else {}
    tx_g, tx_d = tx_g or jt.tx_g, tx_d or jt.tx_d
    return JT.TexturalState(
        step=jnp.zeros((), jnp.int32), params_g=pg, params_d=pd,
        params_e=pe, vgg=vgg, opt_g=tx_g.init({"g": pg, "e": pe, "ge": pge}),
        opt_d=tx_d.init(pd), params_ge=pge)


def _batch(seed: int, B: int = 1):
    """The JAX tests' batch (a half-image instance) at H x W, numpy."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((B, H, W), np.int32)
    inst[:, :, W // 2:] = 1
    inst[:, 4:12, 6:20] = 2
    return {"label": rng.randint(0, 14, (B, H, W)).astype(np.int32),
            "inst": inst * 1000, "inst_slots": inst,
            "image": rng.rand(B, H, W, 3).astype(np.float32) * 2 - 1,
            "pose": rng.randint(0, 25, (B, H, W)).astype(np.int32),
            "normal": rng.rand(B, H, W, 3).astype(np.float32)}


def _port(jstate, tcfg):
    """The port's trainer and state from a JAX state
    (textural_train_state_from_jax)."""
    tt = TT.TexturalTrainer(tcfg).to("cpu")
    state = tt.init(torch.Generator().manual_seed(0), H, W)
    state.load_fields(TPORT.textural_train_state_from_jax(jstate))
    return tt, state


class _Record:
    """Port-side recorder: apply_g / apply_d keep the gradients, move
    nothing."""

    def __init__(self, tt):
        self.g, self.d = [], []
        tt.apply_g = lambda state, grads: self.g.append(list(grads))
        tt.apply_d = lambda state, grads: self.d.append(list(grads))


def _compare_grads(state, rec, jgrads_g, jgrads_d):
    """Every G-optimizer and D gradient of the port against JAX's (see
    GRAD_RTOL).  Returns the worst relative error."""
    worst = 0.0
    for named, grads, want in (
            (state.g_named(), rec.g[0], _named_g(jgrads_g)),
            (state.d_named(), rec.d[0], TPORT.discriminator_state_dict_from_jax(
                _np_tree(jgrads_d)))):
        assert len(grads) == len(want) == len(named)
        top = max(float(v.abs().max()) for v in want.values())
        for (n, _), g in zip(named, grads):
            g, w = g.detach().double(), want[n].double()
            scale = float(w.abs().max())
            err = float((g - w).abs().max()) / max(scale, GRAD_FLOOR * top)
            cos = float((g * w).sum() / (g.norm() * w.norm() + 1e-300))
            assert err <= GRAD_RTOL, f"{n}: {err:.3e} (bound {GRAD_RTOL})"
            assert scale < GRAD_FLOOR * top or cos >= GRAD_COS, \
                f"{n}: cosine {cos:.7f}"
            worst = max(worst, err)
    return worst


def _named_g(tree) -> dict:
    """A JAX {"g", "e", "ge"} tree by the port's G-optimizer names."""
    tree = _np_tree(tree)
    out = {}
    for net, sd in (("netG", TPORT.global_generator_state_dict_from_jax(
            tree["g"], TPORT._count(tree["g"], "down"),
            TPORT._count(tree["g"], "res"))),
            ("netE", TPORT.encoder_state_dict_from_jax(
                tree["e"], TPORT._count(tree["e"], "down")))):
        out.update({f"{net}.{k}": v for k, v in sd.items()})
    if tree["ge"]:
        out.update({f"netGlobalE.{k}": v for k, v in
                    TPORT.global_encoder_state_dict_from_jax(
                        tree["ge"]).items()})
    return out


@pytest.fixture(scope="module")
def fused():
    """One fused iteration of each package from the same state and batch
    (VGG loss on, no pool, no global encoder), the optimizers replaced by
    recorders: JAX's losses and gradients, and its state (Adam's)."""
    jcfg, tcfg = _small_cfg()
    jt = JT.TexturalTrainer(jcfg)
    jstate = _jax_state(jt, 20)
    jt.tx_g, jt.tx_d = _recorder(), _recorder()
    rstate = _jax_state(jt, 20, jt.tx_g, jt.tx_d)
    batch = _batch(21)
    out, losses, _ = jax.jit(jt.make_train_iteration())(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jcfg, tcfg, jstate, batch, {k: float(v) for k, v in
                                        losses.items()},
            out.opt_g, out.opt_d)


def test_train_iteration_gradients_match_jax(fused):
    """make_train_iteration from a converted state: the losses within
    LOSS_RTOL and every gradient (G, E; D from the same detached fake
    and the real pair's features of the G half) within GRAD_RTOL of
    JAX's."""
    jcfg, tcfg, jstate, batch, jlosses, jg, jd = fused
    tt, state = _port(jstate, tcfg)
    rec = _Record(tt)
    state, losses, pool = tt.make_train_iteration()(state, batch)
    assert pool is None and state.step == 1
    assert sorted(losses) == sorted(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), jlosses[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    _compare_grads(state, rec, jg, jd)


def _jax_adam(jt, jstate, jg, jd):
    """JAX's Adam step (the trainer's tx_g / tx_d) on gradients jg, jd:
    ({"g", "e", "ge"} params, D params, opt_g, opt_d)."""
    params = {"g": jstate.params_g, "e": jstate.params_e,
              "ge": jstate.params_ge}
    upd, opt_g = jt.tx_g.update(jg, jstate.opt_g, params)
    upd_d, opt_d = jt.tx_d.update(jd, jstate.opt_d, jstate.params_d)
    return (optax.apply_updates(params, upd),
            optax.apply_updates(jstate.params_d, upd_d), opt_g, opt_d)


def test_adam_on_identical_gradients_equals_optax(fused):
    """AdamState.step (pipelines/derender_infer.adam_step with b1 0.5)
    given JAX's gradients: the parameters and both moments after two
    steps within 2 ulp of optax.adam(2e-4, b1=0.5, b2=0.999)'s."""
    jcfg, tcfg, jstate, _, _, jg, jd = fused
    jt = JT.TexturalTrainer(jcfg)
    tt, state = _port(jstate, tcfg)
    named_g, named_d = state.g_named(), state.d_named()
    tg = _named_g(jg)
    td = TPORT.discriminator_state_dict_from_jax(_np_tree(jd))
    js = jstate
    for _ in range(2):
        tt.apply_g(state, [tg[n] for n, _ in named_g])
        tt.apply_d(state, [td[n] for n, _ in named_d])
        pg, pd, og, od = _jax_adam(jt, js, jg, jd)
        js = dataclasses.replace(js, params_g=pg["g"], params_e=pg["e"],
                                 params_ge=pg["ge"], params_d=pd,
                                 opt_g=og, opt_d=od)
    want = TPORT.textural_train_state_from_jax(js)
    got = state.fields()
    def ulps(a, w, what):
        w = w.numpy()
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=2 * np.spacing(np.abs(w)).max(),
                                   err_msg=what)
    for net in ("netG", "netE", "netD"):
        for k, v in want[net].items():
            ulps(got[net][k], v, f"{net}.{k}")
    for opt in ("opt_g", "opt_d"):
        assert int(got[opt]["count"]) == int(want[opt]["count"]) == 2
        for m in ("mu", "nu"):
            for k, v in want[opt][m].items():
                ulps(got[opt][m][k], v, f"{m} {k}")


def test_train_iteration_with_adam_matches_jax(fused):
    """One whole make_train_iteration with Adam from the converted state:
    the losses within LOSS_RTOL, every parameter within ADAM_ITER_ATOL of
    JAX's Adam step on JAX's gradients, the counts and the step."""
    jcfg, tcfg, jstate, batch, jlosses, jg, jd = fused
    jt = JT.TexturalTrainer(jcfg)
    tt, state = _port(jstate, tcfg)
    state, losses, _ = tt.make_train_iteration()(state, batch)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), jlosses[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    pg, pd, og, od = _jax_adam(jt, jstate, jg, jd)
    want = TPORT.textural_train_state_from_jax(dataclasses.replace(
        jstate, step=jstate.step + 1, params_g=pg["g"], params_e=pg["e"],
        params_ge=pg["ge"], params_d=pd, opt_g=og, opt_d=od))
    got = state.fields()
    assert int(got["step"]) == int(want["step"]) == 1
    for net in ("netG", "netE", "netD"):
        for k, v in want[net].items():
            np.testing.assert_allclose(got[net][k].numpy(), v.numpy(),
                                       rtol=0, atol=ADAM_ITER_ATOL,
                                       err_msg=f"{net}.{k}")
    for k, v in want["vgg"].items():
        np.testing.assert_array_equal(got["vgg"][k].numpy(), v.numpy())


def test_g_and_d_steps_match_jax(fused):
    """The two-dispatch pair, make_g_step then make_d_step (which makes
    its own fake), from the converted state: the losses within LOSS_RTOL
    and every gradient as in the fused iteration; g_step advances the
    step, d_step does not."""
    jcfg, tcfg, jstate, batch, *_ = fused
    jt = JT.TexturalTrainer(jcfg)
    jt.tx_g, jt.tx_d = _recorder(), _recorder()
    rstate = _jax_state(jt, 20, jt.tx_g, jt.tx_d)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s1, jgl = jax.jit(jt.make_g_step())(rstate, jb)
    s2, jdl = jax.jit(jt.make_d_step())(s1, jb)
    tt, state = _port(jstate, tcfg)
    rec = _Record(tt)
    state, gl = tt.make_g_step()(state, batch)
    assert state.step == 1
    state, dl = tt.make_d_step()(state, batch)
    assert state.step == 1
    for k, v in {**jgl, **jdl}.items():
        np.testing.assert_allclose(float({**gl, **dl}[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    _compare_grads(state, rec, s1.opt_g, s2.opt_d)


def test_global_encoder_and_pool_iteration_matches_jax(monkeypatch):
    """One fused iteration with use_global_encoder (nef 8) and a device
    history pool of one over a batch of two, so the second sample meets a
    full pool and swaps with the first (JAX's draw): the port is handed
    JAX's eps and pool decisions.  Losses (E_VAE included) within
    LOSS_RTOL, every gradient (netGlobalE's included) as above, the pool's
    buffer equal."""
    jcfg, tcfg = _small_cfg(use_global_encoder=True, global_encoder_nef=8,
                            pool_size=1)
    jt = JT.TexturalTrainer(jcfg)
    jstate = _jax_state(jt, 30)
    # a key whose second sample takes the pool's history
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        kz, kpool = jax.random.split(key)
        use, idx = _jax_pool_decisions(kpool, 2, 1)[1]
        if use:
            break
    assert use
    eps = torch.from_numpy(np.array(jax.random.normal(kz, (2, 3))))
    jt.tx_g, jt.tx_d = _recorder(), _recorder()
    rstate = _jax_state(jt, 30, jt.tx_g, jt.tx_d)
    batch = _batch(31, B=2)
    out, jlosses, jpool = jax.jit(jt.make_train_iteration())(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jt.device_pool(H, W))
    tt, state = _port(jstate, tcfg)
    rec = _Record(tt)
    monkeypatch.setattr(TT, "reparameterize", lambda mu, logvar, g: (
        mu + torch.exp(0.5 * logvar) * eps))
    decisions = [(torch.tensor(use), torch.tensor(idx))]
    monkeypatch.setattr(TP.DeviceImagePool, "draw",
                        lambda self, g: decisions.pop(0))
    state, losses, pool = tt.make_train_iteration()(
        state, batch, torch.Generator().manual_seed(0), tt.device_pool(H, W))
    assert not decisions and "E_VAE" in losses
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert any(n.startswith("netGlobalE.") for n, _ in state.g_named())
    _compare_grads(state, rec, out.opt_g, out.opt_d)
    _close(pool.buf.permute(0, 2, 3, 1).numpy(), np.asarray(jpool.buf),
           MOD_RTOL, "pool buffer")
    assert pool.n == int(jpool.n) == 1


def test_pooled_fake_concat_and_d_step_match_jax(fused):
    """The host-pool path (pooled_fake_concat, then d_step on its stack):
    the same RandomState(0) decisions, so over three queries of a pool of
    two (two fills, then a draw) the stacks equal JAX's within MOD_RTOL,
    and so do the D losses."""
    jcfg, tcfg, jstate, batch, *_ = fused
    jcfg, tcfg = (dataclasses.replace(c, pool_size=2) for c in (jcfg, tcfg))
    jt = JT.TexturalTrainer(jcfg)
    tt, state = _port(jstate, tcfg)
    d_step = jax.jit(jt.make_d_step())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = jstate
    for i in range(3):
        b = dict(batch, image=np.roll(batch["image"], 3 * i, axis=2))
        jb = dict(jb, image=jnp.asarray(b["image"]))
        jfc = jt.pooled_fake_concat(js, jb)
        tfc = tt.pooled_fake_concat(state, b)
        _close(_nhwc(tfc), jfc, MOD_RTOL, f"stack {i}")
        js, jl = d_step(js, jb, None, jfc)
        state, tl = tt.make_d_step()(state, b, None, tfc)
        for k, v in jl.items():
            np.testing.assert_allclose(float(tl[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=(i, k))
    assert len(tt.fake_pool.images) == len(jt.fake_pool.images) == 2


def test_fake_inference_encoder_paths_match_jax(fused):
    """fake_inference with no code table (netE on the image, averaged per
    instance) and with a per-pixel code map, float inputs: within
    MOD_RTOL of JAX's."""
    jcfg, tcfg, jstate, batch, *_ = fused
    jt = JT.TexturalTrainer(jcfg)
    tt, _ = _port(jstate, tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jt.fake_inference_jit(jstate, jb)
    _close(tt.fake_inference(tb).numpy(), want, MOD_RTOL, "netE path")
    fmap = np.random.RandomState(60).uniform(-1, 1, (1, H, W, 5)).astype(
        np.float32)
    want = jt.fake_inference_jit(jstate, jb, jnp.asarray(fmap))
    _close(tt.fake_inference(tb, torch.from_numpy(fmap)).numpy(), want,
           MOD_RTOL, "per-pixel codes")


def test_steps_need_a_generator():
    """As in JAX: with the global encoder the steps and the iteration
    raise ValueError without a generator, and so does the iteration given
    a pool without one."""
    _, tcfg = _small_cfg(use_global_encoder=True, global_encoder_nef=8)
    tt = TT.TexturalTrainer(tcfg).to("cpu")
    state = tt.init(torch.Generator().manual_seed(0), H, W)
    batch = _batch(1)
    with pytest.raises(ValueError, match="generator"):
        tt.make_g_step()(state, batch)
    with pytest.raises(ValueError, match="generator"):
        tt.make_d_step()(state, batch)
    with pytest.raises(ValueError, match="generator"):
        tt.make_train_iteration()(state, batch)
    _, tcfg = _small_cfg(pool_size=2)
    tt = TT.TexturalTrainer(tcfg).to("cpu")
    state = tt.init(torch.Generator().manual_seed(0), H, W)
    with pytest.raises(ValueError, match="pool"):
        tt.make_train_iteration()(state, batch, None, tt.device_pool(H, W))


def test_config_equals_jax():
    """TexturalConfig equals JAX's field by field (defaults, the small
    overrides, the variants' input channels), and config_from_train_meta
    carries use_global_encoder as JAX's does."""
    assert TT.SMALL_NET_OVERRIDES == JT.SMALL_NET_OVERRIDES
    assert [f.name for f in dataclasses.fields(TT.TexturalConfig)] == \
        [f.name for f in dataclasses.fields(JT.TexturalConfig)]
    for kw in ({}, JT.SMALL_NET_OVERRIDES, {"feat_depth": True},
               {"use_global_encoder": True, "use_instance_edges": False}):
        j, t = JT.TexturalConfig(**kw), TT.TexturalConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.netG_input_nc, t.netD_input_nc) == \
            (j.netG_input_nc, j.netD_input_nc)
    meta = {"small": True, "use_global_encoder": True, "no_vgg": True}
    assert dataclasses.asdict(TT.config_from_train_meta(meta)) == \
        dataclasses.asdict(JT.config_from_train_meta(meta))


# -- the dataset ------------------------------------------------------------------

@pytest.fixture()
def textural_fixture(tmp_path):
    """JAX tests/test_textural_pipeline.py's fixture: rgb + segm +
    geometric outputs for 2 train-split frames (0001/clone 0 and 1)."""
    from PIL import Image

    root, segm, geo = (str(tmp_path / d) for d in ("vk", "segm", "geo"))
    W_, H_ = 64, 32
    rng = np.random.RandomState(0)
    for frame in (0, 1):
        rel = f"0001/clone/{frame:05d}.png"
        for base in (os.path.join(root, "vkitti_1.3.1_rgb"), segm, geo):
            os.makedirs(os.path.dirname(os.path.join(base, rel)),
                        exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (H_, W_, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "vkitti_1.3.1_rgb", rel))
        lab = np.full((H_, W_), 4, np.uint8)
        lab[4:12, 8:24] = 1           # car, half covered by instance 1
        lab[20:28, 40:56] = 11        # van, not covered by any instance
        Image.fromarray(lab).save(os.path.join(segm, rel))
        inst = np.zeros((H_, W_), np.uint8)
        inst[4:12, 8:16] = 1
        Image.fromarray(inst).save(os.path.join(geo, rel))
        with open(os.path.join(geo, rel.replace(".png", ".json")), "w") as f:
            json.dump({"1": {"class_id": 1, "alpha": 0.5, "depth": 9.0}}, f)
        Image.fromarray(rng.randint(0, 255, (H_, W_, 3), dtype=np.uint8)
                        ).save(os.path.join(geo, rel.replace(".png",
                                                             "-normal.png")))
    return root, segm, geo, (W_, H_)


def _same_sample(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _datasets(*args, **kw):
    from sdn3d_tpu.data.textural_data import TexturalVKittiDataset as JDS
    from sdn3d_tpu_torch.data.textural_data import TexturalVKittiDataset \
        as TDS
    return JDS(*args, **kw), TDS(*args, **kw)


@pytest.mark.parametrize("augment,fine_h", [(True, 16), (False, 32)])
def test_textural_dataset_equals_jax(textural_fixture, augment, fine_h):
    """TexturalVKittiDataset items (colour jitter, random crop and flip
    from the same RandomState) and batches byte-equal to JAX's, and the
    test-split view (centre crop, no flip)."""
    root, segm, geo, (W_, _) = textural_fixture
    jds, tds = _datasets(root, segm, geo, split="train", load_size=W_,
                         fine_wh=(W_, fine_h), max_instances=8,
                         augment=augment)
    assert tds.rels == jds.rels and len(tds) == 2
    for i in range(2):
        _same_sample(tds.__getitem__(i, np.random.RandomState(7 + i)),
                     jds.__getitem__(i, np.random.RandomState(7 + i)))
        _same_sample(tds[i], jds[i])
    _same_sample(tds.batch(np.random.RandomState(2), 3),
                 jds.batch(np.random.RandomState(2), 3))
    jds.train = tds.train = False
    _same_sample(tds[1], jds[1])


def test_textural_dataset_fallbacks_equal_jax(textural_fixture, tmp_path):
    """The missing-instance-map fallback (inst = label, car / van kept),
    a partial depth coverage (no depth key anywhere) and a full one (the
    depth plane), each byte-equal to JAX's."""
    from PIL import Image

    root, segm, geo, (W_, H_) = textural_fixture
    jds, tds = _datasets(root, segm, str(tmp_path / "empty_geo"),
                         split="train", load_size=W_, fine_wh=(W_, H_),
                         max_instances=8)
    s = tds[0]
    _same_sample(s, jds[0])
    np.testing.assert_array_equal(s["inst"], s["label"])
    d = (np.ones((H_, W_)) * 30000).astype(np.uint16)
    Image.fromarray(d).save(os.path.join(geo, "0001/clone/00000-depth.png"))
    jds, tds = _datasets(root, segm, geo, split="train", load_size=W_,
                         fine_wh=(W_, H_), max_instances=8)
    assert not tds.with_depth and "depth" not in tds[0]
    _same_sample(tds[0], jds[0])
    Image.fromarray(d // 2).save(os.path.join(geo,
                                              "0001/clone/00001-depth.png"))
    jds, tds = _datasets(root, segm, geo, split="train", load_size=W_,
                         fine_wh=(W_, H_), max_instances=8)
    assert tds.with_depth and "depth" in tds[1]
    for i in range(2):
        _same_sample(tds.__getitem__(i, np.random.RandomState(i)),
                     jds.__getitem__(i, np.random.RandomState(i)))


def test_splat_feat_codes_equals_jax():
    from sdn3d_tpu.data.textural_data import splat_feat_codes as j_splat
    from sdn3d_tpu_torch.data.textural_data import splat_feat_codes

    inst = np.random.RandomState(3).randint(0, 4, (6, 9)) * 1000
    codes = {0: [0.1] * 5, 2000: np.arange(5.0), 7000: [1.0] * 5}
    np.testing.assert_array_equal(splat_feat_codes(inst, codes),
                                  j_splat(inst, codes))


# -- the CLI and the serving of a trained step ----------------------------------

def test_synthetic_batch_equals_jax():
    from sdn3d_tpu.cli.textural_train import synthetic_batch as j_batch
    from sdn3d_tpu_torch.cli.textural_train import synthetic_batch

    args = SimpleNamespace(fine_height=12, fine_width=20, batch_size=2)
    got = synthetic_batch(args, np.random.RandomState(0), TT.TexturalConfig())
    want = j_batch(args, np.random.RandomState(0), JT.TexturalConfig())
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _test_split_files(tmp_path, n: int = 2, wh=(W, H)):
    """Minimal per-stage files of the first n test-split frames, as
    semantic_test and geometric_main --vkitti_root write them: the RGB in
    the root's layout, the labels, instance maps, JSON and normals named
    {world}_{topic}_{frame}.  Returns (root, segm, geo, names)."""
    from PIL import Image

    from sdn3d_tpu_torch.data.vkitti import get_lists

    root, segm, geo = (str(tmp_path / d) for d in ("vk", "segm", "geo"))
    os.makedirs(segm)
    os.makedirs(geo)
    rng = np.random.RandomState(40)
    names = []
    for f in get_lists("test")[:n]:
        world, topic, png = f.split("/")
        name = f"{world}_{topic}_{png[:-4]}"
        names.append(name)
        os.makedirs(os.path.join(root, "vkitti_1.3.1_rgb", world, topic),
                    exist_ok=True)
        Image.fromarray(rng.randint(0, 255, wh[::-1] + (3,), dtype=np.uint8)
                        ).save(os.path.join(root, "vkitti_1.3.1_rgb", f))
        Image.fromarray(rng.randint(0, 13, wh[::-1]).astype(np.uint8)).save(
            os.path.join(segm, f"{name}.png"))
        inst = np.zeros(wh[::-1], np.uint8)
        inst[4:20, 6:30] = 1
        Image.fromarray(inst).save(os.path.join(geo, f"{name}.png"))
        with open(os.path.join(geo, f"{name}.json"), "w") as fh:
            json.dump({"1": {"class_id": 1, "alpha": 0.7}}, fh)
        Image.fromarray(rng.randint(0, 255, wh[::-1] + (3,), dtype=np.uint8)
                        ).save(os.path.join(geo, f"{name}-normal.png"))
    return root, segm, geo, names


def test_textural_train_cli_resumes_and_its_step_serves(tmp_path, capsys):
    """textural_train --synthetic --small --device cpu: 2 iterations, then
    a run that resumes from step 2 (its state's step 4, the step directory
    named by the run's own count as in JAX); the step holds the train
    state's fields, meta = the arguments, and textural_test serves it."""
    from sdn3d_tpu_torch.cli import textural_test, textural_train
    from sdn3d_tpu_torch.core.checkpoint import (latest_step, load_meta,
                                                 restore_checkpoint,
                                                 restore_variables)

    ck = str(tmp_path / "ck")
    argv = ["--synthetic", "--small", "--device", "cpu", "--num_iters", "2",
            "--fine_height", str(H), "--fine_width", str(W), "--ckpt_dir",
            ck]
    _, state = textural_train.main(argv)
    assert latest_step(ck) == 2 and state.step == 2
    before = {k: v.clone() for k, v in state.netG.state_dict().items()}
    _, state = textural_train.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "iter 0: G_GAN=" in out
    assert state.step == 4 and latest_step(ck) == 2
    fields, _ = restore_checkpoint(ck)
    assert sorted(fields) == ["netD", "netE", "netG", "opt_d", "opt_g",
                              "step", "vgg"]
    assert int(fields["step"]) == 4 and int(fields["opt_g"]["count"]) == 4
    assert not all(torch.equal(before[k], fields["netG"][k]) for k in before)
    assert load_meta(ck)["meta"]["small"] is True
    nets, _ = restore_variables(ck, ["netG", "netE"])
    assert sorted(nets) == ["netE", "netG"]
    root, segm, geo, names = _test_split_files(tmp_path)
    l1s = textural_test.main(["--data_root", root, "--segm_dir", segm,
                              "--geo_dir", geo, "--ckpt_dir", ck,
                              "--results_dir", str(tmp_path / "tt"),
                              "--load_size", str(W), "--fine_width", str(W),
                              "--fine_height", str(H), "--device", "cpu"])
    assert sorted(l1s) == sorted(names)
    assert all(np.isfinite(v) for v in l1s.values())


def test_textural_train_cli_dataset_mode(textural_fixture, tmp_path):
    """The train CLI on the on-disk layout (small nets, no VGG)."""
    from sdn3d_tpu_torch.cli import textural_train
    from sdn3d_tpu_torch.core.checkpoint import latest_step

    root, segm, geo, (W_, H_) = textural_fixture
    ck = str(tmp_path / "ck")
    _, state = textural_train.main([
        "--data_root", root, "--segm_dir", segm, "--geo_dir", geo,
        "--small", "--no_vgg", "--num_iters", "2", "--load_size", str(W_),
        "--fine_width", str(W_), "--fine_height", str((H_ // 4) * 4),
        "--save_every", "2", "--ckpt_dir", ck, "--device", "cpu"])
    assert latest_step(ck) == 2 and state.step == 2
    with pytest.raises(SystemExit):
        textural_train.main(["--data_root", root, "--device", "cpu",
                             "--ckpt_dir", ck])


def test_global_encoder_step_serves_as_jax(tmp_path, monkeypatch):
    """A --use_global_encoder step (a JAX state converted by
    textural_train_state_from_jax, meta as the CLI writes it): load_trainer
    rebuilds the nets with netGlobalE; fake_inference without a generator
    (the posterior mean) on the serving batch, edit_vkitti's
    generate_edit_from_images and textural_test's fakes equal JAX's
    fake_inference on the same inputs within MOD_RTOL."""
    from PIL import Image

    from sdn3d_tpu.cli import edit_vkitti as JE
    from sdn3d_tpu_torch.cli import edit_vkitti as TE
    from sdn3d_tpu_torch.cli import textural_test
    from sdn3d_tpu_torch.core.checkpoint import save_checkpoint

    meta = {"small": True, "use_global_encoder": True, "no_vgg": True}
    jcfg = JT.config_from_train_meta(meta)
    jt = JT.TexturalTrainer(jcfg)
    jstate = _jax_state(jt, 50)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, 3, TPORT.textural_train_state_from_jax(jstate),
                    meta=meta)
    tt = TE.load_trainer(SimpleNamespace(device="cpu", seed=0, ckpt_dir=ck,
                                         no_vgg=True))
    assert tt.cfg.use_global_encoder and tt.netGlobalE is not None
    assert tt.cfg == TT.config_from_train_meta(meta)

    rng = np.random.RandomState(51)
    B = 2
    inst = np.zeros((B, H, W), np.uint8)
    inst[:, 6:20, 10:30] = 1
    label = rng.randint(1, 5, (B, H, W)).astype(np.uint8)
    full = np.where(inst == 0, label.astype(np.int32),
                    inst.astype(np.int32) * 1000)
    slots = np.stack([np.searchsorted(np.unique(f), f) for f in full]
                     ).astype(np.uint8)
    batch = {"label": label, "inst": inst, "inst_slots": slots,
             "pose": rng.randint(0, 25, (B, H, W)).astype(np.uint8),
             "normal": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
             "normal_valid": np.asarray([1.0, 0.0], np.float32),
             "image": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)}
    table = rng.uniform(-1, 1, (B, 8, 5)).astype(np.float32)
    want = np.asarray(jt.fake_inference_jit(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(table)))
    got = tt.fake_inference({k: torch.from_numpy(v) for k, v in
                             batch.items()}, torch.from_numpy(table))
    _close(got.numpy(), want, MOD_RTOL, "fake_inference, posterior mean")
    # with a generator the sample moves the fake
    drawn = tt.fake_inference({k: torch.from_numpy(v) for k, v in
                               batch.items()}, torch.from_numpy(table),
                              torch.Generator().manual_seed(1))
    assert float((drawn - got).abs().max()) > 0

    src = Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8))
    lab = Image.fromarray(rng.randint(0, 4, (H, W)).astype(np.uint8))
    json_obj = {"1": {"class_id": 1, "alpha": 0.4}}
    args = SimpleNamespace(load_size=W)
    jp = JE.prepare_source_inputs(jt, jstate, src, lab, W, (W, H))
    w_fake, _ = JE.generate_edit_from_images(
        jt, jstate, *jp[:2], Image.fromarray(inst[0]), json_obj, None,
        (W, H), args, feats=jp[2])
    g_fake, _ = TE.generate_edit_from_images(
        tt, *jp[:2], Image.fromarray(inst[0]), json_obj, None, (W, H), args,
        feats=jp[2])
    _close(g_fake, w_fake, MOD_RTOL, "generate_edit_from_images")

    seen = []
    orig = TT.TexturalTrainer.fake_inference

    def spy(self, b, feat_map=None, generator=None):
        out = orig(self, b, feat_map, generator)
        seen.append(({k: v.numpy() for k, v in b.items()}, feat_map.numpy(),
                     out.numpy()))
        return out
    monkeypatch.setattr(TT.TexturalTrainer, "fake_inference", spy)
    root, segm, geo, names = _test_split_files(tmp_path, n=1)
    l1s = textural_test.main(["--data_root", root, "--segm_dir", segm,
                              "--geo_dir", geo, "--ckpt_dir", ck,
                              "--results_dir", str(tmp_path / "tt"),
                              "--load_size", str(W), "--fine_width", str(W),
                              "--fine_height", str(H), "--device", "cpu"])
    assert sorted(l1s) == names and len(seen) == 1
    b, feats, fake = seen[0]
    assert "image" in b
    want = jt.fake_inference_jit(jstate, {k: jnp.asarray(v) for k, v in
                                          b.items()}, jnp.asarray(feats))
    _close(fake, np.asarray(want), MOD_RTOL, "textural_test's fake")

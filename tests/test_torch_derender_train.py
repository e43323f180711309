"""The port's derenderer training (sdn3d_tpu_torch.pipelines.derender,
models/derenderer sampling and train-mode BatchNorm, cli/geometric_train)
against the JAX package's, on the CPU, at the JAX tests' small shapes
(image = render = 32, batch 4, three make_sphere_mesh(4, 8) classes,
Derenderer(num_classes=3)), both trainers started from the same state
(utils/port.derender_train_state_from_jax).

The gradient of one step is compared in its two halves, each from
identical inputs: the loss's gradient in the encoder's outputs at JAX's
encoder outputs (the render and the losses), and the encoder's backward
of JAX's cotangent (the trunk and its train-mode BatchNorm).  The whole
composition is not compared end to end: the two packages' encoder
outputs differ by ~1e-5 relative (summation orders, the layer-4 batch
statistics over 4 x 1 x 1 values), which moves a few silhouette
subpixels, and a moved edge pixel moves a walk term of size diff / eps
(eps 1e-4) by 10-30% of the largest gradient."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data.synthetic import make_derender_batch, make_sphere_mesh
from sdn3d_tpu.geometry.assets import build_mesh_bank
from sdn3d_tpu.models import derenderer as JD
from sdn3d_tpu.pipelines import derender as JP
from sdn3d_tpu_torch.data import synthetic as TS
from sdn3d_tpu_torch.geometry.assets import build_mesh_bank as t_build_bank
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.models.layers import BatchNorm2d
from sdn3d_tpu_torch.pipelines import derender as TP
from sdn3d_tpu_torch.utils.port import (derender_train_state_from_jax,
                                        derenderer_state_dict_from_jax)

IMAGE = RENDER = 32
MODES = ("pretrain", "full", "finetune", "extend")
HEAD_KEYS = ("_theta_deltas", "_translation2ds", "_log_scales",
             "_log_depths", "_class_probs", "_ffd_coeffs")


def small_batch():
    """The JAX tests' batch (tests/test_derender_pipeline.py)."""
    b = make_derender_batch(4, IMAGE)
    b["masks"] = np.zeros((4, 1, RENDER, RENDER), np.float32)
    b["masks"][:, :, 8:24, 8:24] = 1.0
    b["ignores"] = np.zeros_like(b["masks"])
    return b


def t_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def setup():
    meshes = [make_sphere_mesh(4, 8)] * 3
    j_bank = JD.DeviceMeshBank.from_host(build_mesh_bank(meshes))
    t_bank = TD.DeviceMeshBank.from_host(t_build_bank(meshes), device="cpu")
    batch = small_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_model = JD.Derenderer(num_classes=3)
    trainer = JP.DerenderTrainer(model=j_model, bank=j_bank,
                                 mode=JD.TargetType.extend,
                                 image_size=IMAGE, render_size=RENDER)
    state = jax.tree_util.tree_map(
        np.asarray, trainer.init(jax.random.PRNGKey(0), jb))
    return dict(j_bank=j_bank, t_bank=t_bank, batch=batch, jb=jb,
                j_model=j_model, state=state,
                fields=derender_train_state_from_jax(state))


def t_trainer(setup, mode: str, **kw):
    model = TD.Derenderer(num_classes=3)
    trainer = TP.DerenderTrainer(model=model, bank=setup["t_bank"],
                                 mode=JD.TargetType.BY_NAME[mode],
                                 image_size=IMAGE, render_size=RENDER, **kw)
    return trainer, TP.TrainState.from_fields(setup["fields"], model)


def given_draws(idx: np.ndarray):
    """A select_class that returns the given classes (JAX's draws) and
    their log-probabilities under the port's class_probs."""
    def select(class_probs, generator=None, sample=False):
        i = torch.from_numpy(np.array(idx)).long()
        logp = torch.log(torch.gather(class_probs, 1, i[:, None])[:, 0]
                         + 1e-20)
        return i.to(torch.int32), logp
    return select


def roi_feats(roi_norms):
    return TD.roi_features(torch.from_numpy(roi_norms))


@pytest.fixture(scope="module")
def jax_encoder(setup):
    """JAX's train-mode encoder at the batch: (outputs, new batch_stats,
    fc1 / fc2 pre-activations, a jitted VJP of the outputs in the
    params)."""
    s, b = setup["state"], setup["batch"]
    mroi, droi = (jnp.asarray(x.numpy()) for x in roi_feats(b["roi_norms"]))
    images = jnp.asarray(b["images"])

    def enc(params):
        out, upd = setup["j_model"].apply(
            {"params": params, "batch_stats": s.batch_stats}, images, mroi,
            droi, train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: m.name in ("fc1", "fc2"))
        return out, upd

    out, upd = jax.jit(enc)(s.params)
    inter = {k: np.asarray(upd["intermediates"][k]["__call__"][0])
             for k in ("fc1", "fc2")}
    vjp = jax.jit(lambda p, cot: jax.vjp(lambda q: enc(q)[0], p)[1](cot)[0])
    return (jax.tree_util.tree_map(np.asarray, out),
            jax.tree_util.tree_map(np.asarray, upd["batch_stats"]), inter,
            vjp)


_HEAD_CACHE = {}


def jax_head(setup, jax_encoder, mode: str):
    """JAX's losses and the loss's gradient in the encoder outputs at its
    own outputs, and its class draws for PRNGKey(1) (cached by mode)."""
    if mode in _HEAD_CACHE:
        return _HEAD_CACHE[mode]
    enc, _, _, _ = jax_encoder
    m = JD.TargetType.BY_NAME[mode]
    trainer = JP.DerenderTrainer(model=setup["j_model"], bank=setup["j_bank"],
                                 mode=m, image_size=IMAGE, render_size=RENDER)
    jb, key = setup["jb"], jax.random.PRNGKey(1)

    def total(e):
        rn = jb["roi_norms"]
        blob = {"_roi_norms": rn, "_focals": jb["focals"],
                "_mroi_norms": jnp.stack([rn[:, 2] + rn[:, 0],
                                          rn[:, 3] + rn[:, 1]], 1) / 2.0,
                "_droi_norms": jnp.stack([rn[:, 2] - rn[:, 0],
                                          rn[:, 3] - rn[:, 1]], 1)}
        blob.update(e)
        if m & JD.TargetType.reproject:
            blob.update(JD.render_blob(blob, setup["j_bank"], m, IMAGE,
                                       RENDER, True, key))
        losses = trainer.losses(blob, jb)
        return sum(losses.values()), losses

    g, losses = jax.jit(jax.grad(total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in enc.items()})
    draws = np.asarray(JD.select_class(jnp.asarray(enc["_class_probs"]), key,
                                       True)[0])
    _HEAD_CACHE[mode] = (jax.tree_util.tree_map(np.asarray, g),
                         {k: float(v) for k, v in losses.items()}, draws)
    return _HEAD_CACHE[mode]


def close(got: np.ndarray, want: np.ndarray, frac: float, what: str,
          min_cos: float = 0.999) -> None:
    """Within `frac` of want's largest entry, and pointing the same way."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=what)
    if np.abs(want).max() > 0:
        cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
        assert cos >= min_cos, (what, cos)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_losses_and_batch_stats_match_jax(setup, jax_encoder,
                                                     monkeypatch, mode):
    """One port train step from the converted state, JAX's class draws
    given: the loss dict has JAX's keys and values (geometry losses within
    2e-5 relative, measured <= 1e-5: the encoders' outputs differ by
    ~1e-5; the reprojection losses within 5e-4, measured <= 1.2e-4: a
    few antialiasing subpixels move), and the new BatchNorm running
    statistics are JAX's (flax's biased-variance update) within 5e-5 of
    each tensor's largest value (measured 8.8e-6).  The step moved every
    parameter's Adam state off zero."""
    _, bs_j, _, _ = jax_encoder
    _, losses_j, draws = jax_head(setup, jax_encoder, mode)
    monkeypatch.setattr(TD, "select_class", given_draws(draws))
    trainer, state = t_trainer(setup, mode)
    state, losses = trainer.train_step(state, t_batch(setup["batch"]))
    assert sorted(losses) == sorted(losses_j)
    for k, v in losses_j.items():
        rtol = 5e-4 if k in ("mask_loss", "class_reward") else 2e-5
        np.testing.assert_allclose(float(losses[k]), v, rtol=rtol, err_msg=k)
    want = derenderer_state_dict_from_jax(
        {"params": setup["state"].params, "batch_stats": bs_j})
    sd = state.model.state_dict()
    stats = [n for n in sd if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 40
    for n in stats:
        w = want[n].numpy()
        assert np.abs(w - setup["fields"]["derenderer"][n].numpy()).max() > 0
        np.testing.assert_allclose(sd[n].numpy(), w, rtol=0,
                                   atol=5e-5 * np.abs(w).max(), err_msg=n)
    assert state.step == 1 and state.count == 1
    assert (state.nu > 0).float().mean() > 0.5


@pytest.mark.parametrize("mode", MODES)
def test_loss_gradients_in_the_encoder_outputs_match_jax(
        setup, jax_encoder, monkeypatch, mode):
    """The loss's gradient in the encoder's outputs, both packages at
    JAX's outputs with JAX's draws: the render, the losses and REINFORCE's
    class_reward.  Each output's gradient within 3% of its largest entry
    and cosine >= 0.999 (measured <= 1.2e-3; tests/test_torch_refine.py's
    bound for the silhouette gradient: the deformed vertices differ from
    XLA's in the last ulp, which can move a walk gate); outputs no loss
    reads get zero on both sides."""
    enc, _, _, _ = jax_encoder
    g_j, losses_j, draws = jax_head(setup, jax_encoder, mode)
    monkeypatch.setattr(TD, "select_class", given_draws(draws))
    trainer, _ = t_trainer(setup, mode)
    b = t_batch(setup["batch"])
    mroi, droi = roi_feats(setup["batch"]["roi_norms"])
    e = {k: torch.from_numpy(enc[k].copy()).requires_grad_(True)
         for k in HEAD_KEYS}
    blob = {"_roi_norms": b["roi_norms"], "_mroi_norms": mroi,
            "_droi_norms": droi, "_focals": b["focals"], **e}
    if trainer.mode & TD.TargetType.reproject:
        blob.update(TD.render_blob(blob, trainer.bank, trainer.mode, IMAGE,
                                   RENDER, training=True))
    losses = trainer.losses(blob, b)
    g = torch.autograd.grad(sum(losses.values()), [e[k] for k in HEAD_KEYS],
                            allow_unused=True)
    for k, gt in zip(HEAD_KEYS, g):
        got = np.zeros_like(g_j[k]) if gt is None else gt.numpy()
        close(got, g_j[k], 0.03, k)
    for k, v in losses_j.items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_encoder_gradients_match_jax(setup, jax_encoder, mode):
    """The encoder's backward of JAX's cotangent (the loss's gradient in
    the encoder outputs, per mode) against JAX's VJP: every parameter's
    gradient within 2e-3 of its largest entry (measured <= 4.2e-4, in
    layer 4, whose batch statistics are over 4 x 1 x 1 values), cosine
    >= 0.9999.  Where a
    fc1 / fc2 pre-activation lies closer to zero than the two forwards
    differ (measured: 1 of 1024, 8.7e-6 against -4.4e-6 in JAX, the
    forwards 9e-5 apart), the ReLU takes the other branch, and that
    unit's gradient flips; the test moves such entries onto JAX's side of
    the kink (a constant offset, no gradient) and asserts they are few
    and that small."""
    enc, _, inter, vjp = jax_encoder
    g_enc, _, _ = jax_head(setup, jax_encoder, mode)
    g_params = jax.tree_util.tree_map(np.asarray, vjp(
        jax.tree_util.tree_map(jnp.asarray, setup["state"].params),
        {k: jnp.asarray(v) for k, v in g_enc.items()}))
    want = derenderer_state_dict_from_jax(
        {"params": g_params, "batch_stats": setup["state"].batch_stats})
    _, state = t_trainer(setup, mode)
    model = state.model.train()
    flips = []

    def align(name):
        def hook(_, __, out):
            ref = torch.from_numpy(np.array(inter[name]))
            band = float((out - ref).abs().max())
            flip = (out > 0) != (ref > 0)
            flips.append((name, int(flip.sum()), band,
                          float(out[flip].abs().max()) if flip.any() else 0.0))
            return out + torch.where(flip, ref - out, 0.0).detach()
        return hook

    for name in ("fc1", "fc2"):
        getattr(model, name).register_forward_hook(align(name))
    mroi, droi = roi_feats(setup["batch"]["roi_norms"])
    out = model(torch.from_numpy(setup["batch"]["images"]), mroi, droi)
    params = list(model.named_parameters())
    grads = torch.autograd.grad(
        [out[k] for k in HEAD_KEYS], [p for _, p in params],
        [torch.from_numpy(np.array(g_enc[k])) for k in HEAD_KEYS])
    for name, n, band, worst in flips:
        assert n <= 2 and worst <= band <= 2e-4, flips
    for (n, _), g in zip(params, grads):
        close(g.numpy(), want[n].numpy(), 2e-3, n, min_cos=0.9999)


def test_optimizer_matches_optax_across_a_staircase_step(setup):
    """The optimizer alone: the same gradients (random, spanning six
    decades, one parameter's exactly zero) given to optax's chain and to
    the port's apply_gradients for 3 steps with lr_decay_steps 2, so step
    3 runs at the decayed rate.  Parameters within 2 ulp of JAX's after
    each step, the moments too (XLA's CPU backend may fuse the moment
    updates into FMAs); the schedule read before the increment."""
    j_trainer = JP.DerenderTrainer(model=setup["j_model"], bank=None,
                                   mode=JD.TargetType.full, lr=3e-3,
                                   lr_decay_steps=2)
    trainer, state = t_trainer(setup, "full", lr=3e-3, lr_decay_steps=2)
    assert [trainer.learning_rate(c) for c in range(4)] == [
        float(np.float32(3e-3))] * 2 + [float(np.float32(3e-3) / 2)] * 2
    params = jax.tree_util.tree_map(jnp.asarray, setup["state"].params)
    opt = j_trainer.tx.init(params)
    rng = np.random.RandomState(5)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    names = [n for n, _ in state.model.named_parameters()]
    for step in range(3):
        g_leaves = [(rng.normal(0, 10.0 ** -rng.randint(0, 6), x.shape)
                     * (i != 3)).astype(np.float32)
                    for i, x in enumerate(leaves)]
        grads = jax.tree_util.tree_unflatten(treedef, g_leaves)
        upd, opt = j_trainer.tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        g_sd = derenderer_state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, grads),
             "batch_stats": setup["state"].batch_stats})
        trainer.apply_gradients(state, [g_sd[n] for n in names])
        p_sd = derenderer_state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, params),
             "batch_stats": setup["state"].batch_stats})
        sd = state.model.state_dict()
        for n in names:
            w = p_sd[n].numpy()
            np.testing.assert_allclose(sd[n].numpy(), w, rtol=0,
                                       atol=2 * np.spacing(np.abs(w)).max(),
                                       err_msg=(step, n))
        adam = opt[1]
        mu, nu = state.moments()
        for k, mine in (("mu", mu), ("nu", nu)):
            ref = derenderer_state_dict_from_jax(
                {"params": jax.tree_util.tree_map(np.asarray,
                                                  getattr(adam, k)),
                 "batch_stats": setup["state"].batch_stats})
            for n in names:
                w = ref[n].numpy()
                np.testing.assert_allclose(
                    mine[n].numpy(), w, rtol=0,
                    atol=2 * np.spacing(np.abs(w)).max(),
                    err_msg=(step, k, n))
        assert state.count == int(adam.count) == step + 1


def test_sampler_draws_class_probs():
    """The port's REINFORCE draw, 60,000 rows of one seeded generator:
    class frequencies against class_probs by a chi-square test (2 degrees
    of freedom, statistic below 13.8, p = 0.001), log_prob = log(p[idx] +
    1e-20) with its gradient in the probabilities, the same generator seed
    gives the same draws, and sample=False is the argmax."""
    p = torch.tensor([[0.15, 0.6, 0.25]]).repeat(60_000, 1)
    g = torch.Generator().manual_seed(11)
    idx, logp = TD.select_class(p, g, sample=True)
    counts = np.bincount(idx.numpy(), minlength=3)
    expected = 60_000 * p[0].numpy()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 13.8, (counts, chi2)
    np.testing.assert_array_equal(
        logp.numpy(), np.log(p[0].numpy()[idx.numpy()] + np.float32(1e-20)))
    again, _ = TD.select_class(p, torch.Generator().manual_seed(11), True)
    assert torch.equal(again, idx) and idx.dtype == torch.int32
    q = torch.tensor([[0.2, 0.3, 0.5], [0.7, 0.2, 0.1]], requires_grad=True)
    i, lp = TD.select_class(q, torch.Generator().manual_seed(0), True)
    (gq,) = torch.autograd.grad(lp.sum(), q)
    want = np.zeros((2, 3), np.float32)
    want[[0, 1], i.numpy()] = 1 / (q.detach().numpy()[[0, 1], i.numpy()]
                                   + 1e-20)
    np.testing.assert_allclose(gq.numpy(), want, rtol=1e-6)
    assert TD.select_class(q)[0].tolist() == [2, 0]
    with pytest.raises(ValueError):
        TD.select_class(q, None, True)


def test_batchnorm_train_mode_is_flax(setup):
    """models/layers.BatchNorm2d in train mode against flax's nn.BatchNorm
    (momentum 0.9, eps 1e-5) on one random [6, 5, 3, 4] input: outputs
    and new running statistics within 2e-6; the running variance moved by
    the biased variance, which torch's own rule (the unbiased one) misses
    by n/(n-1) = 72/71; eval mode unchanged (torch's batch_norm)."""
    import flax.linen as nn

    rng = np.random.RandomState(3)
    x = (rng.randn(6, 5, 3, 4) * 2 + 0.5).astype(np.float32)
    bn = BatchNorm2d(5, eps=1e-5)
    with torch.no_grad():
        for t, v in ((bn.weight, rng.uniform(0.5, 1.5, 5)),
                     (bn.bias, rng.normal(0, 0.2, 5)),
                     (bn.running_mean, rng.normal(0, 1, 5)),
                     (bn.running_var, rng.uniform(0.5, 2, 5))):
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": bn.weight.detach().numpy(),
                            "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": bn.running_mean.numpy().copy(),
                                 "var": bn.running_var.numpy().copy()}}
    y_j, upd = flax_bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                             mutable=["batch_stats"])
    torch_rule = torch.nn.BatchNorm2d(5, eps=1e-5).train()
    torch_rule.load_state_dict(bn.state_dict())
    torch_rule(torch.from_numpy(x))
    y = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_j), rtol=0, atol=2e-6)
    for mine, k in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(mine.numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=0, atol=2e-6)
    var = x.transpose(1, 0, 2, 3).reshape(5, -1).var(1)
    assert np.abs(torch_rule.running_var.numpy() - bn.running_var.numpy()
                  - 0.1 * var / 71).max() < 1e-5
    bn.eval()
    with torch.no_grad():
        want = torch.nn.functional.batch_norm(
            torch.from_numpy(x), bn.running_mean, bn.running_var, bn.weight,
            bn.bias, False, 0.0, 1e-5)
    assert torch.equal(bn(torch.from_numpy(x)), want)


def test_eval_step_matches_jax(setup):
    """eval_step (running statistics, inference camera, argmax class,
    one render_targets rasterization) against JAX's, extend mode: losses
    within 1e-4 relative (the encoder outputs differ by ~1e-6 in eval
    mode, and the losses' mean over the mask pixels)."""
    j_trainer = JP.DerenderTrainer(model=setup["j_model"],
                                   bank=setup["j_bank"],
                                   mode=JD.TargetType.extend,
                                   image_size=IMAGE, render_size=RENDER)
    want = jax.jit(j_trainer.make_eval_step())(
        jax.tree_util.tree_map(jnp.asarray, setup["state"]), setup["jb"])
    trainer, state = t_trainer(setup, "extend")
    got = trainer.make_eval_step()(state, t_batch(setup["batch"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert not state.model.training


def test_train_state_fields_round_trip(setup, tmp_path):
    """TrainState.fields through core/checkpoint and back: the same
    weights, running statistics, moments, count and step; the converted
    JAX state's moments are the optimizer's (zeros at init) and its
    step 0."""
    from sdn3d_tpu_torch.core.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)

    trainer, state = t_trainer(setup, "full")
    assert state.step == 0 and state.count == 0
    assert float(state.mu.abs().max()) == 0.0
    state.mu += 0.25
    state.nu += 0.5
    state.count, state.step = 7, 9
    save_checkpoint(str(tmp_path), 9, state.fields())
    fields, step = restore_checkpoint(str(tmp_path))
    assert step == 9
    back = TP.TrainState.from_fields(fields, TD.Derenderer(num_classes=3))
    assert (back.step, back.count) == (9, 7)
    assert torch.equal(back.mu, state.mu) and torch.equal(back.nu, state.nu)
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_synthetic_batches_match_jax():
    """data/synthetic.make_derender_batch draw for draw, and the CLI's
    centred-square masks (JAX cli/geometric_train.py:98-108)."""
    for seed in (0, 3):
        got, want = TS.make_derender_batch(5, 24, seed), \
            make_derender_batch(5, 24, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    for r in (32, 38):
        m = TS.centred_square_masks(2, r)
        want = np.zeros((2, 1, r, r), np.float32)
        want[:, :, r // 4:-r // 4, r // 4:-r // 4] = 1.0
        np.testing.assert_array_equal(m["masks"], want)
        assert not m["ignores"].any() and m["ignores"].shape == want.shape


def test_extend_step_skips_the_unused_renders(setup):
    """The extend mode's normal and depth maps, which no loss reads: the
    trainer's step does not render them (JAX's jit drops them), so it
    rasterizes once, for the silhouettes; render_blob called directly
    returns them, differentiable."""
    from sdn3d_tpu_torch.ops import rasterize as TR

    b = t_batch(setup["batch"])
    trainer, state = t_trainer(setup, "extend")
    calls = TR.rasterize_face_maps.calls
    state, losses = trainer.train_step(state, b,
                                       torch.Generator().manual_seed(4))
    assert TR.rasterize_face_maps.calls == calls + 1
    assert "mask_loss" in losses and "depth_loss" in losses
    blob = TD.derender_forward(state.model, b["images"], b["roi_norms"],
                               b["focals"], trainer.bank,
                               TD.TargetType.extend, IMAGE, RENDER,
                               training=True,
                               generator=torch.Generator().manual_seed(4))
    assert TR.rasterize_face_maps.calls == calls + 4
    assert blob["_normals"].shape == (4, 3, RENDER, RENDER)
    assert blob["_depth_maps"].shape == (4, 1, RENDER, RENDER)
    assert blob["_normals"].requires_grad and blob["_depth_maps"].requires_grad


def test_descends_over_20_steps(setup):
    """full-mode training with REINFORCE sampling active descends, as
    tests/test_training_descends.py:151-186 holds JAX's: 20 steps of lr
    3e-3, mask_weight 1.0 from the converted state on one fixed batch
    (each step's draws from its own seeded generator); the mask loss's
    last 4 steps below 0.85 of its first 4 or, anchored on the peak, below
    0.75 of it; every loss finite."""
    trainer, state = t_trainer(setup, "full", lr=3e-3, mask_weight=1.0)
    b = t_batch(setup["batch"])
    mask = []
    for i in range(20):
        state, losses = trainer.train_step(
            state, b, torch.Generator().manual_seed(i))
        assert all(np.isfinite(float(v)) for v in losses.values()), losses
        mask.append(float(losses["mask_loss"]))
    first, last = np.mean(mask[:4]), np.mean(mask[-4:])
    assert last < 0.85 * first or last < 0.75 * max(mask), mask


def test_cli_writes_a_step_that_geometric_main_serves(tmp_path):
    """cli/geometric_train --synthetic --mode full, 2 iterations at batch
    2 and 32^2 on the CPU: a step-2 directory (derenderer, opt_state,
    step; the arguments in the manifest), finite printed losses; then
    cli/geometric_main --ckpt_dir serves a frame from it (the five-file
    contract), and the served model's weights are the trained ones.
    Without --device the CLI asks for the card and raises here."""
    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main, geometric_train
    from sdn3d_tpu_torch.core.checkpoint import load_meta, restore_variables
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    ck = str(tmp_path / "ck")
    args = ["--synthetic", "--mode", "full", "--num_iters", "2",
            "--batch_size", "2", "--image_size", "32", "--render_size", "32",
            "--ckpt_dir", ck]
    state = geometric_train.main(args + ["--device", "cpu"])
    assert sorted(os.listdir(os.path.join(ck, "step-2"))) == [
        "derenderer.pt", "opt_state.pt", "step.pt"]
    meta = load_meta(ck)
    assert meta["step"] == 2 and meta["meta"]["mode"] == "full"
    assert state.step == 2 and state.count == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            geometric_train.main(args)

    v, f = make_sphere_mesh(3, 6)
    for cls, obj in SHAPENET_CARS:
        d = tmp_path / "shapenet" / cls / obj / "models"
        d.mkdir(parents=True)
        save_obj(str(d / "model_normalized.obj"), v, f)
    rng = np.random.RandomState(0)
    Image.fromarray((rng.rand(96, 160, 3) * 255).astype(np.uint8)).save(
        tmp_path / "frame.png")
    rois = np.asarray([[20, 30, 60, 80], [40, 90, 85, 150]], np.float32)
    masks = np.zeros((2, 1, 96, 160), np.float32)
    for i, r in enumerate(rois.astype(int)):
        masks[i, 0, r[0] + 5:r[2] - 5, r[1] + 5:r[3] - 5] = 1
    np.savez(tmp_path / "gt.npz", rois=rois, masks=masks,
             class_ids=np.asarray([1, 2]))
    geometric_main.main([
        "--source", "gt", "--input_image", str(tmp_path / "frame.png"),
        "--input_masks", str(tmp_path / "gt.npz"), "--shapenet_root",
        str(tmp_path / "shapenet"), "--ckpt_dir", ck, "--image_size", "32",
        "--render_size", "32", "--device", "cpu", "--output_dir",
        str(tmp_path / "out")])
    for suffix in (".png", "-normal.png", "-depth.png", ".json", ".pkl"):
        assert os.path.exists(tmp_path / "out" / ("frame" + suffix))
    with open(tmp_path / "out" / "frame.json") as fh:
        assert len(json.load(fh)) == 2
    served, _ = geometric_main.load_derenderer(dataclasses.make_dataclass(
        "A", ["ckpt_dir", "shapenet_root", "device"])(
            ck, str(tmp_path / "shapenet"), "cpu"))
    trained = restore_variables(ck, ["derenderer"])[0]["derenderer"]
    for k, v in served.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_bfloat16_train_step(setup):
    """A train step with the trunk computing in bfloat16 against the JAX
    package's Derenderer(dtype=bfloat16) (flax's casts) from the same
    state, pretrain mode: the geometry losses within 10% (measured 2.6%).
    Why so coarse: in train mode at 4 x 32^2 the layer-4 batch statistics
    are over 4 values each and amplify the bfloat16 roundings that go the
    other way (one in 5,000-10,000 where the two packages sum in other
    orders, tests/test_torch_bf16.py): the two packages' bfloat16 heads
    differ by up to 0.135, and JAX's own bfloat16 heads differ from its
    float32 heads by up to 0.173 here.  Then a full-mode step: finite
    float32 losses, float32 gradients, running statistics and moments."""
    b = t_batch(setup["batch"])
    j_model = JD.Derenderer(num_classes=3, dtype=jnp.bfloat16)
    j_trainer = JP.DerenderTrainer(model=j_model, bank=None,
                                   mode=JD.TargetType.pretrain,
                                   image_size=IMAGE, render_size=RENDER)
    s, jb = setup["state"], setup["jb"]
    blob = JD.derender_forward(
        {"params": s.params, "batch_stats": s.batch_stats}, j_model,
        jb["images"], jb["roi_norms"], jb["focals"], None,
        JD.TargetType.pretrain, IMAGE, RENDER, training=True,
        mutable=["batch_stats"])
    want = {k: float(v) for k, v in j_trainer.losses(blob, jb).items()}
    for mode in ("pretrain", "full"):
        model = TD.Derenderer(num_classes=3, dtype="bfloat16")
        trainer = TP.DerenderTrainer(model=model, bank=setup["t_bank"],
                                     mode=TD.TargetType.BY_NAME[mode],
                                     image_size=IMAGE, render_size=RENDER)
        state = TP.TrainState.from_fields(setup["fields"], model)
        state, losses = trainer.train_step(
            state, b, torch.Generator().manual_seed(2))
        for k, v in losses.items():
            assert torch.isfinite(v) and v.dtype == torch.float32, k
        if mode == "pretrain":
            assert sorted(losses) == sorted(want)
            for k, v in want.items():
                np.testing.assert_allclose(float(losses[k]), v, rtol=0.1,
                                           err_msg=k)
    assert state.mu.dtype == torch.float32 and state.nu.max() > 0
    assert all(v.dtype == torch.float32 for k, v in
               state.model.state_dict().items()
               if k.endswith(("running_mean", "running_var", "weight")))


def test_train_step_spans(setup):
    """One step records `train.step` (id: Adam's count before the step)
    over `train.forward`, `train.backward` and `train.optimizer` (the sums
    over the ranks, then Adam and the copy back), in that order, each
    inside the step."""
    from torch.profiler import ProfilerActivity, profile

    from sdn3d_tpu_torch.utils import phases

    trainer, state = t_trainer(setup, "full")
    count = state.count
    phases.profiled()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(state, t_batch(setup["batch"]),
                           torch.Generator().manual_seed(4))
    spans = phases.profiled()["spans"]
    assert [s.name for s in spans] == [
        "train.forward", "train.backward", "train.optimizer",
        "train.optimizer", "train.step"]
    step = spans[-1]
    assert (step.parent, step.rid) == (0, count)
    for s in spans[:4]:
        assert (s.parent, s.rid) == (step.sid, count)
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    for a, b in zip(spans[:3], spans[1:4]):
        assert a.end_ns <= b.start_ns

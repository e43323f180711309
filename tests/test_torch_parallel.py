"""The port's data parallelism (sdn3d_tpu_torch.parallel, the synchronised
BatchNorm of models/layers, the trainers' losses as each rank's part of
the global batch's, and geometric_train / semantic_train under torchrun)
on the CPU, in 2-rank gloo groups of subprocesses
(tests/torch_ddp_worker.py, one torch thread each, a FileStore under the
test's tmp_path).

World size 2 is held against world size 1 (no group) on the same global
batch in float64, where train-mode BatchNorm's rounding stays far below
the bound, so that a mean of per-rank means or a per-rank draw (O(1e-2)
off) shows; and, in float32, against JAX's step on a 2-device mesh of the
conftest's CPU devices, in the two halves that
tests/test_torch_derender_train.py and tests/test_torch_semantic_train.py
compare, with their bounds."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_ddp_worker as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_derender_train import close
from tests.test_torch_semantic_train import (
    DEC_GRAD_RTOL, GRAD_RTOL, JAX_ENC_BOUNDS, LOSS_RTOL, STATS_RTOL,
    _against, _dropout_filter, _dropout_masks, _grad_names)
from sdn3d_tpu.data.synthetic import make_derender_batch, make_sphere_mesh
from sdn3d_tpu.geometry.assets import build_mesh_bank
from sdn3d_tpu.models import derenderer as JD
from sdn3d_tpu.models import semantic as JS
from sdn3d_tpu.models.resnet import Bottleneck, ResNet
from sdn3d_tpu.parallel import make_mesh, shard_batch
from sdn3d_tpu.pipelines import derender as JP
from sdn3d_tpu.pipelines import semantic as JSP
from sdn3d_tpu_torch import parallel
from sdn3d_tpu_torch.core.checkpoint import restore_checkpoint
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.pipelines import derender as TP
from sdn3d_tpu_torch.utils.port import (derender_train_state_from_jax,
                                        derenderer_state_dict_from_jax,
                                        semantic_state_dicts_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 32                       # derenderer image = render size
B_DER, B_SEM, S, C = 4, 2, 32, 14
# World size 2 against world size 1 in float64: every tensor (losses,
# gradients, i.e. Adam's moments after one step, SGD parameters and
# traces, running statistics) within F64_RTOL of its largest entry.  The
# derenderer's parameters after Adam within F64_ADAM_ATOL: Adam's first
# step is lr * g / (|g| + 1e-8), which turns a difference of 1e-13 of the
# largest gradient entry (measured 1.9e-13) in an element whose gradient
# is near 1e-8 into up to ~1e-6 lr (measured 1.7e-11 = 1.7e-8 lr).
F64_RTOL = 1e-10
F64_ADAM_ATOL = 1e-6 * 1e-3
# The CLI run in float32, world size 2 against no group (one step of
# --mode pretrain): the running statistics and Adam's moments (the
# gradient) within CLI_RTOL of their largest entries; the parameters are
# Adam's step of those moments, within 4 ulp and 1e-4 lr (the float32
# arithmetic of Adam against a float64 one, where a gradient is near
# Adam's eps: measured 1.4e-5 lr).  (Adam's first step is
# lr * g / (|g| + 1e-8), so where the gradient is rounding noise, a bias
# that BatchNorm follows, the rounding of the gradient moves a parameter
# by up to 2 lr.)  The rendering modes are held in float64 above: in
# float32 the two runs' encoders differ in the last bits (BatchNorm's sums
# in another order), which moves silhouette subpixels, and the walk
# turns a moved edge pixel into 1e-2 of a gradient (measured in --mode
# full: conv1's moment 1.2e-2 of its largest entry off; the same happens
# between JAX and the port, tests/test_torch_derender_train.py).  Measured
# in pretrain: 1.1e-4 (bn1.bias's second moment; train-mode BatchNorm
# over 2 x 1 x 1 values a channel in layer 4 on each rank).
CLI_RTOL, CLI_STEPS, CLI_LR = 5e-4, 1, 1e-3
# The gradients in C4, C5 of JAX's float32 on the mesh and of the port at
# world size 2 against float64, relative to their largest entry
# (measured JAX 1.4e-3, the port 4.4e-4).
CONV_RTOL = 2e-3
# The semantic step's halves in float32, JAX's on the 2-device mesh and
# the port's at world size 2, each against a float64 run of the port at
# world size 1 from the same inputs, at fixed bounds (worst parameter
# relative to the larger of its scale and 1e-2 of the half's largest,
# cosine of the half, lowest parameter cosine; tests/test_torch_semantic_
# train's measure).  The decoder: DEC_GRAD_RTOL, the float32 rounding
# bound of that file; JAX's sharded program rounds further from float64
# than its one-device one (measured JAX 3.0e-3, 1 - 6.1e-6, 1 - 2.5e-7;
# the port 1.2e-3, 1 - 6.2e-7, 1 - 2.4e-8).  The encoder: that file's
# JAX_ENC_BOUNDS, train-mode BatchNorm over 2 x 4 x 4 values a channel
# (measured JAX 0.099, 0.99895, 0.99941; the port 0.132, 0.99875,
# 0.99907).
MESH_DEC_BOUNDS = (DEC_GRAD_RTOL, 1 - 1e-5, 0.99999)
# The REINFORCE class targets per sample: each rank of two selects a
# different number of samples for each loss family.
TARGETS = np.array([1, 3, 2, 2], np.int32)


def run_group(tmp_path, jobs, world=2, timeout=300):
    """The worker's results of `jobs` on each rank of a `world`-rank gloo
    group."""
    spec = tmp_path / "spec.pt"
    torch.save(W.pack(jobs), spec)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    outs = [tmp_path / f"out{r}.pt" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_ddp_worker", str(spec), str(r),
         str(world), str(tmp_path / "store"), str(outs[r])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results = [W.unpack(torch.load(o, weights_only=False)) for o in outs]
    for f in [spec] + outs:              # ~1 GB at the semantic model's size
        f.unlink()
    return results


def derender_batch():
    b = make_derender_batch(B_DER, IMAGE)
    b["masks"] = np.zeros((B_DER, 1, IMAGE, IMAGE), np.float32)
    b["masks"][:, :, 8:24, 8:24] = 1.0
    b["ignores"] = np.zeros_like(b["masks"])
    b["targets"] = TARGETS.copy()
    return b


def jax_derender_reference(batch):
    """JAX's step on a 2-device mesh in the two halves: the init state,
    the train-mode encoder's outputs, new statistics, fc1 / fc2
    pre-activations and VJP of the loss's cotangent, the losses, and the
    class draws of PRNGKey(1)."""
    mesh = make_mesh(2)
    meshes = [make_sphere_mesh(4, 8)] * 3
    bank = JD.DeviceMeshBank.from_host(build_mesh_bank(meshes))
    model = JD.Derenderer(num_classes=3)
    trainer = JP.DerenderTrainer(model=model, bank=bank,
                                 mode=JD.TargetType.full, image_size=IMAGE,
                                 render_size=IMAGE)
    jb = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    state = jax.tree_util.tree_map(
        np.asarray, trainer.init(jax.random.PRNGKey(0), jb))
    rn = jb["roi_norms"]
    mroi = jnp.stack([rn[:, 2] + rn[:, 0], rn[:, 3] + rn[:, 1]], 1) / 2.0
    droi = jnp.stack([rn[:, 2] - rn[:, 0], rn[:, 3] - rn[:, 1]], 1)

    def enc(params, images, mroi, droi):
        return model.apply(
            {"params": params, "batch_stats": state.batch_stats}, images,
            mroi, droi, train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: m.name in ("fc1", "fc2"))

    out, upd = jax.jit(enc)(state.params, jb["images"], mroi, droi)
    key = jax.random.PRNGKey(1)

    def total(e, b):
        blob = {"_roi_norms": b["roi_norms"], "_focals": b["focals"],
                "_mroi_norms": mroi, "_droi_norms": droi}
        blob.update(e)
        blob.update(JD.render_blob(blob, bank, JD.TargetType.full, IMAGE,
                                   IMAGE, True, key))
        losses = trainer.losses(blob, b)
        return sum(losses.values()), losses

    g, losses = jax.jit(jax.grad(total, has_aux=True))(dict(out), jb)
    vjp = jax.jit(lambda p, cot: jax.vjp(
        lambda q: enc(q, jb["images"], mroi, droi)[0], p)[1](cot)[0])
    g_params = vjp(state.params, g)
    draws = JD.select_class(out["_class_probs"], key, True)[0]
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        state=state, enc=np_(dict(out)), g=np_(g), g_params=np_(g_params),
        stats=np_(upd["batch_stats"]), draws=np.asarray(draws),
        inter={k: np.asarray(upd["intermediates"][k]["__call__"][0])
               for k in ("fc1", "fc2")},
        losses={k: float(v) for k, v in losses.items()})


def jax_semantic_reference(images, labels):
    """JAX's semantic step on a 2-device mesh in its two halves (as the
    `ref` fixture of tests/test_torch_semantic_train.py, the batch
    sharded)."""
    mesh = make_mesh(2)
    jm = JS.SemanticModel(num_class=C)
    trainer = JSP.SemanticTrainer(jm)
    state = jax.tree_util.tree_map(np.asarray, jax.jit(trainer.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))))
    P, St = state.params, state.batch_stats
    enc_mod = ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                     output_stride=8, deep_stem=True)
    dec_mod = JS.PPMDeepsup(num_class=C)

    def enc_apply(p, x):
        feats, new = enc_mod.apply({"params": p, "batch_stats": St["encoder"]},
                                   x, train=True, mutable=["batch_stats"])
        return feats[1:], new["batch_stats"]

    def dec_loss(p, conv_out, y, rng):
        (log_p, log_d), new = dec_mod.apply(
            {"params": p, "batch_stats": St["decoder"]}, conv_out,
            train=True, rngs={"dropout": rng},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=_dropout_filter)
        total = JS.segmentation_loss(log_p, y) \
            + trainer.deep_sup_scale * JS.segmentation_loss(log_d, y)
        return total, (JS.pixel_accuracy(log_p, y), new)

    @jax.jit
    def reference(P, x, y, rng):
        conv_out, vjp, enc_stats = jax.vjp(lambda p: enc_apply(p, x),
                                           P["encoder"], has_aux=True)
        (total, aux), (g_dec, g_conv) = jax.value_and_grad(
            dec_loss, argnums=(0, 1), has_aux=True)(P["decoder"], conv_out,
                                                    y, rng)
        (g_enc,) = vjp(g_conv)
        return dict(conv_out=conv_out, enc_stats=enc_stats, total=total,
                    acc=aux[0], dec_stats=aux[1]["batch_stats"],
                    masks=aux[1]["intermediates"], g_dec=g_dec,
                    g_conv=g_conv, g_enc=g_enc)

    b = shard_batch({"x": jnp.asarray(images), "y": jnp.asarray(labels)},
                    mesh)
    out = jax.tree_util.tree_map(np.asarray, reference(
        P, b["x"], b["y"], jax.random.PRNGKey(5)))
    return SimpleNamespace(state=state, out=out,
                           masks=_dropout_masks(out["masks"]))


def semantic_batch():
    rs = np.random.RandomState(1)
    images = rs.rand(B_SEM, S, S, 3).astype(np.float32)
    labels = rs.randint(-1, C, (B_SEM, S // 8, S // 8)).astype(np.int32)
    labels[1, :3] = -1           # the ranks count different valid pixels
    return images, labels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group job in one 2-rank launch, with world size 1's results
    and JAX's references computed here."""
    tmp = tmp_path_factory.mktemp("ddp")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        d_model = TD.Derenderer(num_classes=3)
    d_fields = TP.DerenderTrainer(d_model, None, 0).init().fields()
    batch = derender_batch()
    images, labels = semantic_batch()
    jobs = {"mesh": {"kind": "mesh"}}
    jobs["derender64"] = {"kind": "derender_step", "fields": d_fields,
                          "batch": batch, "mode": "full", "image": IMAGE,
                          "dtype": "float64", "seed": 0}
    jobs["semantic64"] = {"kind": "semantic_step", "num_class": C,
                          "init_seed": 0, "images": images,
                          "labels": labels, "dtype": "float64", "seed": 0}
    one = {k: W.JOBS[jobs[k]["kind"]](jobs[k]) for k in jobs}
    for k in ("derender64", "semantic64"):
        jobs[k]["want"] = one[k]

    jd = jax_derender_reference(batch)
    jobs["derender32"] = {"kind": "derender_halves",
                          "fields": derender_train_state_from_jax(jd.state),
                          "batch": batch, "mode": "full", "image": IMAGE,
                          "enc": jd.enc, "g_enc": jd.g, "draws": jd.draws,
                          "inter": jd.inter}
    js = jax_semantic_reference(images, labels)
    enc_sd, dec_sd = semantic_state_dicts_from_jax(
        {"params": js.state.params, "batch_stats": js.state.batch_stats})
    jobs["semantic32"] = {"kind": "semantic_halves", "num_class": C,
                          "encoder": enc_sd, "decoder": dec_sd,
                          "images": images, "labels": labels,
                          "conv_out": js.out["conv_out"], "masks": js.masks,
                          "g_conv": js.out["g_conv"]}
    names = list(jobs)
    ranks = run_group(tmp, [jobs[k] for k in names])
    two = [dict(zip(names, r)) for r in ranks]
    return SimpleNamespace(one=one, two=two, jobs=jobs, jd=jd, js=js)


def test_mesh_helpers(runs):
    """make_mesh_for_batch's counterpart raises ValueError naming the
    largest world size that divides the batch; the slices, the sharded
    batch, the counts and the global draw are each rank's part."""
    for r, out in enumerate(x["mesh"] for x in runs.two):
        assert out["rank"] == r and out["world"] == 2
        assert out["mesh"][:2] == (r, 2)
        assert out["slice"] == slice(4 * r, 4 * r + 4) == out["sharding"]
        np.testing.assert_array_equal(out["shard"]["a"],
                                      np.arange(4 * r, 4 * r + 4))
        assert out["shard"]["b"][0].shape == (4, 2)
        assert out["count"] == 3.0
        assert out["mean"] == pytest.approx([0.75, 2.75][r])
        assert "world size 2 does not divide the global batch 3" \
            in out["error"] and "that does is 1" in out["error"]
        g = torch.Generator().manual_seed(7)
        np.testing.assert_array_equal(
            out["draw"], torch.rand((4, 3), generator=g)[2 * r:2 * r + 2])
    one = runs.one["mesh"]
    assert one["error"] is None and one["slice"] == slice(0, 8)
    assert one["count"] == 1.0 and one["mean"] == 1.5
    assert not parallel.active()


def test_derender_step_world_two_matches_world_one_in_float64(runs):
    """One geometric_train step (mode full, a mask loss, REINFORCE) at
    world size 2 against world size 1 on the same global batch of 4,
    whose ranks select different numbers of samples for each loss family:
    every loss, the gradient (Adam's moments) and every running statistic
    within F64_RTOL of its largest entry, the parameters within
    F64_ADAM_ATOL.  The mean of per-rank means would move the losses by
    O(1e-2)."""
    want = runs.one["derender64"]
    for out in (x["derender64"] for x in runs.two):
        for k, v in want["losses"].items():
            assert abs(out["losses"][k] - v) <= F64_RTOL * abs(v), k
        errors = out["errors"]
        assert len(errors) > 100
        for n, (err, scale) in errors.items():
            if n.startswith("opt.") or n.endswith(("running_mean",
                                                   "running_var")):
                assert err <= F64_RTOL * scale, (n, err, scale)
            else:
                assert err <= F64_ADAM_ATOL, (n, err)


def test_semantic_step_world_two_matches_world_one_in_float64(runs):
    """One semantic_train step at world size 2 against world size 1 on
    the same global batch of 2 (the ranks count different valid pixels),
    the dropout masks drawn for the global batch: the loss, the accuracy,
    every parameter, SGD trace and running statistic within F64_RTOL of
    its largest entry."""
    want = runs.one["semantic64"]
    for out in (x["semantic64"] for x in runs.two):
        for k, v in want["metrics"].items():
            assert abs(out["metrics"][k] - v) <= F64_RTOL * abs(v), k
        bad = {n: e for n, e in out["errors"].items()
               if e[0] > F64_RTOL * e[1]}
        assert not bad and len(out["errors"]) > 300, bad
        for n, w in want["stats"].items():
            np.testing.assert_allclose(out["stats"][n], w, rtol=0,
                                       atol=F64_RTOL * np.abs(w).max(),
                                       err_msg=n)


@pytest.mark.parametrize("job", ["derender64", "semantic64", "derender32",
                                 "semantic32"])
def test_running_statistics_are_the_same_bits_on_both_ranks(runs, job):
    """Every BatchNorm's running statistics after the step (or training
    forward) are the same bits on the two ranks."""
    a, b = (x[job]["stats"] for x in runs.two)
    assert sorted(a) == sorted(b) and len(a) >= 40
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_derender_halves_match_jax_on_a_two_device_mesh(runs):
    """The float32 step at world size 2 against JAX's on a 2-device mesh,
    JAX's class draws given: the losses (tests/test_torch_derender_train's
    1e-5 from identical inputs), the loss's gradient in the encoder
    outputs within 3% of each output's largest entry (its bound: a walk
    gate may move), the encoder's VJP of JAX's cotangent within 2e-3 of
    each parameter's largest entry (cosine 0.9999), and the running
    statistics within 5e-5 of each tensor's largest."""
    jd = runs.jd
    outs = [x["derender32"] for x in runs.two]
    for out in outs:
        for k, v in jd.losses.items():
            np.testing.assert_allclose(out["losses"][k], v, rtol=1e-5,
                                       err_msg=k)
        assert out["enc"].keys() == outs[0]["enc"].keys()
    for k in W.HEAD_KEYS:
        got = np.concatenate([out["head"][k] for out in outs])
        close(got, jd.g[k], 0.03, k)
    want = derenderer_state_dict_from_jax(
        {"params": jd.g_params, "batch_stats": jd.state.batch_stats})
    for out in outs:
        for name, n, band, worst in out["flips"]:
            assert n <= 2 and worst <= band <= 2e-4, out["flips"]
        for n, g in out["enc"].items():
            close(g, want[n].numpy(), 2e-3, n, min_cos=0.9999)
    stats = derenderer_state_dict_from_jax(
        {"params": jd.state.params, "batch_stats": jd.stats})
    for n, got in outs[0]["stats"].items():
        w = stats[n.split(".", 1)[1]].numpy()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=5e-5 * np.abs(w).max(), err_msg=n)


def _semantic_truth(job, part):
    """A float64 run of the port at world size 1 from the same inputs: the
    decoder's or the encoder's gradients by parameter name, and for the
    decoder those in C4, C5 (NHWC)."""
    tm = W._semantic_model(job, torch.float64)
    if part == "decoder":
        conv_out = [W._nchw(f).double().requires_grad_(i >= 2)
                    for i, f in enumerate(job["conv_out"])]
        total, _ = W.TPS.SemanticTrainer(tm).objective(
            tm.decoder(conv_out, dropout=job["masks"]),
            torch.from_numpy(job["labels"]).long())
        net = tm.decoder
        grads = torch.autograd.grad(total, list(net.parameters())
                                    + conv_out[2:])
    else:
        net = tm.encoder
        grads = torch.autograd.grad(
            tm.encoder.stages(W._nchw(job["images"]).double())[1:],
            list(net.parameters()),
            grad_outputs=[W._nchw(g).double() for g in job["g_conv"]])
    named = {n: g.numpy() for (n, _), g in zip(net.named_parameters(), grads)}
    n = len(named)
    return named, [np.transpose(g.numpy(), (0, 2, 3, 1)) for g in grads[n:]]


def test_semantic_halves_match_jax_on_a_two_device_mesh(runs):
    """The float32 semantic step at world size 2 against JAX's on a
    2-device mesh, with JAX's dropout masks: the loss within LOSS_RTOL and
    the accuracy equal; each half's gradients (summed over the ranks), and
    JAX's, within MESH_DEC_BOUNDS / JAX_ENC_BOUNDS of a float64 run of the
    port, and their gradients in C4, C5 within CONV_RTOL of its; the
    running statistics within STATS_RTOL of JAX's."""
    js, job = runs.js, runs.jobs["semantic32"]
    outs = [x["semantic32"] for x in runs.two]
    ns = SimpleNamespace(state=js.state)
    for out in outs:
        np.testing.assert_allclose(out["metrics"]["loss"],
                                   float(js.out["total"]), rtol=LOSS_RTOL)
        assert out["metrics"]["acc"] == pytest.approx(
            float(js.out["acc"]), abs=1e-7)
    for part, key, bounds in (("decoder", "g_dec", MESH_DEC_BOUNDS),
                              ("encoder", "g_enc", JAX_ENC_BOUNDS)):
        truth, g_conv = _semantic_truth(job, part)
        for who, named in [("jax", _grad_names(ns, js.out[key], part))] + [
                ("port", out[key]) for out in outs]:
            worst, low_cos, whole = _against(named, truth)
            assert worst <= bounds[0], (part, who, worst)
            assert whole >= bounds[1], (part, who, whole)
            assert low_cos >= bounds[2], (part, who, low_cos)
        if part == "decoder":
            for i, want in enumerate(g_conv):
                for who, got in (("jax", js.out["g_conv"][2 + i]), (
                        "port", np.concatenate([out["g_conv"][i]
                                                for out in outs]))):
                    np.testing.assert_allclose(
                        got, want, rtol=0,
                        atol=CONV_RTOL * np.abs(want).max(), err_msg=who)
    stats = {"encoder": js.out["enc_stats"], "decoder": js.out["dec_stats"]}
    enc, dec = semantic_state_dicts_from_jax(
        {"params": js.state.params, "batch_stats": stats})
    for n, got in outs[0]["stats"].items():
        i, name = n.split(".", 1)
        w = (enc, dec)[int(i)][name].numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=STATS_RTOL * max(
            float(np.abs(w).max()), 1e-6), err_msg=n)


def _cli(tmp_path, world, ckpt):
    args = ["-m", "sdn3d_tpu_torch.cli.geometric_train", "--synthetic",
            "--mode", "pretrain", "--num_iters", str(CLI_STEPS),
            "--batch_size", "4", "--image_size", "32", "--render_size", "32",
            "--lr", str(CLI_LR), "--device", "cpu", "--ckpt_dir", str(ckpt)]
    if world:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(world)] + args
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    return r.stdout, restore_checkpoint(str(ckpt))[0]


def _adam_update(mu, nu, lr=CLI_LR):
    """The first step's Adam update of the saved moments (float64)."""
    mu, nu = mu.numpy().astype(np.float64), nu.numpy().astype(np.float64)
    return lr * (mu / 0.1) / (np.sqrt(nu / 1e-3) + 1e-8)


def test_geometric_train_cli_under_torchrun(tmp_path):
    """`torchrun --standalone --nproc_per_node 2 -m
    sdn3d_tpu_torch.cli.geometric_train --device cpu --synthetic` saves
    (rank 0 alone) the step that a run with no group saves: the step
    count and the first losses it logs equal; Adam's moments (the
    gradient) and the running statistics within CLI_RTOL of each tensor's
    largest entry; the parameters each run's Adam step of its moments."""
    log2, two = _cli(tmp_path, 2, tmp_path / "two")
    log1, one = _cli(tmp_path, 0, tmp_path / "one")
    assert log2.count("iter 0:") == 1 and log2.count("done") == 1
    assert log2.split("iter 0:")[1].split()[:3] == \
        log1.split("iter 0:")[1].split()[:3]
    assert int(two["step"]) == int(one["step"]) == CLI_STEPS
    for k in ("mu", "nu"):
        for n, w in one["opt_state"][k].items():
            w = w.numpy()
            np.testing.assert_allclose(two["opt_state"][k][n].numpy(), w,
                                       rtol=0, atol=CLI_RTOL * max(
                                           np.abs(w).max(), 1e-30),
                                       err_msg=(k, n))
    sd1, sd2 = one["derenderer"], two["derenderer"]
    for n, w in sd1.items():
        if not w.is_floating_point():
            assert torch.equal(sd2[n], w), n
        elif n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd2[n].numpy(), w.numpy(), rtol=0,
                                       atol=CLI_RTOL * w.abs().max().item(),
                                       err_msg=n)
        else:
            u1, u2 = (_adam_update(r["opt_state"]["mu"][n],
                                   r["opt_state"]["nu"][n])
                      for r in (one, two))
            got = sd2[n].numpy().astype(np.float64) - w.numpy()
            ulp = np.spacing(np.maximum(np.abs(w.numpy()),
                                        np.abs(sd2[n].numpy())))
            np.testing.assert_allclose(got, u1 - u2, rtol=0,
                                       atol=4 * ulp.max() + 1e-4 * CLI_LR,
                                       err_msg=n)


def test_ranks_load_only_their_rows(tmp_path, monkeypatch):
    """The dataset modes' DistributedSampler role, with no group: the
    PrefetchLoader's `batch_slice` and semantic_train's `vkitti_batches`
    with `rows` give each rank's rows of the global batches that the full
    loaders give, in the same order (the same sampler / RandomState
    draws)."""
    from sdn3d_tpu_torch.cli import semantic_train as TCLI
    from sdn3d_tpu_torch.data import synthetic, vkitti
    from sdn3d_tpu_torch.data.loader import PrefetchLoader

    ds = [{"x": np.full((2,), i, np.float32)} for i in range(24)]
    full = [b["x"][:, 0] for b in PrefetchLoader(ds, 6, num_workers=2,
                                                 seed=3)]
    for r in range(3):
        part = [b["x"][:, 0] for b in PrefetchLoader(
            ds, 6, num_workers=2, seed=3, batch_slice=slice(2 * r, 2 * r + 2))]
        assert len(part) == len(full) == 4
        for p, f in zip(part, full):
            np.testing.assert_array_equal(p, f[2 * r:2 * r + 2])

    frames = {("0001", "clone", f"{i:05d}"): [(60, 20 + 40 * i, 100,
                                               80 + 40 * i)]
              for i in range(3)}
    root = str(tmp_path / "vk")
    synthetic.write_vkitti_root(root, frames, height=120, width=200)
    names = sorted(f"{w}/{t}/{f}.png" for w, t, f in frames)
    monkeypatch.setattr(vkitti, "get_lists", lambda opt: names)
    args = SimpleNamespace(batch_size=4, crop_size=64, num_class=C,
                           data_root=root)
    full = TCLI.vkitti_batches(args, np.random.RandomState(0))
    parts = [TCLI.vkitti_batches(args, np.random.RandomState(0),
                                 slice(2 * r, 2 * r + 2)) for r in range(2)]
    for _ in range(2):
        x, y = next(full)
        for r, part in enumerate(parts):
            px, py = next(part)
            assert px.tobytes() == x[2 * r:2 * r + 2].tobytes()
            assert py.tobytes() == y[2 * r:2 * r + 2].tobytes()

"""The port's semantic training and evaluation (sdn3d_tpu_torch.models.
semantic's training branch and decoders, data.semantic_data's training
half, pipelines.semantic's trainer and metrics, utils.port's train-state
converter, cli.semantic_train and cli.semantic_eval) against the JAX
package's, on the CPU, at the full-width model on 2 x 32 x 32 crops.

The JAX state is built once for the file (its init and its one jitted
reference take ~20 s of CPU compiles).  A train step is compared in two
halves from identical inputs, as the derenderer's and the textural
trainer's parity tests do: the decoder's loss and gradients from JAX's
encoder features, and the encoder's VJP of JAX's cotangent in those
features.  Dropout's keep masks are JAX's, read off the outputs of its
dropout layers and handed to the port."""

import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.cli import semantic_train as JCLI
from sdn3d_tpu.data import semantic_data as JD
from sdn3d_tpu.data import vkitti as JV
from sdn3d_tpu.models import semantic as JS
from sdn3d_tpu.models.resnet import Bottleneck, ResNet
from sdn3d_tpu.pipelines import semantic as JP
from sdn3d_tpu.utils.profiling import AverageMeter as JMeter
from sdn3d_tpu_torch.cli import semantic_eval as TEVAL
from sdn3d_tpu_torch.cli import semantic_test as TTEST
from sdn3d_tpu_torch.cli import semantic_train as TCLI
from sdn3d_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from sdn3d_tpu_torch.data import semantic_data as TD
from sdn3d_tpu_torch.data import vkitti as TV
from sdn3d_tpu_torch.models import semantic as TS
from sdn3d_tpu_torch.pipelines import semantic as TP
from sdn3d_tpu_torch.utils import port as TPORT
from sdn3d_tpu_torch.utils.profiling import AverageMeter, StepTimer

B, S, C = 2, 32, 14
# The training forward's log-probabilities (absolute; they are O(1)).
# From the images: the two ResNet-50s' features differ in float32 rounding,
# and train-mode BatchNorm over the 2 values a channel of the PPM's 1x1
# pool divides a near-zero spread by sqrt(var + 1e-5), which magnifies
# that rounding up to ~300 times (measured 1.3e-3).  From JAX's features
# the same BatchNorm magnifies the decoder's own rounding (measured
# 3.0e-4).  The losses (relative) and the accuracy
# (exact: no argmax sits at a near-tie on this batch) from JAX's features.
FWD_ATOL = 5e-3
LOGP_ATOL = 1e-3
LOSS_RTOL = 1e-5
# Gradients from identical inputs, held against a float64 run of the
# port: a parameter's error is relative to the larger of its own largest
# entry and GRAD_FLOOR times its half's largest gradient, its cosine
# counts where it reaches that floor; the port must be no further from
# float64 than JAX (or within GRAD_RTOL / GRAD_COS).
GRAD_RTOL, GRAD_FLOOR, GRAD_COS = 1e-3, 1e-2, 0.99999
# The decoder half's float32 rounding on the CPU: torch's weight gradient
# of conv_last.0 (4096 -> 512, 3x3 over 2 x 4 x 4 positions) sits
# 1.3e-3 .. 2.2e-3 of its scale off float64 (JAX's 4.6e-4 .. 6.6e-4).
DEC_GRAD_RTOL = 5e-3
# JAX's own float32 gradients held against the port's float64 run at fixed
# bounds, so that a port whose backward computes something else than JAX's
# (a statistic detached, another subgradient) fails whatever its float32
# and float64 runs say of each other: (worst parameter as in _against,
# cosine of the half as one vector, lowest parameter cosine).  Measured
# here: decoder 6.6e-4, 1 - 1.7e-8, 0.9999997; encoder 0.263, 1 - 7.0e-4,
# 0.99898 (train-mode BatchNorm over 2 x 4 x 4 values a channel).
JAX_DEC_BOUNDS = (2e-3, 1 - 1e-7, 0.99999)
JAX_ENC_BOUNDS = (0.5, 0.998, 0.995)
# Running statistics after a step, relative to each layer's largest: the
# C4 / C5 features of the two packages differ by up to ~3.6e-4 of their
# scale (train-mode BatchNorm over 32 values a channel).
STATS_RTOL = 1e-3
# SGD on identical gradients: within 2 ulp of optax's (XLA's CPU backend
# may fuse the trace update into an FMA); the poly schedule within 1 ulp.
SGD_ULP, SCHEDULE_ULP = 2, 1
# The decoders alone from identical features: outputs relative to their
# largest magnitude.
DEC_RTOL = 2e-5


def _np(t):
    return t.detach().cpu().numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(_np(t), (0, 2, 3, 1))


def _dropout_masks(intermediates):
    """JAX's keep masks, NCHW bool, in the order its dropouts ran: an
    output that is nonzero was kept (where the input is 0 the mask does
    not matter, both packages give 0)."""
    names = sorted(intermediates)
    return [_nchw(np.asarray(intermediates[n]["__call__"][0]) != 0)
            for n in names]


def _dropout_filter(mdl, _):
    return isinstance(mdl, fnn.Dropout)


@pytest.fixture(scope="module")
def ref():
    """The JAX state at init, a batch, and one jitted reference: the
    encoder's features in train mode and its new statistics, the
    decoder's outputs, loss and accuracy from them with a dropout draw,
    the decoder's gradients in its parameters and in the features, and
    the encoder's VJP of that cotangent."""
    jm = JS.SemanticModel(num_class=C)
    trainer = JP.SemanticTrainer(jm)
    state = jax.jit(trainer.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, S, S, 3)))
    state = jax.tree_util.tree_map(np.asarray, state)
    rs = np.random.RandomState(1)
    images = rs.rand(B, S, S, 3).astype(np.float32)
    labels = rs.randint(-1, C, (B, S // 8, S // 8)).astype(np.int32)
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
        loss = JS.segmentation_loss(log_p, y)
        loss_d = JS.segmentation_loss(log_d, y)
        total = loss + trainer.deep_sup_scale * loss_d
        return total, (log_p, log_d, loss, loss_d,
                       JS.pixel_accuracy(log_p, y), new)

    @jax.jit
    def reference(P, x, y, rng):
        conv_out, vjp, enc_stats = jax.vjp(lambda p: enc_apply(p, x),
                                           P["encoder"], has_aux=True)
        (total, aux), (g_dec, g_conv) = jax.value_and_grad(
            dec_loss, argnums=(0, 1), has_aux=True)(P["decoder"], conv_out,
                                                    y, rng)
        (g_enc,) = vjp(g_conv)
        return dict(conv_out=conv_out, enc_stats=enc_stats, total=total,
                    log_p=aux[0], log_d=aux[1], loss=aux[2], loss_d=aux[3],
                    acc=aux[4], dec_stats=aux[5]["batch_stats"],
                    masks=aux[5]["intermediates"], g_dec=g_dec,
                    g_conv=g_conv, g_enc=g_enc)

    out = jax.tree_util.tree_map(np.asarray, reference(
        P, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(5)))
    return SimpleNamespace(jm=jm, trainer=trainer, state=state,
                           images=images, labels=labels, out=out,
                           masks=_dropout_masks(out["masks"]))


def _port_model(ref):
    tm = TS.SemanticModel(num_class=C)
    enc, dec = TPORT.semantic_state_dicts_from_jax(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats})
    tm.encoder.load_state_dict(enc)
    tm.decoder.load_state_dict(dec)
    return tm


def _grad_names(ref, grads, part):
    """JAX gradients of one half -> {torch parameter name: array}."""
    P = dict(ref.state.params)
    P[part] = grads
    enc, dec = TPORT.semantic_state_dicts_from_jax(
        {"params": P, "batch_stats": ref.state.batch_stats})
    return {n: v.numpy() for n, v in (enc if part == "encoder"
                                      else dec).items()
            if not n.endswith(TPORT._STATS)}


def _cos(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _against(named, truth):
    """(the worst parameter's error, relative to the larger of its own
    largest entry and GRAD_FLOOR times the half's largest, the lowest
    cosine among the parameters that reach that floor, and the cosine of
    the half as one vector) of the gradients `named` ({name: array})
    against `truth` (a float64 run)."""
    top = max(float(np.abs(v).max()) for v in truth.values())
    worst, low_cos = 0.0, 1.0
    for n, r in truth.items():
        g = np.asarray(named[n], np.float64)
        scale = float(np.abs(r).max())
        worst = max(worst, float(np.abs(g - r).max())
                    / max(scale, GRAD_FLOOR * top))
        if scale >= GRAD_FLOOR * top:
            low_cos = min(low_cos, _cos(g, r))
    whole = _cos(np.concatenate([np.ravel(named[n]) for n in truth]
                                ).astype(np.float64),
                 np.concatenate([np.ravel(r) for r in truth.values()]))
    return worst, low_cos, whole


def _no_further_than_jax(port, jax_grads, truth, bounds, floor=GRAD_RTOL):
    """JAX's float32 gradients of a half agree with a float64 run of the
    port within `bounds` (JAX_*_BOUNDS); and the port's float32 gradients
    are at least as close to that run as JAX's are: worst error within the
    larger of JAX's and `floor`, lowest cosine at least the smaller of
    JAX's and GRAD_COS."""
    p_worst, p_cos, _ = _against(port, truth)
    j_worst, j_cos, j_whole = _against(jax_grads, truth)
    assert j_worst <= bounds[0], ("JAX against the port", j_worst)
    assert j_whole >= bounds[1], ("JAX against the port", j_whole)
    assert j_cos >= bounds[2], ("JAX against the port", j_cos)
    assert p_worst <= max(j_worst, floor), (p_worst, j_worst)
    assert p_cos >= min(j_cos, GRAD_COS), (p_cos, j_cos)


def _named_grads(net, grads):
    return {n: _np(g) for (n, _), g in zip(net.named_parameters(), grads)}


def test_training_forward_loss_and_accuracy_match_jax(ref):
    """The training branch (seg_size None, train mode) with JAX's dropout
    masks.  From the images: log_p and log_d within FWD_ATOL.  From JAX's
    encoder features (identical inputs to the decoder): log_p and log_d
    within LOGP_ATOL, the loss (NLL + 0.4 x deep supervision) within
    LOSS_RTOL and the accuracy equal; the loss on JAX's own
    log-probabilities within 1e-6."""
    tm = _port_model(ref).train()
    log_p, log_d = tm(_nchw(ref.images), dropout=ref.masks)
    assert log_p.dtype == torch.float32 and log_p.shape == (B, C, 4, 4)
    for got, want in ((log_p, "log_p"), (log_d, "log_d")):
        np.testing.assert_allclose(_nhwc(got), ref.out[want], rtol=0,
                                   atol=FWD_ATOL)
    tm = _port_model(ref).train()
    log_p, log_d = tm.decoder([_nchw(f) for f in ref.out["conv_out"]],
                              dropout=ref.masks)
    for got, want in ((log_p, "log_p"), (log_d, "log_d")):
        np.testing.assert_allclose(_nhwc(got), ref.out[want], rtol=0,
                                   atol=LOGP_ATOL)
    trainer = TP.SemanticTrainer(tm)
    y = torch.from_numpy(ref.labels).long()
    total, acc = trainer.objective((log_p, log_d), y)
    np.testing.assert_allclose(float(total), float(ref.out["total"]),
                               rtol=LOSS_RTOL)
    assert float(acc) == float(ref.out["acc"])
    exact = TS.segmentation_loss(_nchw(ref.out["log_p"]), y)
    np.testing.assert_allclose(float(exact), float(ref.out["loss"]),
                               rtol=1e-6)


def test_loss_with_every_label_ignored_is_zero():
    """JAX's max(sum(valid), 1): an all-ignored batch gives loss 0 (not
    NaN) and a zero gradient; the accuracy is 0."""
    log_p = torch.randn(2, C, 3, 3, requires_grad=True).log_softmax(1)
    y = torch.full((2, 3, 3), -1)
    loss = TS.segmentation_loss(log_p, y)
    assert float(loss) == 0.0
    assert float(TS.pixel_accuracy(log_p, y)) == 0.0
    want = JS.segmentation_loss(jnp.asarray(_nhwc(log_p)),
                                jnp.asarray(y.numpy()))
    assert float(want) == 0.0


def _decoder_grads(ref, dtype):
    """The port decoder's gradients in its parameters and in C4, C5 from
    JAX's features and masks, in `dtype`."""
    tm = _port_model(ref).to(dtype).train()
    conv_out = [_nchw(f).to(dtype).requires_grad_(True)
                for f in ref.out["conv_out"]]
    total, _ = TP.SemanticTrainer(tm).objective(
        tm.decoder(conv_out, dropout=ref.masks),
        torch.from_numpy(ref.labels).long())
    grads = torch.autograd.grad(total, list(tm.decoder.parameters())
                                + conv_out[2:])
    n = len(list(tm.decoder.parameters()))
    return _named_grads(tm.decoder, grads[:n]), grads[n:]


def test_decoder_gradients_match_jax(ref):
    """The decoder half from identical inputs (JAX's features and dropout
    masks): JAX's gradients in the decoder's parameters within
    JAX_DEC_BOUNDS of a float64 run of the port, the port's float32 ones
    within DEC_GRAD_RTOL of it or no further than JAX's, and the gradients
    in the features (C4, C5) within GRAD_RTOL of their scale of JAX's."""
    got, g_conv = _decoder_grads(ref, torch.float32)
    truth, _ = _decoder_grads(ref, torch.float64)
    _no_further_than_jax(got, _grad_names(ref, ref.out["g_dec"], "decoder"),
                         truth, JAX_DEC_BOUNDS, floor=DEC_GRAD_RTOL)
    for g, want in zip(g_conv, ref.out["g_conv"][2:]):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_nhwc(g), want, rtol=0,
                                   atol=GRAD_RTOL * scale)


def _encoder_grads(ref, dtype):
    """The port encoder's VJP of JAX's cotangent in C2..C5, in `dtype`,
    and the model after that training forward."""
    tm = _port_model(ref).to(dtype).train()
    feats = tm.encoder.stages(_nchw(ref.images).to(dtype))[1:]
    grads = torch.autograd.grad(feats, list(tm.encoder.parameters()),
                                grad_outputs=[_nchw(g).to(dtype)
                                              for g in ref.out["g_conv"]])
    return _named_grads(tm.encoder, grads), tm


def test_encoder_gradients_and_statistics_match_jax(ref):
    """The encoder half: JAX's VJP of its cotangent in C2..C5 within
    JAX_ENC_BOUNDS of a float64 run of the port's VJP of the same
    cotangent, and the port's float32 VJP no further from that run than
    JAX's is.  Train-mode BatchNorm
    over 2 x 4 x 4 values a channel at C3..C5 is ill-conditioned at this
    size: JAX's float32 sits up to ~26% off float64 in a small
    parameter's gradient (cosine 0.999), the port's up to ~11% (cosine
    0.9996).  Then the running statistics a training forward leaves
    (flax's momentum 0.9 towards the biased batch variance), encoder and
    decoder, within STATS_RTOL of each layer's largest."""
    got, tm = _encoder_grads(ref, torch.float32)
    truth, _ = _encoder_grads(ref, torch.float64)
    _no_further_than_jax(got, _grad_names(ref, ref.out["g_enc"], "encoder"),
                         truth, JAX_ENC_BOUNDS)
    tm.decoder([_nchw(f) for f in ref.out["conv_out"]], dropout=ref.masks)
    stats = {"encoder": ref.out["enc_stats"], "decoder": ref.out["dec_stats"]}
    enc, dec = TPORT.semantic_state_dicts_from_jax(
        {"params": ref.state.params, "batch_stats": stats})
    for net, want in ((tm.encoder, enc), (tm.decoder, dec)):
        got = net.state_dict()
        for n in want:
            if n.endswith(("running_mean", "running_var")):
                w = want[n].numpy()
                np.testing.assert_allclose(
                    got[n].numpy(), w, rtol=0,
                    atol=STATS_RTOL * max(float(np.abs(w).max()), 1e-6),
                    err_msg=n)


def test_sgd_step_and_train_state_match_optax(ref):
    """A JAX train state two SGD steps in (nonzero traces, count 2),
    converted with utils/port.semantic_train_state_from_jax, then one more
    step of each optimizer from the same gradients in both packages:
    every parameter and trace within SGD_ULP ulp; the fields round-trip."""
    rs = np.random.RandomState(3)
    st = ref.state
    tr = ref.trainer
    params = st.params
    opt = {"encoder": st.opt_state_enc, "decoder": st.opt_state_dec}
    tx = {"encoder": tr.tx_enc, "decoder": tr.tx_dec}
    grads = [jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 1e-2).astype(np.float32), params)
        for _ in range(3)]
    def step(t, g, o, p):
        # one jitted update and apply, as in the JAX train step
        u, o = t.update(g, o, p)
        return optax.apply_updates(p, u), o
    upd = jax.jit(step, static_argnums=0)
    for g in grads[:2]:
        params = dict(params)
        for part in ("encoder", "decoder"):
            params[part], opt[part] = upd(tx[part], g[part], opt[part],
                                          params[part])
    jstate = st.replace(step=np.int32(2), params=params,
                        opt_state_enc=opt["encoder"],
                        opt_state_dec=opt["decoder"])
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    fields = TPORT.semantic_train_state_from_jax(jstate)
    tm = TS.SemanticModel(num_class=C)
    trainer = TP.SemanticTrainer(tm)
    pstate = TP.SemanticTrainState.from_fields(fields, tm)
    assert (pstate.step, pstate.count_enc, pstate.count_dec) == (2, 2, 2)
    back = pstate.fields()
    for key in ("opt_enc", "opt_dec"):
        for n, v in fields[key]["trace"].items():
            assert torch.equal(back[key]["trace"][n], v), n
    g_names = {part: _grad_names(ref, grads[2][part], part)
               for part in ("encoder", "decoder")}
    trainer.apply_gradients(
        pstate,
        [torch.from_numpy(g_names["encoder"][n])
         for n, _ in tm.encoder.named_parameters()],
        [torch.from_numpy(g_names["decoder"][n])
         for n, _ in tm.decoder.named_parameters()])
    for part in ("encoder", "decoder"):
        params[part], opt[part] = upd(tx[part], grads[2][part], opt[part],
                                      params[part])
    want = TPORT.semantic_train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.replace(params=params,
                                   opt_state_enc=opt["encoder"],
                                   opt_state_dec=opt["decoder"])))
    got = pstate.fields()
    for key in ("encoder", "decoder"):
        for n, v in want[key].items():
            if v.is_floating_point():
                np.testing.assert_array_max_ulp(got[key][n].numpy(),
                                                v.numpy(), maxulp=SGD_ULP)
    for key in ("opt_enc", "opt_dec"):
        assert int(got[key]["count"]) == int(want[key]["count"]) == 3
        for n, v in want[key]["trace"].items():
            np.testing.assert_array_max_ulp(got[key]["trace"][n].numpy(),
                                            v.numpy(), maxulp=SGD_ULP)


@pytest.mark.parametrize("count,max_iters", [(0, 100_000), (37, 100),
                                             (51_234, 100_000), (100, 100),
                                             (250, 100)])
def test_poly_schedule_matches_optax(count, max_iters):
    """The learning rate of a count (before the step), at 0, mid-run, at
    max_iters (a few 1e-9: XLA's fused 1 - count * (1 / max_iters)) and
    past it (clamped to 0, not NaN): optax's jitted update of a unit
    gradient at a zero parameter gives -lr."""
    jt = JP.SemanticTrainer(None, lr_encoder=2e-2, max_iters=max_iters)
    o = jt.tx_enc.init({"w": jnp.zeros(1)})
    o = (o[0], (o[1][0], o[1][1]._replace(count=jnp.asarray(count,
                                                           jnp.int32))))
    u, _ = jax.jit(jt.tx_enc.update)({"w": jnp.ones(1)}, o,
                                     {"w": jnp.zeros(1)})
    want = -np.asarray(u["w"])[0]
    got = np.float32(TP.SemanticTrainer(None, max_iters=max_iters)
                     .learning_rate(2e-2, count))
    np.testing.assert_array_max_ulp(got, want, maxulp=SCHEDULE_ULP)
    if count > max_iters:
        assert got == 0.0


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("arch", sorted(TS.DECODERS))
def test_decoders_match_jax(arch, train):
    """Each decoder alone at full width from identical features (C4 1024,
    C5 2048 channels at 4x4, batch 2): inference (softmax at 24x24) and
    the training branch (log-probabilities; JAX's dropout masks) with the
    running statistics it leaves; weights through
    utils/port.semantic_decoder_state_dict_from_jax."""
    rs = np.random.RandomState(len(arch) + train)
    conv_out = [rs.randn(B, 4, 4, c).astype(np.float32)
                for c in (256, 512, 1024, 2048)]
    jd = JS.DECODERS[arch](num_class=C)
    v = jd.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in conv_out],
                train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    td = TS.DECODERS[arch](num_class=C)
    td.load_state_dict(TPORT.semantic_decoder_state_dict_from_jax(
        v["params"], v.get("batch_stats", {}), arch))
    feats = [_nchw(f) for f in conv_out]
    if not train:
        want = jd.apply(v, conv_out, seg_size=(24, 24), train=False)
        got = td.eval()(feats, seg_size=(24, 24))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                                   atol=DEC_RTOL)
        return
    out, new = jd.apply(v, conv_out, train=True,
                        rngs={"dropout": jax.random.PRNGKey(4)},
                        mutable=["batch_stats", "intermediates"],
                        capture_intermediates=_dropout_filter)
    masks = _dropout_masks(new.get("intermediates", {}))
    assert len(masks) == sum(isinstance(m, TS.Dropout)
                             for m in td.modules())
    got = td.train()(feats, dropout=masks)
    want = out if isinstance(out, tuple) else (out,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (2 if arch.endswith("deepsup") else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0,
                                   atol=DEC_RTOL * float(np.abs(w).max()))
    want_sd = TPORT.semantic_decoder_state_dict_from_jax(
        v["params"], jax.tree_util.tree_map(np.asarray, new["batch_stats"]),
        arch)
    for n, w in want_sd.items():
        if n.endswith(("running_mean", "running_var")):
            w = w.numpy()
            np.testing.assert_allclose(
                td.state_dict()[n].numpy(), w, rtol=0,
                atol=STATS_RTOL * max(float(np.abs(w).max()), 1e-6))


@pytest.mark.parametrize("k,pad,stride", [(3, 1, 1), (1, 0, 1), (3, 1, 2)])
def test_decoder_conv_route_is_a_convolution(k, pad, stride):
    """models/semantic._GemmConv, the route of the decoders' convolutions
    training in float32 on the card, here on the CPU in float64: its
    output equals F.conv2d's and its gradients pass gradcheck; on a CPU
    tensor DecoderConv2d is Conv2d, bit for bit."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 3, 5, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(4, 3, k, k, generator=g, dtype=torch.float64,
                    requires_grad=True)
    conf = ((stride, stride), (pad, pad), (1, 1), 1)
    out = TS._GemmConv.apply(x, w, conf)
    assert torch.equal(out, torch.nn.functional.conv2d(
        x, w, stride=stride, padding=pad))
    assert torch.autograd.gradcheck(
        lambda a, b: TS._GemmConv.apply(a, b, conf), (x, w))
    conv = TS.DecoderConv2d(3, 4, k, stride=stride, padding=pad).train()
    plain = TS.Conv2d(3, 4, k, stride=stride, padding=pad)
    plain.load_state_dict(conv.state_dict())
    xf = x.detach().float()
    assert torch.equal(conv(xf), plain(xf))


def test_dropout_is_elementwise_and_drawn_from_the_generator():
    """flax's element-wise dropout: ~rate of the elements zeroed over
    whole channels' worth of values (not whole channels), kept ones
    scaled by 1 / (1 - rate), the same draws from the same generator
    seed, and the identity in eval mode."""
    d = TS.Dropout(0.1).train()
    x = torch.ones(2, 512, 8, 8)
    a = d(x, torch.Generator().manual_seed(3))
    b = d(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    dropped = float((a == 0).float().mean())
    assert 0.08 < dropped < 0.12
    per_channel = (a == 0).float().mean(dim=(2, 3))
    assert float(per_channel.max()) < 0.5          # not Dropout2d
    np.testing.assert_array_equal(np.unique(_np(a)),
                                  np.float32([0.0, np.float32(1) / 0.9]))
    assert torch.equal(d.eval()(x, torch.Generator()), x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepare_train_sample_is_byte_equal(seed):
    """Colour jitter, flip, scale draw, PIL resizes, padding, x8 label
    downsampling and normalisation: the same random.Random draws and the
    same bytes as JAX data/semantic_data.prepare_train_sample."""
    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    seg = rs.randint(0, 15, (60, 90)).astype(np.int64)
    want = JD.prepare_train_sample(rgb, seg, random.Random(seed))
    got = TD.prepare_train_sample(rgb, seg, random.Random(seed))
    for k in ("image", "label"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    assert TD.resize_shorter_edge(375, 1242, 100) == \
        JD.resize_shorter_edge(375, 1242, 100)


def _args(**kw):
    base = dict(batch_size=2, crop_size=64, num_class=C, data_root=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_synthetic_batches_are_byte_equal():
    """cli/semantic_train.synthetic_batches: the same RandomState stream,
    the same bytes, batch after batch."""
    a = JCLI.synthetic_batches(_args(), np.random.RandomState(0))
    b = TCLI.synthetic_batches(_args(), np.random.RandomState(0))
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


EDIT_ITEMS = [
    {"world": "0001", "topic": "15-deg-left", "source": "00356",
     "target": "00357", "operations": [
         {"type": "modify", "from": {"u": 400, "v": 230},
          "to": {"u": 420, "v": 230, "roi": [190, 360, 270, 470]}}]},
    {"world": "0002", "topic": "clone", "source": "00010",
     "target": "00011", "operations": [
         {"type": "delete", "from": {"u": 800, "v": 240}}]},
]


@pytest.fixture(scope="module")
def vkitti_root(tmp_path_factory):
    """The VKITTI fixture of scripts/make_vkitti_fixture over EDIT_ITEMS:
    four 375x1242 frames (0001/15-deg-left/00356 is the first of the test
    split)."""
    from scripts.make_vkitti_fixture import build_fixture
    d = tmp_path_factory.mktemp("vk")
    edit = str(d / "edit.json")
    with open(edit, "w") as f:
        json.dump(EDIT_ITEMS, f)
    build_fixture(str(d / "root"), edit)
    frames = sorted(f"{it['world']}/{it['topic']}/{it[k]}.png"
                    for it in EDIT_ITEMS for k in ("source", "target"))
    return str(d / "root"), frames


def test_vkitti_batches_are_byte_equal(vkitti_root, monkeypatch):
    """cli/semantic_train.vkitti_batches on the fixture, with get_lists
    patched in both packages to the fixture's frames: the same frame,
    crop and augmentation draws, the same bytes."""
    root, frames = vkitti_root
    monkeypatch.setattr(JV, "get_lists", lambda opt: frames)
    monkeypatch.setattr(TV, "get_lists", lambda opt: frames)
    args = _args(data_root=root)
    a = JCLI.vkitti_batches(args, np.random.RandomState(0))
    b = TCLI.vkitti_batches(args, np.random.RandomState(0))
    for _ in range(2):
        (xa, ya), (xb, yb) = next(a), next(b)
        assert xa.shape == (2, 64, 64, 3) and ya.shape == (2, 8, 8)
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()
        assert (ya >= 0).any()


def test_cli_one_step_is_served_by_semantic_test(tmp_path, monkeypatch):
    """cli/semantic_train.main --synthetic for one step on the CPU: its
    batch is JAX's second synthetic batch (the first is spent on init, as
    in JAX), the step directory holds the train-state layout, and
    semantic_test --ckpt_dir serves it."""
    seen = []
    step = TP.SemanticTrainer.train_step

    def record(self, state, images, labels, dropout=None):
        seen.append((images.clone(), labels.clone()))
        return step(self, state, images, labels, dropout)
    monkeypatch.setattr(TP.SemanticTrainer, "train_step", record)
    ck = str(tmp_path / "ck")
    state = TCLI.main(["--synthetic", "--batch_size", "2", "--crop_size",
                       "32", "--num_iters", "1", "--device", "cpu",
                       "--ckpt_dir", ck])
    assert state.step == 1 and len(seen) == 1
    want = JCLI.synthetic_batches(_args(crop_size=32),
                                  np.random.RandomState(0))
    next(want)
    x, y = next(want)
    np.testing.assert_array_equal(_nhwc(seen[0][0]), x)
    np.testing.assert_array_equal(seen[0][1].numpy(), y)
    fields, n = restore_checkpoint(ck)
    assert n == 1 and sorted(fields) == ["decoder", "encoder", "opt_dec",
                                         "opt_enc", "step"]
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["meta"]["crop_size"] == 32
    img = str(tmp_path / "frame.png")
    from PIL import Image
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 64, 3)).astype(np.uint8)).save(img)
    out = str(tmp_path / "out")
    TTEST.main(["--test_img", img, "--ckpt_dir", ck, "--result", out,
                "--scales", "100", "--device", "cpu"])
    labels = np.asarray(Image.open(os.path.join(out, "frame.png")))
    assert labels.shape == (40, 64) and labels.max() < C


def test_semantic_eval_matches_the_jax_loop(ref, vkitti_root, tmp_path,
                                            capsys):
    """cli/semantic_eval.main on the first test-split frame at scale 100,
    weights from a converted step directory, against the loop JAX's
    semantic_eval would run (its main reads args.compute_dtype, which its
    parser lacks, and stops before the first frame): JAX's
    multiscale_labels, accuracy, intersection_and_union and AverageMeter
    on the same frame.  Labels may flip at JAX's near-ties (a softmax
    mean within float32 rounding of another class's), so each IoU and the
    accuracy agree within 1e-3 of a pixel share."""
    from PIL import Image

    root, _ = vkitti_root
    enc, dec = TPORT.semantic_state_dicts_from_jax(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats})
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, 0, {"encoder": enc, "decoder": dec})
    got = TEVAL.main(["--data_root", root, "--ckpt_dir", ck, "--scales",
                      "100", "--limit", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Mean IoU:" in text and "class [13], IoU:" in text

    variables = {"params": ref.state.params,
                 "batch_stats": ref.state.batch_stats}
    table = JV.get_tables("segm", root)
    meter, inter_sum, union_sum = JMeter(), np.zeros(C), np.zeros(C)
    f = JV.get_lists("test")[0]
    world, scene, _ = f.split("/")
    rgb = np.asarray(Image.open(os.path.join(
        root, "vkitti_1.3.1_rgb", f)).convert("RGB"))
    gt = JV.decode_scenegt(np.asarray(Image.open(os.path.join(
        root, "vkitti_1.3.1_scenegt", f)).convert("RGB")), world, scene,
        table)
    img = rgb.astype(np.float32)[:, :, ::-1]
    img = (img - np.asarray(JD.MEAN_BGR, np.float32)) / np.asarray(
        JD.STD_BGR, np.float32)
    pred = JP.multiscale_labels(variables, ref.jm, img, scales=(100,))
    acc, pix = JP.accuracy(pred, gt)
    inter, union = JP.intersection_and_union(pred, gt, C)
    meter.update(acc, pix)
    inter_sum += inter
    union_sum += union
    iou = inter_sum / (union_sum + 1e-10)
    np.testing.assert_allclose(got["iou"], iou, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["accuracy"], meter.average * 100,
                               rtol=0, atol=1e-1)
    # the port's own labels from the uint8 frame against JAX's from the
    # host-normalised one
    tm = _port_model(ref).eval()
    mine = TP.multiscale_labels_fused(tm, rgb, scales=(100,), device="cpu")
    assert mine.dtype == np.uint8 and (mine == pred).mean() >= 0.999


def test_metrics_and_meters_match_jax():
    """intersection_and_union and accuracy on random maps with ignored
    labels, equal to JAX's; AverageMeter and StepTimer."""
    rs = np.random.RandomState(7)
    pred = rs.randint(0, C, (30, 40)).astype(np.uint8)
    label = rs.randint(-1, C, (30, 40)).astype(np.int64)
    for a, b in zip(TP.intersection_and_union(pred, label, C),
                    JP.intersection_and_union(pred, label, C)):
        np.testing.assert_array_equal(a, b)
    assert TP.accuracy(pred, label) == JP.accuracy(pred, label)
    m, jm = AverageMeter(), JMeter()
    for v, n in ((0.5, 10), (0.25, 30)):
        m.update(v, n)
        jm.update(v, n)
    assert m.average == jm.average
    t = StepTimer()
    with t.time("x"):
        pass
    assert set(t.summary()) == {"x"} and t.summary()["x"] >= 0.0

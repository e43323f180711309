"""compute_dtype="bfloat16" in the port (models/layers.py casts) against
the JAX package's bfloat16 models, on the CPU: the same weights (JAX's
random float32 init, converted with utils/port) and the same inputs.

Both packages cast where flax casts (convolution and dense inputs and
weights to bfloat16, the bias added in bfloat16, BatchNorm and the
instance norms in float32, the logits, softmax, tanh and heads in
float32), so they differ only where a bfloat16 rounding of a float32 sum
falls the other way: the two sum a convolution's products in different
orders, and one output in 5,000-10,000 of a single convolution rounds to
the neighbouring bfloat16 (measured at the semantic and derenderer
shapes).  Such a flip moves a value by one bfloat16 step (2^-8 of it) and
travels on through the layers after it.  Stated tolerances, each about
twice the measured difference:
  * the GlobalGenerator and Encoder (instance norms renormalise each
    layer): NET_ATOL 1e-5 (measured 4.8e-7);
  * the derenderer heads after 20 bfloat16 layers of ResNet-18:
    HEAD_ATOL 1.5e-2 (measured up to 6.1e-3 on the FFD coefficients,
    1.6e-3 on the rest);
  * the semantic probabilities after ResNet-50 + PPM: PROB_ATOL 2e-3
    (measured 7.5e-4); a label may differ only where JAX's top two
    probabilities lie within 2 * PROB_ATOL.
Each test also checks that the compute dtype was applied: the port's
bfloat16 outputs lie nearer JAX's bfloat16 outputs than the port's own
float32 outputs do (bfloat16 moves the generator's by 3.2e-2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models import derenderer as JD
from sdn3d_tpu.models import pix2pixhd as JX
from sdn3d_tpu.models import semantic as JS
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.models import pix2pixhd as TX
from sdn3d_tpu_torch.models import semantic as TS
from sdn3d_tpu_torch.models.layers import Conv2d, as_dtype
from sdn3d_tpu_torch.utils import port

NET_ATOL = 1e-5
HEAD_ATOL = 1.5e-2
PROB_ATOL = 2e-3
BF16 = jnp.bfloat16


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def test_textural_nets_bf16_match_jax():
    """GlobalGenerator (ngf 8, 2 down-samplings, 2 blocks, 48 channels) and
    Encoder (nef 4, 2 down-samplings) in bfloat16 at 32x48: within
    NET_ATOL of JAX's, float32 outputs, and far from the float32 nets."""
    rng = np.random.RandomState(0)
    pg = _tree(JX.GlobalGenerator(3, 8, 2, 2).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 48, 48)))["params"])
    pe = _tree(JX.Encoder(5, 4, 2).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 48, 3)))["params"])
    g_sd = port.global_generator_state_dict_from_jax(pg, 2, 2)
    e_sd = port.encoder_state_dict_from_jax(pe, 2)
    cases = [(JX.GlobalGenerator(3, 8, 2, 2, dtype=BF16), pg,
              lambda dt: TX.GlobalGenerator(48, 3, 8, 2, 2, dtype=dt), g_sd,
              rng.normal(0, 1, (2, 32, 48, 48))),
             (JX.Encoder(5, 4, 2, dtype=BF16), pe,
              lambda dt: TX.Encoder(3, 5, 4, 2, dtype=dt), e_sd,
              rng.uniform(-1, 1, (2, 32, 48, 3)))]
    for jnet, params, make, sd, x in cases:
        x = torch.from_numpy(x.astype(np.float32))
        want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
        outs = []
        for dt in ("bfloat16", "float32"):
            net = make(dt)
            net.load_state_dict(sd)
            with torch.no_grad():
                outs.append(net.eval()(x.permute(0, 3, 1, 2)))
        got, got32 = (o.permute(0, 2, 3, 1).numpy() for o in outs)
        assert outs[0].dtype == torch.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)
        assert np.abs(got32 - want).max() > 100 * NET_ATOL


def test_derenderer_bf16_matches_jax():
    """Derenderer(dtype bfloat16): the ResNet-18 trunk and its fc in
    bfloat16, the heads float32; within HEAD_ATOL of JAX's."""
    rng = np.random.RandomState(1)
    v = _tree(JD.Derenderer(num_classes=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)),
        jnp.zeros((1, 2)), train=False))
    tm = TD.Derenderer(num_classes=2, dtype="bfloat16")
    tm.load_state_dict(port.derenderer_state_dict_from_jax(v))
    assert tm.net.conv1.compute_dtype == torch.bfloat16
    assert tm.fc1.weight.dtype == torch.float32
    images = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    mroi = rng.uniform(-0.2, 0.2, (3, 2)).astype(np.float32)
    droi = rng.uniform(0.1, 0.3, (3, 2)).astype(np.float32)
    args = (images, mroi, droi)
    want = JD.Derenderer(num_classes=2, dtype=BF16).apply(
        v, *map(jnp.asarray, args), train=False)
    tm32 = TD.Derenderer(num_classes=2)
    tm32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, args))
        got32 = tm32.eval()(*map(torch.from_numpy, args))
    near, far = [], []
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=k)
        near.append(np.abs(got[k].numpy() - np.asarray(want[k])).mean())
        far.append(np.abs(got32[k].numpy() - np.asarray(want[k])).mean())
    assert np.mean(near) < np.mean(far)


def test_semantic_bf16_matches_jax():
    """SemanticModel(dtype bfloat16) at full width on a 48x64 input: the
    probabilities within PROB_ATOL of JAX's bfloat16 model, labels equal
    but at near-ties; the convolutions compute in bfloat16, BatchNorm
    returns float32, the probabilities are float32."""
    rng = np.random.RandomState(2)
    v = _tree(JS.SemanticModel(num_class=14).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    tm = TS.SemanticModel(num_class=14, dtype="bfloat16")
    enc, dec = port.semantic_state_dicts_from_jax(v)
    tm.encoder.load_state_dict(enc)
    tm.decoder.load_state_dict(dec)
    tm.eval()
    convs = [m for m in tm.modules() if isinstance(m, Conv2d)]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)
    with torch.no_grad():
        y = tm.encoder.bn1(tm.encoder.conv1(torch.zeros(1, 3, 8, 8)))
    assert y.dtype == torch.float32
    img = rng.normal(0, 1, (1, 48, 64, 3)).astype(np.float32)
    want = np.asarray(JS.SemanticModel(num_class=14, dtype=BF16).apply(
        v, jnp.asarray(img), seg_size=(48, 64), train=False))
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    tm32 = TS.SemanticModel(num_class=14)
    tm32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = tm(x, seg_size=(48, 64))
        got32 = tm32.eval()(x, seg_size=(48, 64)).permute(0, 2, 3, 1).numpy()
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    print(f"semantic bf16 probs max |diff| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    assert np.abs(got - want).mean() < np.abs(got32 - want).mean()
    flips = got.argmax(-1) != want.argmax(-1)
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert ((top2[..., 1] - top2[..., 0])[flips] <= 2 * PROB_ATOL).all()


def test_compute_dtype_is_checked():
    """float32 and bfloat16 only, by name or torch dtype."""
    assert as_dtype("bfloat16") == as_dtype(torch.bfloat16) == torch.bfloat16
    for bad in ("float16", torch.float16):
        with pytest.raises(ValueError):
            as_dtype(bad)

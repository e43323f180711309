"""The port's ResNet builders (resnet18_feature, resnet101),
pad_to_multiple, and the two reference key layouts that no other port
test holds (the multiscale discriminator's and torchvision VGG19's),
against the JAX package.

Tolerances: the ResNets with weights converted from JAX, each output
(the fc features; C1..C5) within 1e-4 of its own largest entry: both are
float32 convolution stacks that sum in another order, and random weights
can grow resnet101's activations over its 33 bottlenecks, so the error is
stated relative to the output's scale (measured: at most 7.5e-7).
pad_to_multiple byte-equal.  The key-layout round trips bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models import pix2pixhd as JX
from sdn3d_tpu.models import resnet as JR
from sdn3d_tpu.models import vgg as JV
from sdn3d_tpu.pipelines.semantic import pad_to_multiple as j_pad
from sdn3d_tpu.utils.port import port_multiscale_discriminator, port_vgg19
from sdn3d_tpu_torch.models import pix2pixhd as TX
from sdn3d_tpu_torch.models import resnet as TR
from sdn3d_tpu_torch.models import vgg as TV
from sdn3d_tpu_torch.pipelines.semantic import pad_to_multiple as t_pad
from sdn3d_tpu_torch.utils import port as TPORT

REL_TOL = 1e-4


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _randomised(variables, seed):
    """The init's variables with random BatchNorm scales, biases and
    running statistics, so that a swapped or dropped key shows."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "'mean'" in name or "'bias'" in name:
            return (rng.randn(*x.shape) * 0.1).astype(x.dtype)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _close_rel(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    got = got.detach().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= REL_TOL * scale, \
        f"{what}: max |diff| {err} of scale {scale}"


def _trunk_state_dict(variables, stage_sizes, n_convs, prefix_p=None):
    P, S = variables["params"], variables["batch_stats"]
    if prefix_p:
        P, S = P[prefix_p], S[prefix_p]
    sd = {}
    TPORT._resnet_trunk(sd, "", P, S, stage_sizes, n_convs=n_convs,
                        deep_stem=False)
    return sd


def test_resnet18_feature_matches_jax():
    """resnet18_feature(num_outputs) with JAX's weights in the derenderer
    trunk's key layout (conv1, bn1, layerI.J.*, fc)."""
    jm = JR.resnet18_feature(num_outputs=32)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    variables = _randomised(_np_tree(jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x))), 1)
    want = jm.apply(variables, jnp.asarray(x))
    sd = _trunk_state_dict(variables, (2, 2, 2, 2), 2, "trunk")
    TPORT._linear(sd, "fc", variables["params"]["fc"])
    tm = TR.resnet18_feature(num_outputs=32)
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    _close_rel(got, want, "resnet18_feature")


def test_resnet101_matches_jax():
    """resnet101() (Bottleneck (3, 4, 23, 3), torchvision-style names)
    with JAX's weights: C1..C5 at 1 x 32 x 32."""
    jm = JR.resnet101()
    x = np.random.RandomState(2).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32)
    variables = _randomised(_np_tree(jm.init(jax.random.PRNGKey(1),
                                             jnp.asarray(x))), 3)
    want = jm.apply(variables, jnp.asarray(x))
    sd = _trunk_state_dict(variables, (3, 4, 23, 3), 3)
    tm = TR.resnet101()
    assert sorted(sd) == sorted(tm.state_dict())
    assert "layer3.22.conv3.weight" in sd
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for k, (g, w) in enumerate(zip(got, want)):
        _close_rel(g, w, f"C{k + 1}")


@pytest.mark.parametrize("shape", [(375, 1242, 3), (64, 64, 3), (13, 7),
                                   (9, 17, 1)])
@pytest.mark.parametrize("multiple", [8, 32])
def test_pad_to_multiple_matches_jax(shape, multiple):
    image = np.random.RandomState(4).randint(0, 255, shape).astype(np.uint8)
    got, want = t_pad(image, multiple), j_pad(image, multiple)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.shape[0] % multiple == 0 and got.shape[1] % multiple == 0
    assert got.tobytes() == want.tobytes()


def _assert_same_tree(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, x), (_, y) in zip(flat_a, flat_b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _same_state_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_discriminator_layout_round_trips_through_port():
    """port_multiscale_discriminator(discriminator_state_dict_from_jax(v))
    gives back v bit for bit at the full width (2 scales, ndf 64, 3
    layers), and a reference-layout state_dict (the port's D's own)
    survives JAX's reader and back: a reference D checkpoint loads into
    the port with load_state_dict."""
    nc = 18
    jd = JX.MultiscaleDiscriminator(64, 3, 2)
    v = _np_tree(jd.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, nc))))
    sd = TPORT.discriminator_state_dict_from_jax(v["params"])
    _assert_same_tree(v, port_multiscale_discriminator(sd, num_D=2,
                                                       n_layers=3))
    td = TX.MultiscaleDiscriminator(nc, 64, 3, 2)
    td.load_state_dict(sd)
    ref = {k: t.clone() for k, t in td.state_dict().items()}
    back = TPORT.discriminator_state_dict_from_jax(
        port_multiscale_discriminator(ref, num_D=2, n_layers=3)["params"])
    _same_state_dict(back, ref)


def test_vgg19_layout_round_trips_through_port():
    """port_vgg19(vgg19_state_dict_from_jax(v)) gives back v bit for bit,
    and torchvision's features.N layout of the port's Vgg19Features
    survives JAX's reader and back."""
    v = _np_tree(JV.Vgg19Features().init(jax.random.PRNGKey(6),
                                         jnp.zeros((1, 16, 16, 3))))
    sd = TPORT.vgg19_state_dict_from_jax(v)
    _assert_same_tree(v, port_vgg19(sd))
    tv = TV.Vgg19Features()
    tv.load_state_dict(sd)
    ref = {k: t.clone() for k, t in tv.state_dict().items()}
    _same_state_dict(TPORT.vgg19_state_dict_from_jax(port_vgg19(ref)), ref)

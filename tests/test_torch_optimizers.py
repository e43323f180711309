"""The port's sparse Adam (sdn3d_tpu_torch.core.optimizers) against the JAX
package's `sparse_adam` / `scale_by_sparse_adam` on the same numpy
parameters and gradients: the cases of tests/test_optimizers.py, and the
state converter of utils/port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_optimizers import chainer_adam_oracle
from sdn3d_tpu.core import optimizers as JO
from sdn3d_tpu_torch.core import optimizers as TO
from sdn3d_tpu_torch.utils.port import sparse_adam_state_from_jax

# Parameters and moments against JAX's, each step: the same elementwise
# arithmetic; the bias correction's float32 pow may round 1 ulp apart
# between XLA and torch, so within 4 ulp of the values.
ULP = 4


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close(got, want, what=""):
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: x.numpy(), got))
    flat_w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                              want))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=ULP * float(np.spacing(np.abs(w).max())),
            err_msg=what)


def _run(params, grads_seq, lr, lr_scales=None):
    """Both optimizers over the gradient sequence; checks params and
    moments after every step.  Returns the port's (params, state)."""
    tx = JO.sparse_adam(lr, lr_scales=lr_scales)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    tp = _t(params)
    ts = TO.sparse_adam_init(tp)
    for i, g in enumerate(grads_seq):
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tp, ts = TO.sparse_adam_step(tp, _t(g), ts, lr, lr_scales=lr_scales)
        _close(tp, jp, f"params, step {i}")
        _close(ts.mu, js[0].mu, f"mu, step {i}")
        _close(ts.nu, js[0].nu, f"nu, step {i}")
        assert ts.count == int(js[0].count) == i + 1
    return tp, ts, js


def test_sparse_adam_matches_jax_and_the_chainer_oracle():
    """Five steps with exact zeros sprinkled: the port equals JAX within
    ULP each step, and the chainer oracle within its test's bound."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(5)]
    for g in grads:
        g[rng.rand(4, 5) < 0.4] = 0.0
    tp, _, _ = _run({"w": p0}, [{"w": g} for g in grads], 1e-2)
    np.testing.assert_allclose(tp["w"].numpy(),
                               chainer_adam_oracle(p0, grads, 1e-2),
                               rtol=1e-5, atol=1e-6)


def test_zero_grad_elements_untouched():
    """A zero-gradient element keeps its value and its moments (zero from
    init, and nonzero ones frozen on a later step)."""
    p0 = {"w": np.ones(8, np.float32)}
    g1 = np.asarray([0.0, 1.0, 0.0, -2.0, 0.0, 0.0, 3.0, 0.0], np.float32)
    g2 = np.asarray([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.5], np.float32)
    _, ts1, _ = _run(p0, [{"w": g1}], 0.1)
    tp, ts, _ = _run(p0, [{"w": g1}, {"w": g2}], 0.1)
    for i in range(8):
        if g1[i] == 0 and g2[i] == 0:
            assert float(tp["w"][i]) == 1.0
            assert float(ts.mu["w"][i]) == 0.0 == float(ts.nu["w"][i])
        if g2[i] == 0 and g1[i] != 0:
            assert float(ts.mu["w"][i]) == float(ts1.mu["w"][i])
            assert float(ts.nu["w"][i]) == float(ts1.nu["w"][i])


def test_per_parameter_lr_scales():
    rng = np.random.RandomState(1)
    p0 = {"w": rng.randn(3, 3).astype(np.float32)}
    g = {"w": rng.randn(3, 3).astype(np.float32)}
    _run(p0, [g, g], 1e-2, lr_scales={"w": 0.5})


@pytest.mark.parametrize("scales", [{"enc": 0.1, "dec": 1.0},
                                    {"enc": {"k": 0.1, "b": 0.3},
                                     "dec": 2.0}])
def test_lr_scales_prefix_tree(scales):
    """A prefix leaf scales its whole subtree (param.lr on a module), as
    JAX's prefix tree does (tests/test_optimizers.py:90); a full tree
    too."""
    rng = np.random.RandomState(2)
    params = {"enc": {"k": rng.randn(2, 2).astype(np.float32),
                      "b": rng.randn(2).astype(np.float32)},
              "dec": {"k": rng.randn(2, 2).astype(np.float32)}}
    ones = jax.tree_util.tree_map(np.ones_like, params)
    grads = [ones, jax.tree_util.tree_map(lambda a: -0.5 * a, ones)]
    tp, _, _ = _run(params, grads, 1e-2, lr_scales=scales)
    if scales["dec"] == 1.0:
        d_enc = tp["enc"]["k"].numpy() - params["enc"]["k"]
        d_dec = tp["dec"]["k"].numpy() - params["dec"]["k"]
        # differences of parameters near 1: their rounding is 1e-7 of
        # steps of 1e-3
        np.testing.assert_allclose(d_enc, 0.1 * d_dec, rtol=1e-3)


def test_step_count_and_frozen_moments():
    """The global count (chainer's t) and moments that stay zero without
    a gradient, against scale_by_sparse_adam's."""
    tx = JO.scale_by_sparse_adam()
    p = {"w": jnp.zeros((4,))}
    js = tx.init(p)
    ts = TO.sparse_adam_init(_t({"w": np.zeros(4, np.float32)}))
    for g in ([1.0, 0.0, 1.0, 0.0], [1.0, 1.0, 0.0, 0.0]):
        g = np.asarray(g, np.float32)
        ju, js = tx.update({"w": jnp.asarray(g)}, js, p)
        tu, ts = TO.scale_by_sparse_adam(_t({"w": g}), ts)
        _close(tu, ju, "updates")
    assert ts.count == int(js.count) == 2
    assert float(ts.mu["w"][3]) == 0.0 == float(ts.nu["w"][3])


def test_state_converter_continues_jax_steps():
    """JAX's state after two steps, converted, continues in the port as
    JAX continues."""
    rng = np.random.RandomState(3)
    params = {"a": {"w": rng.randn(3, 2).astype(np.float32)},
              "b": rng.randn(5).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * (rng.rand(*p.shape) > 0.3)
                   ).astype(np.float32), params) for _ in range(3)]
    tx = JO.sparse_adam(3e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    for g in grads[:2]:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
    ts = sparse_adam_state_from_jax(js)
    assert ts.count == 2
    tp = _t(jax.tree_util.tree_map(np.asarray, jp))
    upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, grads[2]), js, jp)
    jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
    tp, ts = TO.sparse_adam_step(tp, _t(grads[2]), ts, 3e-3)
    _close(tp, jp, "params")
    _close(ts.mu, js[0].mu, "mu")
    with pytest.raises(ValueError):
        sparse_adam_state_from_jax((1, 2))

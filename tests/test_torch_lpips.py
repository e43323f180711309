"""The port's LPIPS (sdn3d_tpu_torch.models.lpips, utils.metrics) against
the JAX package's, on the CPU: JAX's random-init variables converted with
utils/port.lpips_state_dict_from_jax, and an official-layout checkpoint
read by both packages' load_lpips.  The distances are sums of float32
VGG16 convolutions summed in different orders: rtol 1e-4 (measured under
1e-5)."""

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.models.lpips import init_lpips as j_init, lpips as j_lpips
from sdn3d_tpu.utils import metrics as JM
from sdn3d_tpu_torch.models.lpips import LPIPS, init_lpips, lpips
from sdn3d_tpu_torch.utils import metrics as TM
from sdn3d_tpu_torch.utils.port import lpips_state_dict_from_jax

RTOL = 1e-4


def _images(seed, n=2, h=64, w=96):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
            for _ in range(2)]


def test_lpips_matches_jax_with_converted_params():
    """JAX's init_lpips(PRNGKey(3)) carried across: the same distance per
    item; zero on identical inputs; symmetric."""
    variables = jax.tree_util.tree_map(np.asarray, j_init(
        jax.random.PRNGKey(3)))
    model = LPIPS()
    model.load_state_dict(lpips_state_dict_from_jax(variables))
    model.eval()
    x, y = _images(0)
    want = np.asarray(j_lpips(variables, x, y))
    got = lpips(model, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert float(lpips(model, torch.from_numpy(x),
                       torch.from_numpy(x)).abs().max()) < 1e-6
    np.testing.assert_allclose(
        lpips(model, torch.from_numpy(y), torch.from_numpy(x)).numpy(), got,
        rtol=1e-5)


def test_load_lpips_reads_the_official_layout_as_jax_does(tmp_path):
    """An official-`lpips`-layout state dict (net.slice{s}.{i}.*,
    lin{k}.model.1.weight, scaling_layer.*) written with torch.save: the
    port's metrics.load_lpips and the JAX package's metrics.load_lpips of
    the same file give the same metric on uint8 images; the random-init
    default (no checkpoint) is a different, deterministic metric."""
    sd = init_lpips(7, "cpu").state_dict()
    gen = torch.Generator().manual_seed(1)
    for k in range(5):
        w = sd[f"lin{k}.model.1.weight"]
        sd[f"lin{k}.model.1.weight"] = torch.rand(w.shape, generator=gen)
    assert any(k.startswith("net.slice5.28.") for k in sd)
    assert "scaling_layer.shift" in sd
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    tmodel = TM.load_lpips(path, device="cpu")
    jvars = JM.load_lpips(path)
    rng = np.random.RandomState(4)
    a = rng.randint(0, 256, (48, 160, 3)).astype(np.uint8)
    b = np.clip(a + rng.randn(48, 160, 3) * 25, 0, 255).astype(np.uint8)
    got = TM.lpips(a, b, model=tmodel)
    want = JM.lpips(a, b, variables=jvars)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert TM.lpips(a, a, model=tmodel) == 0.0
    default = TM.lpips(a, b, device="cpu")
    assert np.isfinite(default) and default != got
    assert TM.lpips(a, b, device="cpu") == default
    del sd["lin2.model.1.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="lin2.model.1.weight"):
        TM.load_lpips(path, device="cpu")

"""The port's l2 and dssim (sdn3d_tpu_torch.utils.metrics) against the
JAX package's on the same seeded images.  Both sides are the same numpy
arithmetic, so they agree within 1e-12 (in fact exactly)."""

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.utils import metrics as JM
from sdn3d_tpu_torch.utils import metrics as TM

TOL = 1e-12


def _pair(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, shape).astype(dtype)
    b = np.clip(a + rng.randint(-40, 41, shape), 0, 255).astype(dtype)
    return a, b


@pytest.mark.parametrize("shape,dtype", [((48, 64, 3), np.uint8),
                                         ((32, 40, 3), np.float64),
                                         ((24, 24), np.float32)])
@pytest.mark.parametrize("value_range", [255.0, 1.0])
def test_l2_and_dssim_match_jax(shape, dtype, value_range):
    a, b = _pair(0, shape, dtype)
    if value_range == 1.0:
        a, b = a / 255.0, b / 255.0
    for fn in ("l2", "dssim"):
        got = getattr(TM, fn)(a, b, value_range=value_range)
        want = getattr(JM, fn)(a, b, value_range=value_range)
        assert isinstance(got, float)
        assert abs(got - want) <= TOL, (fn, got, want)
    assert TM.l2(a, a, value_range) == 0.0 and TM.dssim(a, a,
                                                        value_range) == 0.0
    assert 0.0 < TM.dssim(a, b, value_range) < 0.5

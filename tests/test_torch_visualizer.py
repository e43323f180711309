"""The port's display_instances and plot_loss (sdn3d_tpu_torch.utils.
visualizer) and its trace scope (utils.profiling.trace), against the JAX
package's where both compute something: display_instances byte-equal on
the same seeded image, boxes and masks."""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.utils import visualizer as JV
from sdn3d_tpu_torch.utils import visualizer as TV
from sdn3d_tpu_torch.utils.profiling import trace


def _instances(seed, n, mask_dims):
    rng = np.random.RandomState(seed)
    H, W = 60, 90
    image = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    y1 = rng.randint(-5, H - 10, n)
    x1 = rng.randint(-5, W - 10, n)
    boxes = np.stack([y1, x1, y1 + rng.randint(5, 40, n),
                      x1 + rng.randint(5, 60, n)], 1).astype(np.float32)
    masks = rng.uniform(0, 1, (n, 1, H, W) if mask_dims == 4 else (n, H, W))
    return image, boxes, masks.astype(np.float32), rng.randint(1, 3, n)


@pytest.mark.parametrize("n,mask_dims,alpha", [(0, 3, 0.5), (3, 3, 0.5),
                                               (9, 4, 0.3)])
def test_display_instances_matches_jax(n, mask_dims, alpha):
    image, boxes, masks, ids = _instances(n, n, mask_dims)
    names = ["BG", "car", "van"]
    got = TV.display_instances(image, boxes, masks, ids, names, alpha=alpha)
    want = JV.display_instances(image, boxes, masks, ids, names,
                                alpha=alpha)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if n:
        assert not np.array_equal(got, image)


def test_plot_loss_writes_a_png(tmp_path):
    records = [{"step": i, "loss": 1.0 / (i + 1), "acc": 0.1 * i,
                "tag": "x"} for i in range(6)]
    out = TV.plot_loss(records, str(tmp_path / "loss.png"))
    assert out == str(tmp_path / "loss.png")
    with open(out, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    TV.plot_loss(records, str(tmp_path / "acc.png"), keys=["acc"])
    assert os.path.getsize(tmp_path / "acc.png") > 0


def test_trace_none_is_a_no_op(tmp_path):
    with trace(None):
        x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "tr"
    with trace(str(log_dir)):
        torch.randn(64, 64).matmul(torch.randn(64, 64))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

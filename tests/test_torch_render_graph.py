"""The geometric re-render's packed inputs and its runner
(sdn3d_tpu_torch.pipelines.derender_infer._packed_inputs / _input_views /
_render_chunk) on the CPU, at the small shapes of
tests/test_torch_derender_infer.py: the one upload gives the tensors the
per-key uploads gave, and off the card the runner is the eager function,
bit for bit.  The CUDA graph itself is held on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
from sdn3d_tpu_torch.ops.pil_resize import transform_plan
from sdn3d_tpu_torch.pipelines import derender_infer as TI
from sdn3d_tpu_torch.utils import phases
from sdn3d_tpu_torch.utils.transfer import to_device

CPU = torch.device("cpu")


def _per_key_uploads(per):
    """The uploads derender_render_begin made before the packed buffer:
    one `to_device` of each stacked blob key, interests and obj_valid."""
    up = lambda arrays: to_device(  # noqa: E731
        np.stack([np.asarray(a) for a in arrays]), CPU)
    blob = {k: up([p[1][k] for p in per]) for k in sorted(per[0][1])}
    return blob, up([p[2] for p in per]), up([p[0]["valid"] for p in per])


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("n_frames", [1, 2])
def test_packed_upload_gives_the_per_key_uploads(n_frames):
    """Every dtype a blob can hold (float32 and float64, int32 and int64,
    uint8, bool, and a key of no elements), then interests (uint8) and
    obj_valid (bool): the views of the one buffer are the per-key tensors,
    dtype, shape and bytes, each view aligned for its dtype."""
    rng = np.random.RandomState(n_frames)
    M = 3
    per = []
    for _ in range(n_frames):
        blob = {
            "_f32": rng.normal(size=(M, 5)).astype(np.float32),
            "_f64": rng.normal(size=(M, 1)),
            "_i32": rng.randint(-9, 9, (M, 3)).astype(np.int32),
            "_i64": rng.randint(-9, 9, (M,)).astype(np.int64),
            "_u8": rng.randint(0, 255, (M, 2, 3)).astype(np.uint8),
            "_bool": rng.rand(M, 7) > 0.5,
            "_empty": np.zeros((M, 0), np.float32),
            "_tensor": torch.from_numpy(
                rng.normal(size=(M, 2)).astype(np.float32)),
        }
        objs = {"valid": np.asarray([True, True, False])}
        per.append((objs, blob, rng.randint(0, 2, M).astype(np.uint8)))
    host, layout = TI._packed_inputs(per)
    assert host.dtype == np.uint8 and host.ndim == 1
    assert all(off % 16 == 0 for *_, off in layout)
    blob, interests, valid = TI._input_views(to_device(host, CPU), layout)
    want_blob, want_interests, want_valid = _per_key_uploads(per)
    assert list(blob) == list(want_blob)
    for k in want_blob:
        _assert_same(blob[k], want_blob[k])
    _assert_same(interests, want_interests)
    _assert_same(valid, want_valid)
    assert interests.dtype == torch.uint8 and valid.dtype == torch.bool


@pytest.fixture(scope="module")
def scene():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Derenderer(num_classes=2).eval()
    bank = DeviceMeshBank.from_host(
        build_mesh_bank([make_sphere_mesh(4, 8)] * 2), device="cpu")
    cfg = TI.DerenderInferConfig(image_size=64, render_size=64,
                                 max_objects=4)
    rng = np.random.RandomState(0)
    frames = []
    for k in range(2):
        image = (rng.rand(96, 160, 3) * 255).astype(np.uint8)
        rois = np.asarray([[20, 30 + k, 60, 80], [40, 90, 85, 150 - k]],
                          np.float32)
        masks = np.zeros((2, 1, 96, 160), np.float32)
        for i, r in enumerate(rois.astype(int)):
            masks[i, 0, r[0] + 5:r[2] - 5, r[1] + 5:r[3] - 5] = 1
        class_ids = np.asarray([1, 2])
        objs, blob = TI.derender_encode(model, image, class_ids, masks, rois,
                                        cfg, device="cpu")
        ops = [{"type": "modify",
                "from": {"u": str((rois[1, 1] + rois[1, 3]) / 2),
                         "v": str((rois[1, 0] + rois[1, 2]) / 2)},
                "to": {}, "zoom": "1.5", "ry": "0.3"}] if k else None
        blob_t, interests = TI._edited_blob(objs, blob, ops)
        frames.append((objs, blob_t, interests))
    return bank, cfg, frames


@pytest.mark.parametrize("small", [False, True], ids=["file", "small"])
@pytest.mark.parametrize("n_frames", [1, 2])
def test_cpu_runner_is_the_eager_render(scene, n_frames, small):
    """Off the card `_render_chunk` runs `_render_composite_batch` on the
    packed buffer's views: every output, the render dict, the maps and the
    packed buffers, equals the eager function's on the per-key uploads bit
    for bit; no graph is made and no graph counter counts."""
    bank, cfg, frames = scene
    per = frames[:n_frames]
    plan = transform_plan((160, 96), 80, (80, 40)) if small else None
    host, layout = TI._packed_inputs(per)
    graphs = dict(TI._GRAPHS)
    phases.reset(True)
    try:
        got = TI._render_chunk(to_device(host, CPU), layout, bank, cfg, 96,
                               160, small=plan)
        counted = phases.snapshot()
    finally:
        phases.reset(False)
    blob, interests, valid = _per_key_uploads(per)
    want = TI._render_composite_batch(blob, bank, interests, valid, cfg, 96,
                                      160, small=plan)
    assert TI._GRAPHS == graphs
    assert not [k for k in counted if k.startswith("count.render_graph")]
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        _assert_same(got[0][k], want[0][k])
    for g, w in zip(got[1:4], want[1:4]):
        assert len(g) == len(w) == n_frames
        for a, b in zip(g, w):
            _assert_same(a, b)
    _assert_same(got[4], want[4])
    assert (got[1][0] > 0).any()

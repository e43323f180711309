"""The kernels' counted bytes at the serving shape (16 slots of 39,600
faces at 768^2) are the bring-up script's (PERF.md, the kernels table),
B1's in a training step's silhouette render without the colours,
and the reference's boxed rasterizer equals the port's plain one."""

import pytest
import torch

from perfbench.kernels import counts

B, F, S = 16, 39_600, 768


# with the normal colours of a serving render, and without them in a
# training step's silhouette render (37 B a face read, 8 B a pixel written)
@pytest.mark.parametrize("colours,nbytes", [(True, 219_790_080),
                                            (False, 98_940_672)])
def test_b1_bytes(colours, nbytes):
    assert counts.b1_bytes(B, F, S, colours=colours) == nbytes


def test_b3_bytes():
    assert counts.b3_bytes(B, F, S) == 354_945_024


def test_b2_bytes():
    # 4,684,795 won pixels in the bring-up script's refine backward
    assert counts.b2_bytes(B, F, S, 4_684_795) == 165_390_216


def test_peaks_by_prefix():
    assert counts.peaks_for("NVIDIA H100 80GB HBM3")["float32"] == 67e12
    assert counts.peaks_for("NVIDIA H100 80GB HBM3 (MIG)") is not None
    assert counts.peaks_for("NVIDIA A100") is None


def test_bound_is_the_larger():
    p = {"hbm": 1.0, "float32": 10.0}
    assert counts.bound_s(5.0, 10.0, p) == 5.0
    assert counts.bound_s(5.0, 100.0, p) == 10.0


def _faces(g, b, f):
    faces = torch.rand(b, f, 3, 3, generator=g) * 2 - 1
    faces[..., 2] = torch.rand(b, f, 3, generator=g) * 5 + 0.5
    faces[:, : f // 10] = faces[:, f // 10: 2 * (f // 10)]   # depth ties
    return faces


def test_box_pairs_count_each_face_box():
    faces = torch.tensor([[[[-1.0, -1.0, 1.0], [1.0, -1.0, 1.0],
                            [-1.0, 1.0, 1.0]]]])
    ok = torch.ones(1, 1, dtype=torch.bool)
    assert counts.face_box_pairs(faces, ok, 8) == 64


def test_boxed_rasterizer_equals_plain():
    from perfbench.reference.frozen.ops import rasterize as R
    from perfbench.reference.frozen.ops import rasterize_cuda as RC
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        faces = _faces(g, 2, 200)
        valid = torch.rand(2, 200, generator=g) > 0.1
        want = R.rasterize_face_maps(faces, valid, 40)
        got = RC.rasterize_face_maps_boxed(faces, valid, 40, pair_budget=501)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_boxed_rasterizer_equals_the_port():
    from perfbench.reference.frozen.ops import rasterize_cuda as RC
    from sdn3d_tpu_torch.ops import rasterize as PR
    g = torch.Generator().manual_seed(4)
    faces = _faces(g, 3, 150)
    want = PR.rasterize_face_maps(faces, None, 32)
    got = RC.rasterize_face_maps_boxed(faces, None, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

"""The port's CUDA kernels (forward rasterizer, silhouette walk,
pixel->face reduction) against their plain PyTorch versions, on the card.
Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.ops import rasterize_cuda as TC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _faces(seed, batch, num_faces):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1.2, 1.2, size=(batch, num_faces, 3, 2))
    z = rng.uniform(1.5, 6.0, size=(batch, num_faces, 3, 1))
    faces = np.concatenate([xy, z], axis=-1).astype(np.float32)
    faces[:, 3] = faces[:, 1]                 # exact depth tie
    faces[:, 4] = faces[:, 4, ::-1]           # back-face
    valid = np.ones((batch, num_faces), bool)
    valid[:, 2] = False
    colors = rng.uniform(-1, 1, (batch, num_faces, 3)).astype(np.float32)
    return faces, valid, colors


def _sliver(faces, isz):
    """Face 6 of every image becomes a front-facing, non-degenerate sliver
    across the image whose box is the whole image (its cross product's
    lower bound is <= 0), so that it lands on the wide list whenever the
    image has more than K = MAX_TILES tiles."""
    a = np.asarray([-0.9, -0.8], np.float32)
    c = np.asarray([0.9, 0.85], np.float32)
    whole = torch.tensor([0, isz - 1, 0, isz - 1], dtype=torch.int32)
    for off in (1e-7, 2e-7, 4e-7, 8e-7):
        m = (a + c) / 2 + np.float32(off)
        for tri in ((a, m, c), (a, c, m)):
            faces[:, 6, :, :2] = np.stack(tri)
            _, box = TC.pack_faces(torch.from_numpy(faces), None, isz)
            if (box[:, 6] == whole).all():
                return faces
    raise AssertionError("no whole-image sliver found")


@pytest.mark.cuda
@pytest.mark.parametrize("isz", [128, 100, 144, 136])
def test_rasterize_kernel_matches_plain(cuda, isz):
    """Face index, depth and colours bit-equal to the plain version on the
    same card, with an exact depth tie (faces 1 and 3), an invalid and a
    back face, and a whole-image sliver, which lands on the wide list from
    9 x 9 tiles (144^2, 136^2) on, while other faces fill the tile lists
    (100^2 and 136^2 have a ragged tile edge)."""
    faces, valid, colors = _faces(isz, 2, 37)
    faces = _sliver(faces, isz)
    faces, valid, colors = (torch.from_numpy(a).to(cuda)
                            for a in (faces, valid, colors))
    fi, depth, rgb = TC.rasterize_face_index_cuda(faces, valid, isz,
                                                  colors=colors)
    fi_p, depth_p = TR.rasterize_face_maps(faces, valid, isz)
    rgb_p = TR._gather_face_colors(fi_p, colors).permute(0, 3, 1, 2)
    bins = TC.bin_faces_cuda(TC.face_records(faces, valid, isz), isz)
    torch.cuda.synchronize()
    assert torch.equal(fi, fi_p)
    assert torch.equal(depth, depth_p)
    assert torch.equal(rgb, rgb_p)
    wide = [set(bins.wide_faces[b, :int(bins.wide_n[b])].tolist())
            for b in range(2)]
    assert all((6 in w) == (TC.tile_grid(isz) ** 2 > TC.MAX_TILES)
               for w in wide)
    assert int(bins.tile_off[:, -1].min()) > 0


def _as_sets(bins, num_faces):
    """(tile_off, per image the sorted list of each tile, the sorted wide
    list) of `Bins` on the host."""
    off = bins.tile_off.cpu()
    tf, wf, wn = (bins.tile_faces.cpu(), bins.wide_faces.cpu(),
                  bins.wide_n.cpu())
    lists = [[sorted(tf[b, off[b, t]:off[b, t + 1]].tolist())
              for t in range(off.shape[1] - 1)] for b in range(off.shape[0])]
    wide = [sorted(wf[b, :wn[b]].tolist()) for b in range(off.shape[0])]
    return off, lists, wide


@pytest.mark.cuda
@pytest.mark.parametrize("isz", [100, 144])
def test_bin_kernel_matches_plain(cuda, isz):
    """The bin kernels' boxes equal the PyTorch `face_boxes` (pack_faces)
    exactly, and their tile and wide lists, read as sets, equal
    `bin_faces_plain`'s (the kernel's list order depends on atomics)."""
    faces, valid, _ = _faces(isz + 5, 2, 37)
    faces = _sliver(faces, isz)
    rec, box = TC.pack_faces(torch.from_numpy(faces).to(cuda),
                             torch.from_numpy(valid).to(cuda), isz)
    got = TC.bin_faces_cuda(rec, isz)
    want = TC.bin_faces_plain(box, isz)
    torch.cuda.synchronize()
    assert torch.equal(got.box, box)
    off, lists, wide = _as_sets(got, 37)
    off_p, lists_p, wide_p = _as_sets(want, 37)
    assert torch.equal(off, off_p)
    assert lists == lists_p and wide == wide_p
    assert (sum(len(w) for w in wide) > 0) == (TC.tile_grid(isz) ** 2
                                               > TC.MAX_TILES)


def _backward_inputs(dev, isz, seed=0, batch=2, num_faces=37):
    """Random faces, their forward face index and alpha, a cotangent, and
    the walk's face table, on `dev`."""
    faces, valid, _ = (torch.from_numpy(a).to(dev)
                       for a in _faces(seed, batch, num_faces))
    fi, _ = TC.rasterize_face_index(faces, valid, isz)
    alpha = (fi >= 0).float()
    cot = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        batch, isz, isz).astype(np.float32)).to(dev)
    return faces, valid, fi, alpha, cot, TR.face_pixel_table(faces, isz)


@pytest.mark.cuda
@pytest.mark.parametrize("isz,walk", [(128, 24), (128, 128), (100, 64),
                                      (100, 100), (144, 64)])
def test_walk_kernel_matches_plain(cuda, isz, walk):
    """The fused walk kernel (invariants computed in the kernel) against
    its plain version (`edge_invariant_stack` + `walk_grads_plain`) on the
    same card inputs, both axes of one launch: bit-equal (the same IEEE
    operations in the same order, built with -fmad=false).  Windows up to
    64 run staged in shared memory, longer ones read global memory; 100^2
    and 144^2 have ragged tiles."""
    _, _, fi, alpha, cot, pp = _backward_inputs(cuda, isz, seed=isz + walk)
    eps = TR.DEFAULT_EPS
    both = TC.walk_grads_cuda(alpha, cot, pp, fi, walk, eps)
    for axis in (0, 1):
        want = TR.walk_grads_faces_plain(alpha, cot, pp, fi, walk, eps, axis)
        torch.cuda.synchronize()
        assert want.abs().max() > 0
        assert torch.equal(both[axis], want), (
            axis, (both[axis] - want).abs().max())


@pytest.mark.cuda
def test_walk_kernel_all_background(cuda):
    """An image without a face (every pixel background, alpha and
    cotangent still random): every accumulator is +0.0 in the kernel and
    in the plain version."""
    _, _, fi, _, cot, pp = _backward_inputs(cuda, 96, seed=11)
    fi = torch.full_like(fi, -1)
    alpha = (torch.rand(fi.shape, generator=torch.Generator().manual_seed(0))
             > 0.5).float().to(cuda)
    both = TC.walk_grads_cuda(alpha, cot, pp, fi, 64, TR.DEFAULT_EPS)
    for axis in (0, 1):
        got = both[axis]
        want = TR.walk_grads_faces_plain(alpha, cot, pp, fi, 64,
                                         TR.DEFAULT_EPS, axis)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and not got.signbit().any()
        assert (got == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("isz", [128, 100])
def test_reduction_kernel_matches_float64(cuda, isz):
    """The reduction kernels against a float64 segment sum of the same
    planes: |err| <= 1e-5 * sum of |terms| per face (float32 sums of up to
    a few hundred terms per lane), and bit-equal across two launches; the
    box pass equals the plain `won_pixel_boxes` exactly."""
    faces, valid, fi, _, _, _ = _backward_inputs(cuda, isz, seed=isz)
    B, F = faces.shape[:2]
    rng = np.random.RandomState(7)
    acc_x, acc_y = (torch.from_numpy(rng.randn(B, 3, isz, isz)
                                     .astype(np.float32)).to(cuda)
                    for _ in range(2))
    box = TC.won_pixel_boxes_cuda(fi, F)
    got = TC.segment_face_grads_cuda(acc_x, acc_y, fi, F)
    again = TC.segment_face_grads_cuda(acc_x, acc_y, fi, F)
    # the plain version in float64, and the sums of |terms| per face
    ref = TR.segment_face_grads_plain(acc_x.double(), acc_y.double(), fi, F)
    mag = TR.segment_face_grads_plain(acc_x.double().abs(),
                                      acc_y.double().abs(), fi, F).abs()
    torch.cuda.synchronize()
    assert torch.equal(box, TR.won_pixel_boxes(fi, F))
    assert torch.equal(got, again)
    assert ref.abs().max() > 0
    assert ((got.double() - ref).abs() <= 1e-5 * mag + 1e-30).all()


@pytest.mark.cuda
def test_silhouette_vjp_kernels_match_plain(cuda):
    """The silhouette VJP through the kernels against the plain versions
    composed the same way on the same card: face gradients to 1e-5 of
    the largest (the walks agree bit for bit; the reduction sums in
    another order)."""
    faces, valid, fi, alpha, cot, pp = _backward_inputs(cuda, 128, seed=3)
    launches = (TC.walk_grads_cuda.launches,
                TC.segment_face_grads_cuda.launches)
    stacks = (TR.edge_invariant_stack.calls, TR.face_pixel_coords.calls)
    got = TR.silhouette_grad_pixelwise(faces, fi, alpha, cot, 128,
                                       TR.DEFAULT_EPS, walk=24)[..., :2]
    # the card path builds no invariant stack
    assert (TR.edge_invariant_stack.calls,
            TR.face_pixel_coords.calls) == stacks
    acc_x, acc_y = (TR.walk_grads_faces_plain(alpha, cot, pp, fi, 24,
                                              TR.DEFAULT_EPS, a)
                    for a in (1, 0))
    want = TR.segment_face_grads_plain(acc_x, acc_y, fi, faces.shape[1]
                                       ).reshape(got.shape)
    torch.cuda.synchronize()
    # one walk launch serves both axes
    assert (TC.walk_grads_cuda.launches,
            TC.segment_face_grads_cuda.launches) == (launches[0] + 1,
                                                     launches[1] + 1)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_all_invalid_scene_has_zero_gradients(cuda):
    """No valid face: empty alpha, and every face gradient exactly 0."""
    faces, _, _ = (torch.from_numpy(a).to(cuda) for a in _faces(9, 2, 21))
    faces.requires_grad_(True)
    valid = torch.zeros(2, 21, dtype=torch.bool, device=cuda)
    a = TR.rasterize_silhouettes(faces, valid, image_size=64)
    (g,) = torch.autograd.grad(a.sum(), faces)
    torch.cuda.synchronize()
    assert (a == 0).all() and (g == 0).all()

"""The port's CUDA kernels (forward rasterizer, silhouette walk,
pixel->face reduction, edit conditioning) against their plain PyTorch
versions, on the card, and the edit chain's use of the forward kernel and
of the conditioning kernel.
Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.ops import rasterize_cuda as TC
from tests.test_torch_edit_conditioning import CASES as EC_CASES


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


def _small_chain(tmp_path):
    """EditChain on the card (full-width models with random weights, small
    shapes: scale 100, render 64, 160x48 textural frames, so the chain
    fetches the device-downsized planes) over a synthetic VKITTI root:
    (chain, the source frame, its two GT objects, one modify)."""
    from PIL import Image

    from sdn3d_tpu_torch.cli.geometric_main import _keep_largest
    from sdn3d_tpu_torch.data import vkitti as VK
    from sdn3d_tpu_torch.data.synthetic import (make_sphere_mesh,
                                                write_vkitti_root)
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj
    from sdn3d_tpu_torch.pipelines.chain import ChainConfig, EditChain

    v, f = make_sphere_mesh(6, 12)
    for cls, obj in SHAPENET_CARS:
        d = tmp_path / "shapenet" / cls / obj / "models"
        d.mkdir(parents=True, exist_ok=True)
        save_obj(str(d / "model_normalized.obj"), v, f)
    root = str(tmp_path / "vkitti")
    write_vkitti_root(root, {("0001", "clone", "00000"): [(180, 300, 260, 440),
                                                         (200, 700, 300, 900)],
                             ("0001", "clone", "00001"): []})
    chain = EditChain.build(ChainConfig(scales=(100,), image_size=64,
                                        render_size=64, load_size=160,
                                        fine_width=160, fine_height=48),
                            str(tmp_path / "shapenet"), device="cuda")
    image = np.asarray(Image.open(VK.rgb_path(root, "0001", "clone", 0)))
    dets = _keep_largest(chain.infer_cfg, *VK.gt_objects(
        root, "0001", "clone", 0, VK.get_tables("inst", root)))
    assert len(dets[0]) == 2
    ops = [{"type": "modify", "from": {"u": "370", "v": "220"}, "to": {},
            "zoom": "1.2", "ry": "0.3"}]
    return chain, image, dets, ops


@pytest.mark.cuda
def test_edit_chain_pair_launches_the_forward_kernel(cuda, tmp_path):
    """One edit pair through EditChain on the card (full-width models with
    random weights, small shapes: scale 100, render 64, 160x48 textural
    frames, so the chain fetches the device-downsized planes) on a
    synthetic VKITTI root: the re-render launches the forward rasterizer
    kernel once and the plain forward never runs; the fake is finite, in
    [-1, 1], and the labels are < 14.  The same pair again, once from the
    per-source caches and once without them, gives the same bits; so do
    the batched chain (edit_frames over the pair and a second pair: one
    forward launch at 2 x 16 images) and the pipelined chain."""
    chain, image, dets, ops = _small_chain(tmp_path)
    TC.rasterize_face_index_cuda.launches = 0
    TR.rasterize_face_maps.calls = 0
    out = chain.edit_frame(image, operations=ops, dets=dets,
                           cache_key="0001_clone_00000")
    torch.cuda.synchronize()
    assert TC.rasterize_face_index_cuda.launches == 1
    assert TR.rasterize_face_maps.calls == 0
    assert out["fake"].shape == (48, 160, 3)
    assert np.isfinite(out["fake"]).all() and np.abs(out["fake"]).max() <= 1
    assert out["label"].shape == (375, 1242) and out["label"].max() < 14
    assert out["geo"]["instance_small"].shape == (48, 160)
    assert (out["geo"]["instance_small"] > 0).any()
    cached = chain.edit_frame(image, operations=ops, dets=dets,
                              cache_key="0001_clone_00000")
    fresh = chain.edit_frame(image, operations=ops, dets=dets)
    other = chain.edit_frame(image, dets=dets)
    requests = [{"image_rgb": image, "operations": ops, "dets": dets,
                 "cache_key": "0001_clone_00000"},
                {"image_rgb": image, "operations": [], "dets": dets}]
    TC.rasterize_face_index_cuda.launches = 0
    batched = chain.edit_frames(requests)
    torch.cuda.synchronize()
    assert TC.rasterize_face_index_cuda.launches == 1
    assert TR.rasterize_face_maps.calls == 0
    piped = next(iter(chain.edit_frames_pipelined([requests])))
    for again, want in ((cached, out), (fresh, out), (batched[0], out),
                        (batched[1], other), (piped[0], out),
                        (piped[1], other)):
        for k in ("fake", "label"):
            np.testing.assert_array_equal(again[k], want[k])
        for k in ("instance_small", "normal_small"):
            np.testing.assert_array_equal(again["geo"][k], want["geo"][k])
        assert again["geo"]["json_obj"] == want["geo"]["json_obj"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(192, 624), (47, 81)],
                         ids=["serving", "odd"])
@pytest.mark.parametrize("name", EC_CASES)
def test_edit_conditioning_kernel_matches_twin(cuda, name, shape):
    """The kernel (csrc/edit_conditioning.cu) equals its plain twin bit for
    bit on the CPU tests' cases, at the serving size (four pixels a step)
    and at an odd one (a pixel a step), and so the host assembly; the twin
    on the card equals the twin on the CPU."""
    from sdn3d_tpu_torch.ops import edit_conditioning as EC
    from tests.test_torch_edit_conditioning import (case_feats, host_frames,
                                                    make_case, twin_inputs)

    M = 64
    sources, frames = make_case(name, *shape)
    feats = case_feats(sources, M)
    EC.edit_conditioning_cuda.launches = 0
    got = EC.edit_conditioning(*twin_inputs(sources, frames, feats, M,
                                            "cuda"), M)
    torch.cuda.synchronize()
    assert EC.edit_conditioning_cuda.launches == 1
    want = EC.edit_conditioning(*twin_inputs(sources, frames, feats, M,
                                             "cpu"), M)
    plain = EC.edit_conditioning_plain(*twin_inputs(sources, frames, feats,
                                                    M, "cuda"), M)
    for field, g, w, p in zip(got._fields, got, want, plain):
        assert g.is_cuda and g.dtype == w.dtype, field
        assert torch.equal(g.cpu(), w), field
        assert torch.equal(p.cpu(), w), field
    if shape == (192, 624) and name in ("cars16", "overflow"):
        from tests.test_torch_edit_conditioning import assert_matches_host
        assert_matches_host(got, host_frames(sources, frames, feats, M),
                            frames)


@pytest.mark.cuda
def test_edit_conditioning_kernel_flags_a_foreign_source(cuda):
    """A frame whose source index lies outside the batch's sources comes
    back with nids -1; the others are computed."""
    from sdn3d_tpu_torch.ops import edit_conditioning as EC
    from tests.test_torch_edit_conditioning import (case_feats, make_case,
                                                    twin_inputs)

    sources, frames = make_case("two_sources", 48, 80)
    args = list(twin_inputs(sources, frames, case_feats(sources, 64), 64,
                            "cuda"))
    args[2] = torch.tensor([0, 2, 1], dtype=torch.int32, device="cuda")
    got = EC.edit_conditioning(*args, 64)
    assert got.nids.cpu().tolist()[1] == -1
    assert min(got.nids.cpu().tolist()[::2]) > 0


@pytest.mark.cuda
def test_generate_edit_batch_one_launch_a_chunk(cuda):
    """generate_edit_batch on the card over three frames of two sources:
    one kernel launch, three frames counted on the device, none on the
    host; fakes and maps equal the host-assembled generator input's, to
    the bit."""
    from types import SimpleNamespace

    from sdn3d_tpu_torch.cli import edit_vkitti as TE
    from sdn3d_tpu_torch.ops import edit_conditioning as EC
    from sdn3d_tpu_torch.pipelines import textural as TT
    from sdn3d_tpu_torch.utils import phases
    from tests.test_torch_edit_conditioning import (assert_same_output,
                                                    case_items,
                                                    host_generate)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        trainer = TT.TexturalTrainer(TT.TexturalConfig()).to("cuda")
    H, W = 192, 624
    items = case_items("two_sources", H, W, 64)
    args = SimpleNamespace(load_size=W)
    TE.generate_edit_batch(trainer, items, (W, H), args)       # warm
    EC.edit_conditioning_cuda.launches = 0
    phases.reset(True)
    try:
        got = TE.generate_edit_batch(trainer, items, (W, H), args)
        snap = phases.snapshot()
    finally:
        phases.reset(False)
    assert EC.edit_conditioning_cuda.launches == 1
    assert snap["count.tex.assemble.device"]["n"] == 3
    assert "count.tex.assemble.host" not in snap
    assert_same_output(got, host_generate(trainer, items, (W, H), args))


@pytest.mark.cuda
def test_edit_chain_fakes_equal_the_host_assembled(cuda, tmp_path,
                                                   monkeypatch):
    """EditChain.edit_frame, edit_frames and edit_frames_pipelined on the
    card: every textural batch's fakes and maps equal those of the
    host-assembled conditioning on the same items, with one kernel launch
    a batch."""
    from sdn3d_tpu_torch.ops import edit_conditioning as EC
    from sdn3d_tpu_torch.pipelines.chain import EditChain
    from tests.test_torch_edit_conditioning import (assert_same_output,
                                                    host_generate)

    chain, image, dets, ops = _small_chain(tmp_path)
    real = EditChain._generate_items
    batches = []

    def checked(self, items):
        before = EC.edit_conditioning_cuda.launches
        got = real(self, items)
        assert EC.edit_conditioning_cuda.launches == before + 1
        assert_same_output(got, host_generate(
            self.textural_trainer, items, self._wh, self._tex_args))
        batches.append(len(items))
        return got

    monkeypatch.setattr(EditChain, "_generate_items", checked)
    requests = [{"image_rgb": image, "operations": ops, "dets": dets,
                 "cache_key": "0001_clone_00000"},
                {"image_rgb": image, "operations": [], "dets": dets}]
    chain.edit_frame(image, operations=ops, dets=dets,
                     cache_key="0001_clone_00000")
    chain.edit_frame(image, operations=ops, dets=dets,
                     cache_key="0001_clone_00000")
    chain.edit_frames(requests)
    list(chain.edit_frames_pipelined([requests, requests[::-1]]))
    assert batches == [1, 1, 2, 2, 2]


@pytest.mark.cuda
def test_textural_nets_same_bits_every_run(cuda):
    """The generator at full width (48 input channels, ngf 64, 4
    down-samplings, 9 blocks) and the encoder, at the chain's 192x624,
    give the same bits for the same input on every run on the card."""
    from sdn3d_tpu_torch.models.pix2pixhd import Encoder, GlobalGenerator

    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net_g = GlobalGenerator(48).to(cuda).eval()
        net_e = Encoder().to(cuda).eval()
    x = torch.randn(1, 48, 192, 624, generator=gen).to(cuda)
    img = (torch.rand(1, 3, 192, 624, generator=gen) * 2 - 1).to(cuda)
    with torch.no_grad():
        for net, inp in ((net_g, x), (net_e, img)):
            outs = [net(inp) for _ in range(3)]
            torch.cuda.synchronize()
            assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_instance_feature_means_same_bits_every_run(cuda):
    """The per-instance code table at the chain's shapes (192x624 frame,
    feat 5, 64 slots, 40 of them in use) gives the same bits on every run
    on the card, and agrees with the CPU's within 1e-6."""
    from sdn3d_tpu_torch.models.pix2pixhd import instance_feature_means

    rng = np.random.RandomState(5)
    feats = torch.from_numpy(np.tanh(rng.randn(1, 192, 624, 5)).astype(
        np.float32))
    slots = torch.from_numpy(rng.randint(0, 40, (1, 192, 624)))
    want_m, want_c = instance_feature_means(feats, slots, 64)
    runs = [instance_feature_means(feats.to(cuda), slots.to(cuda), 64)
            for _ in range(3)]
    torch.cuda.synchronize()
    for m, c in runs:
        assert torch.equal(m, runs[0][0]) and torch.equal(c, runs[0][1])
    assert torch.equal(runs[0][1].cpu(), want_c)
    np.testing.assert_allclose(runs[0][0].cpu().numpy(), want_m.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_apply_plan_u8_on_the_card_equals_the_cpu(cuda):
    """The device downsize of the chain's planes (ops/pil_resize) on the
    card: byte-equal to the CPU (and so to Pillow) at the serving geometry
    1242x375 -> 624x192 and at 1242x375 -> 160 -> 128x32 (a crop), for
    the nearest (instance) and bicubic (normal) planes."""
    from sdn3d_tpu_torch.ops import pil_resize as PR

    rng = np.random.RandomState(6)
    inst = torch.from_numpy(rng.randint(0, 17, (375, 1242)).astype(np.uint8))
    nrm = torch.from_numpy(rng.randint(0, 256, (375, 1242, 3)).astype(
        np.uint8))
    for load, fine in ((624, (624, 192)), (160, (128, 32))):
        plan = PR.transform_plan((1242, 375), load, fine)
        for img, nearest in ((inst, True), (nrm, False)):
            got = PR.apply_plan_u8(img.to(cuda), plan, nearest=nearest)
            assert got.is_cuda and got.dtype == torch.uint8
            assert torch.equal(got.cpu(), PR.apply_plan_u8(img, plan,
                                                           nearest=nearest))


@pytest.mark.cuda
def test_batched_render_equals_per_frame_renders(cuda):
    """derender_images_batch over three frames (one forward-rasterizer
    launch at 3 x 4 slot images) against derender_image per frame on the
    card: the planes (full and device-downsized) and the JSON equal."""
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
    from sdn3d_tpu_torch.ops.pil_resize import transform_plan
    from sdn3d_tpu_torch.pipelines.derender_infer import (
        DerenderInferConfig, derender_image, derender_images_batch)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Derenderer(num_classes=2).to(cuda).eval()
    bank = DeviceMeshBank.from_host(
        build_mesh_bank([make_sphere_mesh(12, 24)] * 2), device=cuda)
    rng = np.random.RandomState(7)
    cfg = DerenderInferConfig(image_size=64, render_size=64, max_objects=4)
    frames = []
    for k in range(3):
        image = (rng.rand(96, 160, 3) * 255).astype(np.uint8)
        rois = np.asarray([[20, 30 + k, 60, 80], [40, 90, 85, 150 - k]],
                          np.float32)
        masks = np.zeros((2, 1, 96, 160), np.float32)
        for i, r in enumerate(rois.astype(int)):
            masks[i, 0, r[0] + 5:r[2] - 5, r[1] + 5:r[3] - 5] = 1
        frames.append({"image_rgb": image, "class_ids": np.asarray([1, 2]),
                       "image_masks": masks, "rois": rois})
    for plan in (None, transform_plan((160, 96), 80, (80, 40))):
        TC.rasterize_face_index_cuda.launches = 0
        batched = derender_images_batch(model, bank, frames, cfg,
                                        small_plan=plan, device=cuda)
        torch.cuda.synchronize()
        assert TC.rasterize_face_index_cuda.launches == 1
        keys = (("instance_png", "normal_png", "depth_png") if plan is None
                else ("instance_small", "normal_small"))
        for fr, b in zip(frames, batched):
            one = derender_image(model, bank, fr["image_rgb"],
                                 fr["class_ids"], fr["image_masks"],
                                 fr["rois"], cfg, small_plan=plan,
                                 device=cuda)
            for k in keys:
                np.testing.assert_array_equal(b[k], one[k])
            assert b["json_obj"] == one["json_obj"]


def _detect_frame(seed):
    """A 375x1242 frame: noise, a gradient and a few flat boxes."""
    rng = np.random.RandomState(seed)
    img = rng.rand(375, 1242, 3) * 64 + np.linspace(0, 160, 1242)[None, :,
                                                                    None]
    for y, x in ((150, 200), (180, 600), (160, 900)):
        img[y:y + 80, x:x + 160] = rng.randint(0, 255, 3)
    return img.astype(np.uint8)


@pytest.mark.cuda
def test_detector_same_bits_every_run(cuda):
    """The full-width detector (MaskRCNNConfig(): ResNet-101 FPN at
    1024^2, random weights from a seed) gives one frame's packed buffer
    the same bits on three runs, and a batch of two frames the same bits
    on two runs (no atomics: the transposed convolution is a forward
    convolution, the NMS a fixed point of masked products)."""
    from sdn3d_tpu_torch.models.maskrcnn import MaskRCNNConfig
    from sdn3d_tpu_torch.pipelines.detect import (MaskRCNNDetector,
                                                  resize_image)

    cfg = MaskRCNNConfig()
    det = MaskRCNNDetector(cfg, "cuda").init(0)
    inputs = [resize_image(_detect_frame(s), cfg.image_min_dim,
                           cfg.image_max_dim)[:2] for s in (0, 1)]
    runs = [det._packed([inputs[0][0]], [inputs[0][1]]) for _ in range(3)]
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[1], runs[2])
    pair = [det._packed([m for m, _ in inputs], [w for _, w in inputs])
            for _ in range(2)]
    assert pair[0].shape[0] == 2 and torch.equal(pair[0], pair[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 6000])
def test_nms_card_keep_equals_cpu(cuda, n):
    """ops/nms on the card against the CPU on the same boxes (whole and
    fractional pixels, duplicates, exact score ties, invalid rows, a NaN
    box): nms's keep mask and nms_padded's indices and validity equal."""
    from sdn3d_tpu_torch.ops.nms import nms, nms_padded

    rng = np.random.RandomState(n)
    lo = rng.uniform(0, 1000, (n, 2))
    hi = lo + rng.uniform(4, 200, (n, 2))
    boxes = np.concatenate([lo, hi], 1).astype(np.float32)
    boxes[::3] = np.round(boxes[::3])
    boxes[5::7] = boxes[4::7][:len(boxes[5::7])]
    boxes[7] = np.nan
    scores = rng.choice([0.3, 0.6, 0.9], n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    b, s, v = (torch.from_numpy(a) for a in (boxes, scores, valid))
    for thr in (0.3, 0.7):
        assert torch.equal(nms(b.to(cuda), thr, v.to(cuda)).cpu(),
                           nms(b, thr, v))
        gi, gv = nms_padded(b.to(cuda), s.to(cuda), thr, 1000, v.to(cuda))
        ci, cv = nms_padded(b, s, thr, 1000, v)
        assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)


@pytest.mark.cuda
def test_native_crops_on_the_card_path_equal_the_cpu_path(cuda):
    """The card's machine builds the native host library (data/native.py),
    so the card path's crops are the native ones: the scenegt decode equals
    the numpy path; the float crops agree with the numpy + PIL path's to
    1e-5 (tests/test_native.py's bound for the library against PIL), so
    prepare_objects' uint8 crops differ from that path's by at most one
    (where a value lies within 255e-5 of a rounding boundary: 0.3% of the
    bytes on this noise frame in the first card run, 9 of 3.1M on
    chip_smoke.py's smooth frame); and the normalised crops the encoder
    reads on the card equal those of the CPU path bit for bit."""
    from sdn3d_tpu_torch.data import native
    from sdn3d_tpu_torch.pipelines import derender_infer as TI

    assert native.available()
    rng = np.random.RandomState(0)
    img = rng.randint(0, 4, (60, 90, 3)).astype(np.uint8) * 60
    keys = np.unique((img[..., 0].astype(np.uint32) << 16)
                     | (img[..., 1].astype(np.uint32) << 8) | img[..., 2])
    vals = np.arange(len(keys), dtype=np.int32)
    np.testing.assert_array_equal(native.scenegt_decode(img, keys[::2],
                                                        vals[::2]),
                                  native.scenegt_decode_np(img, keys[::2],
                                                           vals[::2]))
    image = (rng.rand(375, 1242, 3) * 255).astype(np.uint8)
    rois = np.asarray([[150, 200, 260, 420], [180, 900, 300, 1240],
                       [-5, 0, 60, 80]], np.float32)
    masks = np.zeros((3, 1, 375, 1242), np.float32)
    for i, (a, b, c, d) in enumerate(rois.astype(int)):
        masks[i, 0, max(a, 0):c, b:d] = 1
    cfg = TI.DerenderInferConfig()
    objs = TI.prepare_objects(image, rois, masks, np.asarray([1, 2, 1]), cfg)
    saved = dict(native._state)
    native._state.update(tried=True, lib=None)
    try:
        plain = TI.prepare_objects(image, rois, masks, np.asarray([1, 2, 1]),
                                   cfg)
    finally:
        native._state.update(saved)
    diff = np.abs(objs["rgbs"].astype(int) - plain["rgbs"].astype(int))
    assert diff.max() <= 1
    for roi in rois:
        np.testing.assert_allclose(
            native.crop_square_resize(image / np.float32(255), roi, 256),
            native.crop_square_resize_np(image / np.float32(255), roi, 256),
            rtol=0, atol=1e-5)
    crops = torch.from_numpy(objs["rgbs"]).long()
    torch.testing.assert_close(TI._norm_table(cuda)[crops.to(cuda)].cpu(),
                               TI._norm_table(torch.device("cpu"))[crops],
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_geometric_main_dataset_mode_launches_the_forward_once_an_item(
        cuda, tmp_path):
    """geometric_main --vkitti_root --split test on the card (its default
    device) over the motgt frames of a synthetic root: one forward-kernel
    launch an item, no plain forward, every frame's contract written."""
    import os

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.data.synthetic import (make_sphere_mesh,
                                                write_vkitti_root)
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    v, f = make_sphere_mesh(6, 12)
    for cls, obj in SHAPENET_CARS:
        d = tmp_path / "shapenet" / cls / obj / "models"
        d.mkdir(parents=True, exist_ok=True)
        save_obj(str(d / "model_normalized.obj"), v, f)
    root = str(tmp_path / "vkitti")
    write_vkitti_root(root, {
        ("0001", "clone", "00360"): [(180, 300, 260, 440),
                                     (200, 700, 300, 900)],
        ("0001", "clone", "00361"): [],
        ("0002", "fog", "00200"): [(170, 500, 250, 650)],
        ("0002", "fog", "00010"): [(170, 500, 250, 650)]})   # train range
    out = str(tmp_path / "geo")
    TC.rasterize_face_index_cuda.launches = 0
    TR.rasterize_face_maps.calls = 0
    geometric_main.main(["--source", "gt", "--vkitti_root", root,
                         "--split", "test", "--output_dir", out,
                         "--shapenet_root", str(tmp_path / "shapenet"),
                         "--image_size", "64", "--render_size", "64"])
    torch.cuda.synchronize()
    assert TC.rasterize_face_index_cuda.launches == 2
    assert TR.rasterize_face_maps.calls == 0
    for name in ("0001_clone_00360", "0002_fog_00200"):
        for suffix in (".png", "-normal.png", "-depth.png", ".json", ".pkl"):
            assert os.path.exists(os.path.join(out, name + suffix))
    assert not os.path.exists(os.path.join(out, "0002_fog_00010.png"))


def _train_setup(dev, mode="full"):
    """The derenderer trainer on the card at small shapes (batch 4,
    image = render = 64, eight make_sphere_mesh(8, 16) classes), its
    initial state_dict and a synthetic batch with the CLI's masks."""
    from sdn3d_tpu_torch.data.synthetic import (centred_square_masks,
                                                make_derender_batch,
                                                make_sphere_mesh)
    from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
    from sdn3d_tpu_torch.models.derenderer import (Derenderer,
                                                   DeviceMeshBank, TargetType)
    from sdn3d_tpu_torch.pipelines.derender import DerenderTrainer

    torch.manual_seed(0)
    model = Derenderer(num_classes=8).to(dev)
    bank = DeviceMeshBank.from_host(
        build_mesh_bank([make_sphere_mesh(8, 16)] * 8), device=dev)
    trainer = DerenderTrainer(model=model, bank=bank,
                              mode=TargetType.BY_NAME[mode], image_size=64,
                              render_size=64)
    b = make_derender_batch(4, 64, seed=1)
    b.update(centred_square_masks(4, 64))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    return trainer, {k: v.clone() for k, v in model.state_dict().items()}, \
        batch


def _one_step(trainer, sd0, batch, dev, seed=1):
    trainer.model.load_state_dict(sd0)
    state = trainer.init()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    state, losses = trainer.train_step(state, batch, g)
    torch.cuda.synchronize()
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.mu.clone(), state.nu.clone(), losses)


@pytest.mark.cuda
def test_train_step_same_bits_every_run(cuda):
    """One full-mode train step (cuDNN's deterministic algorithms, TF32
    off) from the same state, batch and draws, twice: the losses, the new
    weights and running statistics and Adam's moments are the same bits
    (the convolution backward's atomics would move them otherwise).  The
    step runs with the deterministic algorithms and restores the cuDNN
    flags it found."""
    trainer, sd0, batch = _train_setup(cuda)
    found = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    inside = []
    hook = trainer.model.register_forward_hook(
        lambda *_: inside.append((torch.backends.cudnn.deterministic,
                                  torch.backends.cudnn.benchmark,
                                  torch.backends.cudnn.allow_tf32)))
    a, b = (_one_step(trainer, sd0, batch, cuda) for _ in range(2))
    hook.remove()
    assert inside == [(True, False, False)] * 2
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == found
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    for k in a[3]:
        assert torch.isfinite(a[3][k]) and torch.equal(a[3][k], b[3][k]), k


@pytest.mark.cuda
def test_train_step_launches_each_kernel_once(cuda):
    """A full-mode train step on the card launches the forward (B1), the
    walk (B3) and the reduction (B2) once each, and runs no plain version
    and builds no invariant stack; a pretrain step launches none."""
    plain = (TR.rasterize_face_maps, TR.walk_grads_plain,
             TR.segment_face_grads_plain, TR.edge_invariant_stack,
             TR.face_pixel_coords)
    kernels = (TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
               TC.segment_face_grads_cuda)
    for mode, want in (("full", 1), ("pretrain", 0)):
        trainer, sd0, batch = _train_setup(cuda, mode)
        before = ([k.launches for k in kernels], [p.calls for p in plain])
        _one_step(trainer, sd0, batch, cuda)
        assert [k.launches - n for k, n in zip(kernels, before[0])] == \
            [want] * 3, mode
        assert [p.calls for p in plain] == before[1], mode


@pytest.mark.cuda
def test_depth_vjp_same_bits_every_run(cuda):
    """The depth VJP on the card (ops/rasterize.DepthFn: the forward
    kernel, then `_depth_grad` summed per face by segment_sum_sorted, no
    atomics): two backward runs give the same bits, and the CPU's within
    1e-5 of the largest face gradient."""
    rng = np.random.RandomState(4)
    faces = np.concatenate([rng.uniform(-1.2, 1.2, (2, 300, 3, 2)),
                            rng.uniform(1.5, 6.0, (2, 300, 3, 1))],
                           -1).astype(np.float32)
    valid = np.ones((2, 300), bool)
    cot = rng.randn(2, 128, 128).astype(np.float32)
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        f = torch.from_numpy(faces).to(dev).requires_grad_(True)
        d = TR.DepthFn.apply(f, torch.from_numpy(valid).to(dev), 128, 0.1,
                             100.0)
        (g,) = torch.autograd.grad(d, f, torch.from_numpy(cot).to(dev))
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])
    assert grads[2].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[2], rtol=0,
                               atol=1e-5 * float(grads[2].abs().max()))


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def _textural_setup(dev, **kw):
    """The textural trainer at full width (TexturalConfig(), VGG loss on)
    on the card at 64 x 192, batch 1, its initial fields and a synthetic
    batch of the CLI's."""
    from types import SimpleNamespace

    from sdn3d_tpu_torch.cli.textural_train import synthetic_batch
    from sdn3d_tpu_torch.pipelines.textural import (TexturalConfig,
                                                    TexturalTrainer)

    cfg = TexturalConfig(**kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        trainer = TexturalTrainer(cfg)
    trainer.to(dev)
    state = trainer.init(torch.Generator().manual_seed(0), 64, 192)
    batch = synthetic_batch(SimpleNamespace(fine_height=64, fine_width=192,
                                            batch_size=1),
                            np.random.RandomState(0), cfg)
    return trainer, state, _clone(state.fields()), batch


def _textural_run(trainer, state, fields0, batch, dev):
    from sdn3d_tpu_torch.cli.geometric_train import step_generator

    state.load_fields(fields0)
    pool = (trainer.device_pool(64, 192) if trainer.cfg.pool_size else None)
    for it in range(2 if pool is not None else 1):
        state, losses, pool = trainer.make_train_iteration()(
            state, batch, step_generator(0, it, dev), pool)
    torch.cuda.synchronize()
    return _clone(state.fields()), _clone(losses)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    else:
        assert torch.equal(a, b), path


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"use_global_encoder": True,
                                     "pool_size": 4}])
def test_textural_iteration_same_bits_every_run(cuda, kw):
    """A full-width textural iteration (with the global encoder and a
    history pool: two iterations, the second through the pool) from the
    same state, batch and draws, twice: every net, Adam's moments and
    counts and the losses are the same bits (the reflection padding's,
    the instance average's and the convolutions' backwards add without
    atomics)."""
    trainer, state, fields0, batch = _textural_setup(cuda, **kw)
    a = _textural_run(trainer, state, fields0, batch, cuda)
    b = _textural_run(trainer, state, fields0, batch, cuda)
    for k, v in a[1].items():
        assert torch.isfinite(v), k
    _same(a[0], b[0])
    _same(a[1], b[1])


@pytest.mark.cuda
def test_textural_iteration_flags_and_no_nondeterministic_op(cuda):
    """The iteration's forward and backward run with cuDNN's deterministic
    algorithms on, autotuning off and TF32 off, and the cuDNN flags found
    are restored after; under torch.use_deterministic_algorithms (warn
    only, as a probe) no op of the iteration reports a nondeterministic
    CUDA implementation (cuBLAS's workspace note aside)."""
    import warnings

    trainer, state, fields0, batch = _textural_setup(cuda)
    c = torch.backends.cudnn
    found = (c.deterministic, c.benchmark)
    inside = []
    hook = trainer.netG.register_forward_hook(
        lambda *_: inside.append((c.deterministic, c.benchmark, c.allow_tf32,
                                  torch.backends.cuda.matmul.allow_tf32)))
    _textural_run(trainer, state, fields0, batch, cuda)
    hook.remove()
    assert inside == [(True, False, False, False)]
    assert (c.deterministic, c.benchmark) == found
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _textural_run(trainer, state, fields0, batch, cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    bad = [str(w.message) for w in caught
           if "deterministic" in str(w.message)
           and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)]
    assert not bad, bad


@pytest.mark.cuda
def test_semantic_train_step_same_bits_every_run(cuda):
    """The semantic trainer's step at the CLI's widths (batch 2, crop 64
    here to keep the test short) on the card, twice from the same state,
    batch and dropout generator: every parameter, running statistic,
    momentum trace and the loss bit-equal (cuDNN's deterministic
    algorithms, a one-hot loss without atomics, TF32 off)."""
    from sdn3d_tpu_torch.cli import semantic_train as ST
    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    from sdn3d_tpu_torch.pipelines.semantic import SemanticTrainState

    args = ST.build_argparser().parse_args(["--batch_size", "2",
                                            "--crop_size", "64"])
    trainer = ST.build_trainer(args)
    batch = ST.to_batch(*next(ST.synthetic_batches(
        args, np.random.RandomState(0))), cuda)
    def clone(x):
        return ({k: clone(v) for k, v in x.items()} if isinstance(x, dict)
                else x.clone())
    fields0 = clone(trainer.init().fields())
    runs = []
    for _ in range(2):
        state = SemanticTrainState.from_fields(fields0, trainer.model)
        state, metrics = trainer.train_step(state, *batch,
                                            step_generator(0, 0, cuda))
        runs.append((clone(state.fields()), float(metrics["loss"])))
    assert runs[0][1] == runs[1][1] and np.isfinite(runs[0][1])
    for key in ("encoder", "decoder"):
        for n, t in runs[0][0][key].items():
            assert torch.equal(t, runs[1][0][key][n]), (key, n)
    for key in ("opt_enc", "opt_dec"):
        for n, t in runs[0][0][key]["trace"].items():
            assert torch.equal(t, runs[1][0][key]["trace"][n]), (key, n)


@pytest.mark.cuda
def test_decoder_convolutions_train_through_torchs_own(cuda):
    """models/semantic.DecoderConv2d training in float32 on the card: its
    output and its gradients in the input, weight and bias bit-equal to
    F.conv2d's under cuDNN off, the bias added after; in eval mode it is
    Conv2d (cuDNN)."""
    import torch.nn.functional as F

    from sdn3d_tpu_torch.models.semantic import DecoderConv2d
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 8, 8, generator=g).to(cuda)
    grad = torch.randn(2, 32, 8, 8, generator=g).to(cuda)
    conv = DecoderConv2d(64, 32, 3, padding=1).to(cuda).train()
    xa = x.clone().requires_grad_(True)
    out = conv(xa)
    got = torch.autograd.grad(out, [xa, conv.weight, conv.bias], grad)
    xb = x.clone().requires_grad_(True)
    with torch.backends.cudnn.flags(enabled=False):
        want_out = F.conv2d(xb, conv.weight, None, padding=1) \
            + conv.bias[:, None, None]
        want = torch.autograd.grad(want_out, [xb, conv.weight, conv.bias],
                                   grad)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(conv.eval()(x), F.conv2d(x, conv.weight,
                                                    conv.bias, padding=1))


@pytest.mark.cuda
@pytest.mark.parametrize("dataset,mode", [("kitti", "finetune"),
                                          ("cityscapes", "extend")])
def test_geometric_train_datasets_launch_each_kernel_once_a_step(
        cuda, tmp_path, dataset, mode):
    """geometric_train --dataset kitti|cityscapes on data/synthetic's roots
    (batch 1, 64 / 64): each step with a mask loss launches the forward
    (B1), the walk (B3) and the reduction (B2) once; no plain version
    runs."""
    from sdn3d_tpu_torch.cli.geometric_train import main
    from sdn3d_tpu_torch.data import synthetic

    root = str(tmp_path / "root")
    if dataset == "kitti":
        synthetic.write_kitti_semantics_root(root)
        flags = ["--kitti_semantics_root", root]
    else:
        synthetic.write_cityscapes_derender_root(root)
        flags = ["--cityscapes_root", root]
    kernels = (TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
               TC.segment_face_grads_cuda)
    plain = (TR.rasterize_face_maps, TR.walk_grads_plain,
             TR.segment_face_grads_plain)
    for fn in kernels:
        fn.launches = 0
    for fn in plain:
        fn.calls = 0
    state = main(["--mode", mode, "--dataset", dataset, "--batch_size", "1",
                  "--image_size", "64", "--render_size", "64",
                  "--num_iters", "3", "--num_workers", "1",
                  "--ckpt_dir", str(tmp_path / "ck")] + flags)
    assert state.step == 3
    assert [fn.launches for fn in kernels] == [3, 3, 3]
    assert [fn.calls for fn in plain] == [0, 0, 0]


@pytest.mark.cuda
def test_render_rgb_launches_the_forward_once(cuda):
    """render() of the RGB type (2F fill_back, lighting, texture cubes):
    one forward launch and no plain forward a render, the RGB equal to the
    same render on the card through the plain forward, and the texture
    gradient the same bits on two runs."""
    from sdn3d_tpu_torch.render.renderer import RenderType, render

    rng = np.random.RandomState(11)
    verts = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 30, 3)).astype(
        np.float32))
    verts[..., 2] -= 4.0
    faces = torch.from_numpy(np.stack([rng.permutation(30)[:3]
                                       for _ in range(80)]).reshape(
        2, 40, 3).astype(np.int32))
    tex = torch.rand((2, 40, 4, 4, 4, 3), generator=torch.Generator(
    ).manual_seed(1))
    v, f, t = verts.to(cuda), faces.to(cuda), tex.to(cuda)
    TC.rasterize_face_index_cuda.launches = 0
    TR.rasterize_face_maps.calls = 0
    rgb = render(v, f, RenderType.RGB, image_size=64, textures=t)
    torch.cuda.synchronize()
    assert TC.rasterize_face_index_cuda.launches == 1
    assert TR.rasterize_face_maps.calls == 0
    dispatch = TC.rasterize_face_index
    TC.rasterize_face_index = lambda f_, v_, s_, near=TR.DEFAULT_NEAR, \
        far=TR.DEFAULT_FAR, colors=None: TR.rasterize_face_maps(
            f_, v_, s_, near, far)
    try:
        want = render(v, f, RenderType.RGB, image_size=64, textures=t)
    finally:
        TC.rasterize_face_index = dispatch
    assert TR.rasterize_face_maps.calls == 1
    assert float(rgb.abs().sum()) > 0 and torch.equal(rgb, want)

    def grad():
        tt = t.clone().requires_grad_(True)
        out = render(v, f, RenderType.RGB, image_size=64, textures=tt)
        return torch.autograd.grad((out * out).sum(), tt)[0]

    g = grad()
    assert float(g.abs().sum()) > 0 and torch.equal(g, grad())


@pytest.mark.cuda
def test_face_chunk_gradient_matches_the_kernels(cuda):
    """The face-chunk silhouette gradient (plain PyTorch on the card)
    against the pixelwise one through the walk and reduction kernels,
    walking to the border: within 1e-3 (relative and absolute)."""
    faces, valid, _ = _faces(2, 2, 37)
    f, v = torch.from_numpy(faces).to(cuda), torch.from_numpy(valid).to(cuda)
    fi, _ = TC.rasterize_face_index(f, v, 96)
    alpha = (fi >= 0).float()
    cot = torch.from_numpy(np.random.RandomState(3).randn(2, 96, 96).astype(
        np.float32)).to(cuda)
    chunk = TR.silhouette_grad_chunked(f, v, fi, alpha, cot, 96,
                                       TR.DEFAULT_EPS)
    pix = TR.silhouette_grad_pixelwise(f, fi, alpha, cot, 96, TR.DEFAULT_EPS,
                                       walk=0)
    assert float(chunk.abs().max()) > 0
    torch.testing.assert_close(pix, chunk, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_renderer_launches_each_kernel_once_and_is_render(cuda):
    """Renderer's Silhouette forward and backward on the card: one launch
    of B1, B3 and B2 and no plain version; its silhouette and vertex
    gradient render()'s bits with the same arguments (under torch's
    deterministic algorithms: the vertex gather's backward adds with
    atomics otherwise).  look_at from get_points_from_angles and FFD
    within 1e-5 of the CPU, and trace() writes B1's kernel."""
    import json
    import os
    import tempfile

    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry import FFD, look_at
    from sdn3d_tpu_torch.geometry.camera import get_points_from_angles
    from sdn3d_tpu_torch.render import Renderer, RenderType, render
    from sdn3d_tpu_torch.utils.profiling import trace

    vh, fh = make_sphere_mesh(8, 16)
    rng = np.random.RandomState(12)
    verts = torch.from_numpy(np.stack([
        vh * rng.uniform(1, 2, 3) + [rng.uniform(-.3, .3), 0, -3.0]
        for _ in range(3)]).astype(np.float32)).to(cuda)
    faces = torch.from_numpy(np.repeat(fh[None], 3, 0)).to(cuda)
    cot = torch.randn((3, 1, 96, 96), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    kernels = (TC.rasterize_face_index_cuda, TC.walk_grads_cuda,
               TC.segment_face_grads_cuda)
    plain = (TR.rasterize_face_maps, TR.walk_grads_plain,
             TR.segment_face_grads_plain)

    def run(fn):
        v = verts.clone().requires_grad_(True)
        sil = fn(v)
        return sil.detach(), torch.autograd.grad((sil * cot).sum(), v)[0]

    found = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for fn in kernels:
            fn.launches = 0
        for fn in plain:
            fn.calls = 0
        got = run(lambda v: Renderer(96, 31.0)(v, faces))
        torch.cuda.synchronize()
        assert [fn.launches for fn in kernels] == [1, 1, 1]
        assert [fn.calls for fn in plain] == [0, 0, 0]
        want = run(lambda v: render(v, faces, RenderType.Silhouette,
                                    image_size=96, viewing_angle=31.0))
    finally:
        torch.use_deterministic_algorithms(found[0], warn_only=found[1])
    assert 0.01 < float(got[0].mean()) < 0.99
    assert float(got[1].abs().max()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    angles = [torch.from_numpy(rng.uniform(a, b, 3).astype(np.float32))
              for a, b in ((2, 3), (-20, 40), (-180, 180))]
    coeff = torch.from_numpy((rng.randn(3, 192) * 0.1).astype(np.float32))
    out = {}
    for d in ("cpu", cuda):
        eye = get_points_from_angles(*(a.to(d) for a in angles))
        out[str(d)] = (look_at(verts.to(d), eye).cpu(),
                       FFD.from_vertices(vh, device=d)(coeff.to(d)).cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)

    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            render(verts, faces, image_size=96)
            torch.cuda.synchronize()
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as fh_:
            names = {e.get("name", "") for e in json.load(fh_)["traceEvents"]}
    assert any("raster_binned_kernel" in n for n in names)


def _cuda_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_span_brackets_its_kernels_on_the_profilers_clock(cuda):
    """A kernel launched and waited for inside a utils/phases span runs,
    by the profiler's device timestamps, inside the span's time.time_ns()
    interval (the span and the card share one clock), and the span puts
    no event of its own on the card."""
    from torch.profiler import ProfilerActivity, profile

    from sdn3d_tpu_torch.utils import phases
    a = torch.randn(2048, 2048, device=cuda)
    (a @ a).sum().item()
    phases.profiled()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with phases.phase("stage.probe", 1):
            a @ a
            torch.cuda.synchronize()
    span, = phases.profiled()["spans"]
    dev = _cuda_events(prof)
    assert dev and not any(e.name() == "stage.probe" for e in dev)
    for e in dev:
        assert span.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= span.end_ns


@pytest.mark.cuda
def test_spans_add_no_device_events_to_a_train_step(cuda, monkeypatch):
    """One full-mode derenderer training step under the profiler gives
    the same CUDA device events, by count and name, with its train.*
    spans on and with utils/phases' spans stubbed out."""
    from torch.profiler import ProfilerActivity, profile

    from sdn3d_tpu_torch.utils import phases
    trainer, sd0, batch = _train_setup(cuda)
    _one_step(trainer, sd0, batch, cuda)

    def names():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _one_step(trainer, sd0, batch, cuda)
        return sorted(e.name() for e in _cuda_events(prof))

    phases.profiled()
    on = names()
    spans = phases.profiled()["spans"]
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer"} <= {s.name for s in spans}
    monkeypatch.setattr(phases, "phase", lambda name, rid=None: phases._OFF)
    off = names()
    assert not phases.profiled()["spans"]
    assert len(on) == len(off) and on == off


@pytest.fixture(scope="module")
def chain_render():
    """The chain's geometric re-render at its serving size: the
    derenderer (8 classes, random weights), 8 meshes of 39,600 faces,
    DerenderInferConfig()'s 16 slots at render 384 (768^2 rasters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    from sdn3d_tpu_torch.data.synthetic import make_sphere_mesh
    from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
    from sdn3d_tpu_torch.models.derenderer import Derenderer, DeviceMeshBank
    from sdn3d_tpu_torch.pipelines.derender_infer import DerenderInferConfig

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Derenderer(num_classes=8).cuda().eval()
    meshes = [make_sphere_mesh(100, 200, radius=0.3 + 0.02 * k)
              for k in range(8)]
    bank = DeviceMeshBank.from_host(build_mesh_bank(meshes), device="cuda")
    return model, bank, DerenderInferConfig()


def _edited_chunk(model, cfg, n_frames, seed):
    """derender_render_begin's (objs, edited blob, interests) for
    n_frames 375x1242 frames of 5-16 cars, each with two modifies and a
    delete."""
    from sdn3d_tpu_torch.pipelines import derender_infer as TI
    rng = np.random.RandomState(seed)
    per = []
    for _ in range(n_frames):
        n = rng.randint(5, 17)
        image = (rng.rand(375, 1242, 3) * 255).astype(np.uint8)
        h = rng.randint(40, 130, n)
        w = (h * rng.uniform(1.2, 2.2, n)).astype(int)
        y = rng.randint(150, 355 - h // 2, n) - h // 2
        x = rng.randint(0, 1240 - w, n)
        rois = np.stack([y, x, y + h, x + w], 1).astype(np.float32)
        masks = np.zeros((n, 1, 375, 1242), np.float32)
        for i, (y1, x1, y2, x2) in enumerate(rois.astype(int)):
            masks[i, 0, y1:y2, x1:x2] = 1
        centre = [{"u": str((r[1] + r[3]) / 2), "v": str((r[0] + r[2]) / 2)}
                  for r in rois]
        ops = [{"type": "modify", "from": centre[i], "to": {},
                "zoom": str(rng.uniform(0.8, 1.5)),
                "ry": str(rng.uniform(-3, 3))} for i in (0, 1)]
        ops.append({"type": "delete", "from": centre[2]})
        objs, blob = TI.derender_encode(model, image, np.ones(n, np.int64),
                                        masks, rois, cfg, device="cuda")
        per.append((objs,) + TI._edited_blob(objs, blob, ops))
    return per


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames,small", [(1, True), (4, True),
                                            (1, False)],
                         ids=["serial", "batch", "file"])
def test_render_graph_replays_the_eager_bytes(chain_render, n_frames,
                                              small):
    """The re-render through `_render_chunk` on the card, three calls of
    one shape key (chunk A, chunk B, chunk A again: a capture and two
    replays), against the eager `_render_composite_batch` on the same
    inputs: every packed buffer byte-equal, so the static input is
    refreshed on each replay, and every device map equal, the second
    call's read after the third replay (no later replay changes what an
    earlier result holds).  The graph counters count one eager run, one
    capture and two replays; the forward kernel counts a launch a call;
    under the profiler a replay shows the raster kernel."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from sdn3d_tpu_torch.ops.pil_resize import transform_plan
    from sdn3d_tpu_torch.pipelines import derender_infer as TI
    from sdn3d_tpu_torch.utils import phases
    from sdn3d_tpu_torch.utils.transfer import to_device

    model, bank, cfg = chain_render
    plan = transform_plan((1242, 375), 624, (624, 192)) if small else None
    chunks = [_edited_chunk(model, cfg, n_frames, seed) for seed in (1, 2)]
    packed = [TI._packed_inputs(per) for per in chunks]

    def eager(k):
        host, layout = packed[k]
        blob, interests, valid = TI._input_views(to_device(host, "cuda"),
                                                 layout)
        return TI._render_composite_batch(blob, bank, interests, valid, cfg,
                                          375, 1242, small=plan)

    want = [eager(0), eager(1)]
    assert not torch.equal(want[0][4], want[1][4])
    TI._GRAPHS.pop(id(bank), None)
    launches = TC.rasterize_face_index_cuda.launches
    got = []
    phases.reset(True)
    try:
        for i, k in enumerate((0, 1, 0)):
            host, layout = packed[k]
            # the capture outside the profiler, the replays under it
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) if i
                  else contextlib.nullcontext()) as prof:
                r = TI._render_chunk(to_device(host, "cuda"), layout, bank,
                                     cfg, 375, 1242, small=plan)
                got.append((k, r, r[4].cpu()))   # before the next replay
        counted = phases.snapshot()
    finally:
        phases.reset(False)
        phases.profiled()
    assert any("raster_binned_kernel" in e.name() for e in _cuda_events(prof))
    assert {k: v["n"] for k, v in counted.items()
            if k.startswith("count.render_graph")} == {
        "count.render_graph.eager": 1, "count.render_graph.capture": 1,
        "count.render_graph.replay": 2}
    assert TC.rasterize_face_index_cuda.launches == launches + 3
    assert len(TI._GRAPHS[id(bank)]) == 1
    for k, r, host_packed in got:
        w = want[k]
        assert torch.equal(host_packed, w[4].cpu())
        assert {n: (v.shape, v.dtype) for n, v in r[0].items()} == \
            {n: (v.shape, v.dtype) for n, v in w[0].items()}
        for maps, want_maps in zip(r[1:4], w[1:4]):
            assert len(maps) == n_frames
            for a, b in zip(maps, want_maps):
                assert torch.equal(a, b)
    assert (want[0][1][0] > 0).any()

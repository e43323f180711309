"""The port's plain forward rasterizer against the JAX package's
(sdn3d_tpu_torch/ops/rasterize.py vs sdn3d_tpu/ops/rasterize.py), and the
CUDA kernels' CPU-checkable parts (the pre-pass cull, the bin lists and
the order-free tie rule of the binned forward, dispatch)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.ops import rasterize as JR
from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.ops import rasterize_cuda as TC


def random_faces(rng, batch=2, num_faces=12, z_range=(1.5, 6.0)):
    """Random triangles in front of the camera, normalized coords."""
    xy = rng.uniform(-1.2, 1.2, size=(batch, num_faces, 3, 2))
    z = rng.uniform(*z_range, size=(batch, num_faces, 3, 1))
    return np.concatenate([xy, z], axis=-1).astype(np.float32)


def tricky_faces(seed=0, batch=2, num_faces=40):
    """Random faces plus the cases that pin the semantics: invalid faces,
    back-faces (reversed winding), and exact duplicates (equal depth at
    every pixel: the lower index must win)."""
    rng = np.random.RandomState(seed)
    faces = random_faces(rng, batch, num_faces)
    faces[:, 3] = faces[:, 1]                 # exact tie: face 1 wins
    faces[:, 9] = faces[:, 2]                 # tie with face 2
    faces[:, 4] = faces[:, 4, ::-1]           # reversed winding
    faces[:, 7] = faces[:, 7, ::-1]
    valid = np.ones((batch, num_faces), bool)
    valid[:, 2] = False                       # its duplicate 9 stays valid
    valid[0, 5] = valid[-1, 11] = False
    return faces, valid


def _plain(faces, valid, isz, colors=None):
    out = TC.rasterize_face_index(
        torch.from_numpy(faces), torch.from_numpy(valid), isz,
        colors=None if colors is None else torch.from_numpy(colors))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("isz", [32, 64])
def test_plain_matches_xla(isz):
    """Face index and depth against `rasterize_face_maps(impl="xla")`.

    Tolerance: the two sides compute the same IEEE operations, except
    that XLA's CPU backend contracts a*b+c into an FMA in the barycentric
    weights w = a*x + b*y + c.  Its terms are up to ~100x larger than w,
    so one ulp of them moves w, and zp, by up to ~1e-6 relative.  That
    can only flip a pixel where two faces' depths tie to that precision:
    at most 2 such pixels are allowed per case, and depth gets rtol 1e-5
    on the pixels whose face agrees."""
    faces, valid = tricky_faces(seed=isz)
    fi_j, _, d_j, _ = JR.rasterize_face_maps(
        jnp.asarray(faces), jnp.asarray(valid), isz, return_weights=False,
        return_face_inv=False, impl="xla")
    fi_t, d_t = _plain(faces, valid, isz)
    fi_j, d_j = np.asarray(fi_j), np.asarray(d_j)
    assert fi_t.dtype == np.int32 and d_t.dtype == np.float32
    assert (fi_t != fi_j).sum() <= 2
    same = fi_t == fi_j
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-5)
    # the semantics the cases pin: a duplicate loses to the lower index,
    # invalid faces never win
    assert not (fi_t == 3).any() and not (fi_t == 2).any()
    assert not (fi_t[0] == 5).any() and not (fi_t[1] == 11).any()
    assert (fi_t == 1).any()
    np.testing.assert_array_equal(d_t[fi_t < 0], np.float32(TR.DEFAULT_FAR))


def test_plain_chunking_is_invisible():
    """The chunk size (memory budget) changes the loop, not the result:
    a later chunk wins only on strictly less depth."""
    faces, valid = tricky_faces(seed=3, batch=1, num_faces=33)
    f, v = torch.from_numpy(faces), torch.from_numpy(valid)
    ref = TR.rasterize_face_maps(f, v, 32, budget=1 << 30)
    for budget in (1, 1024 * 5, 1024 * 16):
        got = TR.rasterize_face_maps(f, v, 32, budget=budget)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("version", [1, 3])
def test_plain_matches_pallas_interp(version):
    """The TPU kernel's own function (interpret mode, as
    tests/test_rasterize.py runs it) at 128^2: face index equal; depth
    rtol 1e-4, the tolerance those tests give (the kernels interpolate
    1/z, rounding differs from the w-weighted form in the last ulps)."""
    rng = np.random.RandomState(0)
    faces = random_faces(rng, batch=2, num_faces=37)
    valid = np.ones((2, 37), bool)
    valid[0, 5] = valid[1, 11] = False
    fi_p, _, d_p, _ = JR.rasterize_face_maps(
        jnp.asarray(faces), jnp.asarray(valid), 128, return_weights=False,
        return_face_inv=False, impl="pallas_interp", version=version)
    fi_t, d_t = _plain(faces, valid, 128)
    np.testing.assert_array_equal(fi_t, np.asarray(fi_p))
    hit = fi_t >= 0
    np.testing.assert_allclose(d_t[hit], np.asarray(d_p)[hit], rtol=1e-4)


def test_gather_face_colors_exact():
    """Flat colours are the winner's exact fp32 colour, planar, 0 on
    background, equal to the JAX package's gather bit for bit."""
    faces, valid = tricky_faces(seed=5)
    rng = np.random.RandomState(1)
    colors = rng.uniform(-1, 1, faces.shape[:2] + (3,)).astype(np.float32)
    fi_t, _, rgb_t = _plain(faces, valid, 48, colors)
    want = JR._gather_face_colors(jnp.asarray(fi_t), jnp.asarray(colors),
                                  None)
    np.testing.assert_array_equal(rgb_t, np.asarray(want).transpose(0, 3, 1, 2))
    assert (rgb_t.transpose(0, 2, 3, 1)[fi_t < 0] == 0).all()


def test_wrapper_dispatches_cpu_to_plain():
    """A CPU tensor runs the plain version and never counts a kernel
    launch; _rasterize_sorted returns original face order (perm None)."""
    faces, valid = tricky_faces(seed=7, batch=1, num_faces=12)
    calls0 = TR.rasterize_face_maps.calls
    launches0 = TC.rasterize_face_index_cuda.launches
    fi, depth, perm = TR._rasterize_sorted(
        torch.from_numpy(faces), torch.from_numpy(valid), 16,
        TR.DEFAULT_NEAR, TR.DEFAULT_FAR)
    assert perm is None and fi.shape == (1, 16, 16)
    assert TR.rasterize_face_maps.calls == calls0 + 1
    assert TC.rasterize_face_index_cuda.launches == launches0
    with pytest.raises(ValueError):
        TC.rasterize_face_index_cuda(torch.from_numpy(faces), None, 16)


def _bin_members(bins, num_faces, isz):
    """member [B, F, T] bool: face f is in tile t's list or in the wide
    list of its image (`Bins` read back as sets)."""
    B = bins.tile_off.shape[0]
    T = TC.tile_grid(isz) ** 2
    member = torch.zeros(B, num_faces, T, dtype=torch.bool)
    for b in range(B):
        off = bins.tile_off[b].long()
        tid = torch.repeat_interleave(torch.arange(T), off[1:] - off[:-1])
        member[b, bins.tile_faces[b, :int(off[-1])].long(), tid] = True
        member[b, bins.wide_faces[b, :int(bins.wide_n[b])].long()] = True
    return member


def _accepted_outside_boxes(faces, isz):
    """(number of (face, pixel) pairs the plain inside test accepts, number
    of those outside the face's kernel box or missing from the face lists
    of the pixel's tile)."""
    f = torch.from_numpy(faces)
    rec, bbox = TC.pack_faces(f, None, isz)
    assert rec.shape == faces.shape[:2] + (TC.RECORD,)
    assert bbox.dtype == torch.int32
    ff, _, ok = TR.face_setup(f, None, isz)
    xp, _ = TR.pixel_centers(isz, "cpu")
    XP, YP = xp[None, None, None, :], xp[None, None, :, None]
    x = [ff[..., k, 0][..., None, None] for k in range(3)]
    y = [ff[..., k, 1][..., None, None] for k in range(3)]
    inside = (((YP - y[0]) * (x[1] - x[0]) >= (XP - x[0]) * (y[1] - y[0]))
              & ((YP - y[1]) * (x[2] - x[1]) >= (XP - x[1]) * (y[2] - y[1]))
              & ((YP - y[2]) * (x[0] - x[2]) >= (XP - x[2]) * (y[0] - y[2])))
    b, fidx, py, px = torch.nonzero(inside & ok[..., None, None],
                                    as_tuple=True)
    box = bbox[b, fidx]
    bad = int((~((box[:, 0] <= px) & (px <= box[:, 1])
                 & (box[:, 2] <= py) & (py <= box[:, 3]))).sum())
    member = _bin_members(TC.bin_faces_plain(bbox, isz), faces.shape[1],
                          isz)
    tile = (py // TC.TILE) * TC.tile_grid(isz) + px // TC.TILE
    bad += int((~member[b, fidx, tile]).sum())
    # faces the plain version rejects outright get an empty box
    assert (bbox[..., 0][~ok] > bbox[..., 1][~ok]).all()
    return len(b), bad


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_cull_is_conservative(seed):
    """The kernel's per-face pixel boxes (pack_faces) and the tile lists
    binned from them may only cull pairs the plain version rejects: every
    (face, pixel) its inside test accepts lies inside the face's box, and
    the face is in the list of the pixel's tile or in the wide list.
    Random faces,
    faces reaching far off screen, reversed windings and slivers down to a
    1e-7-wide one, whose rounded edge tests accept pixels along their
    line beyond the vertices."""
    rng = np.random.RandomState(seed)
    faces = random_faces(rng, batch=2, num_faces=300)
    faces[:, :40, :, :2] *= 6.0                      # far off screen
    a, b = faces[:, 40:100, 0, :2], faces[:, 40:100, 1, :2]
    t = rng.uniform(0.1, 0.9, (2, 60, 1)).astype(np.float32)
    width = np.float32(10.0) ** -rng.randint(2, 8, (2, 60, 1))
    faces[:, 40:100, 2, :2] = a * t + b * (1 - t) + width * rng.normal(
        size=(2, 60, 2)).astype(np.float32)          # slivers
    faces[:, 100:200] = np.where(faces[:, 100:200, :1, 0:1] > 0,
                                 faces[:, 100:200], faces[:, 100:200, ::-1])
    n, bad = _accepted_outside_boxes(faces, 40)
    assert n > 0 and bad == 0


def test_kernel_cull_is_conservative_at_768():
    """Slivers of every width at the main path's raster size (those whose
    box is the whole image go to the wide list)."""
    rng = np.random.RandomState(2)
    faces = random_faces(rng, batch=1, num_faces=24)
    a, b = faces[:, :, 0, :2], faces[:, :, 1, :2]
    width = np.float32(10.0) ** -np.arange(1, 9, dtype=np.float32)
    faces[:, :, 2, :2] = (a + b) / 2 + np.repeat(width, 3)[None, :, None] \
        * rng.normal(size=(1, 24, 2)).astype(np.float32)
    n, bad = _accepted_outside_boxes(faces, 768)
    assert n > 0 and bad == 0


def sliver_faces(seed, batch, num_faces, isz):
    """tricky_faces with faces 1 and 3 front-facing, plus, in face 6 of
    every image, a front-facing, non-degenerate sliver across the image
    whose box is the whole image (its cross product's lower bound is
    <= 0), and in face 8 a face far off screen."""
    faces, valid = tricky_faces(seed, batch, num_faces)
    # the duplicates 1 and 3 front-facing, so that their depths tie
    back = ~TR._frontface(torch.from_numpy(faces[:, 1])).numpy()
    faces[back, 1] = faces[back, 1, ::-1]
    faces[:, 3] = faces[:, 1]
    a = np.asarray([-0.9, -0.8], np.float32)
    c = np.asarray([0.9, 0.85], np.float32)
    for off, tri in ((o, t) for o in (1e-7, 2e-7, 4e-7, 8e-7)
                     for t in ("amc", "acm")):
        m = (a + c) / 2 + np.float32(off)
        faces[:, 6, :, :2] = np.stack([dict(a=a, m=m, c=c)[k] for k in tri])
        _, box = TC.pack_faces(torch.from_numpy(faces), None, isz)
        if (box[:, 6] == torch.tensor([0, isz - 1, 0, isz - 1])).all():
            break
    else:
        raise AssertionError("no whole-image sliver found")
    faces[:, 8, :, :2] += 5.0
    return faces, valid


@pytest.mark.parametrize("isz", [40, 100, 144, 200])
def test_bin_lists_match_boxes(isz):
    """bin_faces_plain (the bin kernel's plain version), read as sets: each
    tile's list holds exactly the faces whose pack_faces box touches the
    tile and spans at most K tiles; each wide list exactly the faces over
    K tiles (the whole-image sliver among them from 144^2, 9 x 9 tiles, on);
    faces with an empty box (invalid, back-facing, off screen) nowhere.
    Against a loop over the faces in numpy."""
    faces, valid = sliver_faces(isz, 2, 40, isz)
    _, bbox = TC.pack_faces(torch.from_numpy(faces), torch.from_numpy(valid),
                            isz)
    bins = TC.bin_faces_plain(bbox, isz)
    member = _bin_members(bins, 40, isz).numpy()
    n_tiles = TC.tile_grid(isz)
    want = np.zeros_like(member)
    want_wide = np.zeros((2, 40), bool)
    for b in range(2):
        for f in range(40):
            x0, x1, y0, y1 = bbox[b, f].tolist()
            if x0 > x1 or y0 > y1:
                continue
            tiles = [ty * n_tiles + tx
                     for ty in range(y0 // TC.TILE, y1 // TC.TILE + 1)
                     for tx in range(x0 // TC.TILE, x1 // TC.TILE + 1)]
            if len(tiles) > TC.MAX_TILES:
                want_wide[b, f] = True
                want[b, f] = True
            else:
                want[b, f, tiles] = True
    np.testing.assert_array_equal(member, want)
    for b in range(2):
        wide = bins.wide_faces[b, :int(bins.wide_n[b])].numpy()
        np.testing.assert_array_equal(np.sort(wide), np.nonzero(want_wide[b])[0])
    off = bins.tile_off.numpy()
    assert (np.diff(off, axis=1) >= 0).all() and off[:, 0].tolist() == [0, 0]
    assert not member[:, 2].any() and not member[:, 8].any()
    # the sliver's box is the whole image
    assert (bbox[:, 6] == torch.tensor([0, isz - 1, 0, isz - 1])).all()
    assert want_wide[:, 6].all() == (n_tiles ** 2 > TC.MAX_TILES)


@pytest.mark.parametrize("isz", [40, 100, 144, 200])
def test_binned_walk_matches_plain(isz):
    """The raster kernel's scheme on the CPU: each pixel walks only its
    tile's list and the wide list, in any order, and keeps the
    lexicographic minimum of (depth, face index) over the faces that cover
    it with a depth inside (near, far).  Bit-equal to rasterize_face_maps
    (ascending faces, strictly smaller depth wins), exact depth ties
    included (faces 1 and 3 are duplicates, so are 2 and 9, with 2
    invalid).  The depth of each (face, pixel) pair is the plain version's
    own, rasterizing one face at a time.  From 144^2 (9 x 9 tiles) on,
    faces over K tiles walk from the wide list; 100^2 and 200^2 have ragged
    tiles."""
    faces, valid = sliver_faces(isz + 1, 2, 40, isz)
    f, v = torch.from_numpy(faces), torch.from_numpy(valid)
    fi_p, d_p = TR.rasterize_face_maps(f, v, isz)
    one = [TR.rasterize_face_maps(f[:, k:k + 1], v[:, k:k + 1], isz)
           for k in range(40)]
    cover = torch.stack([o[0] == 0 for o in one], 1).reshape(2, 40, -1)
    zp = torch.stack([o[1] for o in one], 1).reshape(2, 40, -1)
    _, bbox = TC.pack_faces(f, v, isz)
    bins = TC.bin_faces_plain(bbox, isz)
    member = _bin_members(bins, 40, isz)
    py, px = torch.meshgrid(torch.arange(isz), torch.arange(isz),
                            indexing="ij")
    tile = ((py // TC.TILE) * TC.tile_grid(isz) + px // TC.TILE).reshape(-1)
    cand = cover & member[:, :, tile]
    # the walk of a candidate list in a shuffled order
    order = torch.from_numpy(np.random.RandomState(isz).permutation(40))
    best_z = torch.full((2, isz * isz), TR.DEFAULT_FAR)
    best = torch.full((2, isz * isz), -1, dtype=torch.int32)
    for k in order.tolist():
        z = zp[:, k]
        take = cand[:, k] & ((z < best_z) | ((z == best_z) & (k < best)))
        best_z = torch.where(take, z, best_z)
        best = torch.where(take, torch.full_like(best, k), best)
    assert torch.equal(best.reshape(2, isz, isz), fi_p)
    assert torch.equal(best_z.reshape(2, isz, isz), d_p)
    # pixels where two candidates tie at the winning depth
    ties = ((cand & (zp == best_z[:, None])).sum(1) >= 2).sum()
    assert ties > 0 and not (fi_p == 3).any() and not (fi_p == 2).any()
    assert (bins.wide_n > 0).all() == (TC.tile_grid(isz) ** 2 > TC.MAX_TILES)

"""The port's silhouette gradient (sdn3d_tpu_torch/ops/rasterize.py
backward, geometry/camera.vertices_to_faces_adj, render/renderer.render),
and render()'s depth and normal maps with their gradients, against the
JAX package's on the same seeded inputs, on the CPU.  The
CUDA kernels' plain versions are what runs here; tests/test_torch_cuda.py
holds the kernels against them on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from sdn3d_tpu.data.synthetic import make_sphere_mesh
from sdn3d_tpu.geometry import camera as JC
from sdn3d_tpu.geometry.assets import build_mesh_bank
from sdn3d_tpu.ops import rasterize as JR
from sdn3d_tpu.ops import rasterize_pallas as JRP
from sdn3d_tpu.render import RenderType as JRenderType
from sdn3d_tpu.render import render as j_render
from sdn3d_tpu_torch.geometry import camera as TCam
from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.ops import rasterize_cuda as TC
from sdn3d_tpu_torch.render.renderer import RenderType, render
from tests import nmr_oracle as oracle

EPS = TR.DEFAULT_EPS


def random_faces(rng, batch=2, num_faces=12, z_range=(1.5, 6.0)):
    """Random triangles in front of the camera, normalized coords."""
    xy = rng.uniform(-1.2, 1.2, size=(batch, num_faces, 3, 2))
    z = rng.uniform(*z_range, size=(batch, num_faces, 3, 1))
    return np.concatenate([xy, z], axis=-1).astype(np.float32)


def _scene(seed, batch, num_faces, isz):
    """Faces, validity (one invalid face per image), the forward's face
    index and alpha, and a random cotangent."""
    rng = np.random.RandomState(seed)
    faces = random_faces(rng, batch, num_faces)
    valid = np.ones((batch, num_faces), bool)
    valid[:, 3] = False
    fi, _ = TR.rasterize_face_maps(torch.from_numpy(faces),
                                   torch.from_numpy(valid), isz)
    alpha = (fi >= 0).float()
    cot = torch.from_numpy(
        np.random.RandomState(seed + 1).randn(batch, isz, isz)
        .astype(np.float32))
    return faces, valid, fi, alpha, cot


def _invariants(faces, fi, isz, axis):
    """The port's invariant stack for one axis."""
    pp_px = TR.face_pixel_coords(torch.from_numpy(faces), fi, isz)
    return TR.edge_invariant_stack(pp_px, fi >= 0, isz, axis)


def test_edge_invariants_match_jax():
    """The 18 invariant planes of both axes against JAX's
    `_edge_invariants` on the same gathered coordinates.  Equal but for
    the last ulp of d1_cross and the k factors (XLA's CPU backend fuses
    slope * (d0 - Au) + Av into an FMA and may divide by a reciprocal):
    rtol 1e-6; the integer-valued planes (direction, j_gate,
    is_in_pixel) exactly."""
    isz = 32
    faces, _, fi, _, _ = _scene(0, 2, 13, isz)
    B, F = faces.shape[:2]
    pp = 0.5 * (jnp.asarray(faces)[..., :2] * isz + isz - 1)
    hit = np.asarray(fi) >= 0
    fi_c = np.where(hit, np.asarray(fi), 0)
    pp_px = jax.vmap(lambda pb, fb: pb[fb])(pp, jnp.asarray(fi_c))
    yi = jnp.arange(isz, dtype=jnp.float32)[None, :, None]
    xi = jnp.arange(isz, dtype=jnp.float32)[None, None, :]
    for axis, (u, v, d0, d1) in enumerate(
            [(0, 1, xi, yi), (1, 0, yi, xi)]):
        got = _invariants(faces, fi, isz, axis).numpy()
        for e in range(3):
            E = JR._edge_invariants(pp_px[..., u], pp_px[..., v], d0, d1,
                                    jnp.asarray(hit), isz, axis, e)
            want = [E["d1_cross"], E["direction"], E["kA"], E["kB"],
                    E["j_gate"], E["is_in_pixel"].astype(jnp.float32)]
            for r, w in enumerate(want):
                w = np.broadcast_to(np.asarray(w), got.shape[:1]
                                    + got.shape[2:])
                g = got[:, 6 * e + r]
                if r in (1, 4, 5):
                    np.testing.assert_array_equal(g[hit], w[hit])
                else:
                    np.testing.assert_allclose(g[hit], w[hit], rtol=1e-6,
                                               atol=1e-6)


def _jax_invariants(faces, fi, isz, axis):
    """JAX's own invariant stack for one axis, [B, 18, S, S] in image
    layout: `_edge_invariants` over JAX's gather of the face table."""
    pp = 0.5 * (jnp.asarray(faces)[..., :2] * isz + isz - 1)
    hit = np.asarray(fi) >= 0
    pp_px = jax.vmap(lambda pb, fb: pb[fb])(pp, jnp.asarray(
        np.where(hit, np.asarray(fi), 0)))
    yi = jnp.arange(isz, dtype=jnp.float32)[None, :, None]
    xi = jnp.arange(isz, dtype=jnp.float32)[None, None, :]
    u, v, d0, d1 = (0, 1, xi, yi) if axis == 0 else (1, 0, yi, xi)
    planes = []
    for e in range(3):
        E = JR._edge_invariants(pp_px[..., u], pp_px[..., v], d0, d1,
                                jnp.asarray(hit), isz, axis, e)
        planes += [E["d1_cross"], E["direction"], E["kA"], E["kB"],
                   E["j_gate"], E["is_in_pixel"].astype(jnp.float32)]
    return np.stack([np.broadcast_to(np.asarray(p), hit.shape)
                     for p in planes], axis=1)


@pytest.mark.parametrize("walk,fused", [pytest.param(8, False, id="8"),
                                        pytest.param(24, False, id="24"),
                                        pytest.param(24, True, id="fused-24")])
def test_walk_plain_matches_pallas_interp(walk, fused):
    """The port's plain walk against the TPU kernel `walk_grads_pallas` in
    interpret mode, as tests/test_rasterize.py runs it, both axes at 128^2
    (the TPU kernel walks along dim 1: axis 1 runs on transposed planes).

    walk_grads_plain on the same invariant planes: bit-equal (the same
    IEEE operations on both sides; the zero halo and torch.roll differ only
    in reads the gates discard).  fused: the fused walk kernel's plain
    version `walk_grads_faces_plain`, which builds its own invariants from
    the face table, against the TPU kernel fed JAX's own `_edge_invariants`
    stack: rtol 1e-6, because XLA's CPU backend may fuse d1_cross into an
    FMA (test_edge_invariants_match_jax), which moves a distance term by
    an ulp (on this input the two agree bit for bit)."""
    isz = 128
    faces, _, fi, alpha, cot = _scene(1, 2, 19, isz)
    for axis in range(2):
        if fused:
            got = TR.walk_grads_faces_plain(
                alpha, cot, TR.face_pixel_table(torch.from_numpy(faces), isz),
                fi, walk, EPS, axis).numpy()
            i = _jax_invariants(faces, fi, isz, axis)
        else:
            inv = _invariants(faces, fi, isz, axis)
            got = TR.walk_grads_plain(alpha, cot, inv, walk, EPS,
                                      axis).numpy()
            i = inv.numpy()
        a, g = alpha.numpy(), cot.numpy()
        if axis == 1:
            a, g, i = a.transpose(0, 2, 1), g.transpose(0, 2, 1), \
                i.transpose(0, 1, 3, 2)
        want = np.asarray(JRP.walk_grads_pallas(
            jnp.asarray(a), jnp.asarray(g), jnp.asarray(i), walk, EPS,
            interpret=True))
        if axis == 1:
            want = want.transpose(0, 1, 3, 2)
        assert np.abs(want).max() > 0
        if fused:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("isz", [48, 100])
@pytest.mark.parametrize("walk", [8, 24, 0])
def test_walk_faces_plain_matches_stack_walk(isz, walk):
    """The fused walk kernel's plain version (face table in, invariants
    built inside) against the three steps it fuses, face_pixel_coords +
    edge_invariant_stack + walk_grads_plain, both axes: bit-equal.  walk 0
    is the whole image (the exact reference semantics); 100^2 has ragged
    64 x 32 kernel tiles."""
    faces, _, fi, alpha, cot = _scene(isz + walk, 2, 23, isz)
    n = walk or isz
    pp = TR.face_pixel_table(torch.from_numpy(faces), isz)
    for axis in range(2):
        got = TR.walk_grads_faces_plain(alpha, cot, pp, fi, n, EPS, axis)
        want = TR.walk_grads_plain(alpha, cot, _invariants(faces, fi, isz,
                                                           axis),
                                   n, EPS, axis)
        assert want.abs().max() > 0
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("walk,impl,isz", [(0, "xla", 48), (8, "xla", 48),
                                           (8, "pallas", 128)])
def test_silhouette_grad_matches_jax_xla_loop(walk, impl, isz):
    """`silhouette_grad_pixelwise` (the fused walk's plain version + plain
    reduction, as the CPU runs it) against
    JAX's `_silhouette_grad_pixelwise` on the same face index, with its
    XLA roll loop (walk 0, exact, and 8) and with the TPU walk kernel in
    interpret mode (walk 8; it needs a multiple of 128).  rtol 1e-5 on
    the face gradients: the walks agree bit for bit (previous test); the
    pixel->face sums may add in another order."""
    faces, valid, fi, alpha, cot = _scene(2, 2, 17, isz)
    got = TR.silhouette_grad_pixelwise(
        torch.from_numpy(faces), fi, alpha, cot, isz, EPS, walk=walk).numpy()
    want = np.asarray(JR._silhouette_grad_pixelwise(
        jnp.asarray(faces), jnp.asarray(valid), jnp.asarray(fi.numpy()),
        jnp.asarray(alpha.numpy()), jnp.asarray(cot.numpy()), isz, EPS,
        walk=walk, force_walk_impl=impl))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert (got[..., 2] == 0).all() and (got[:, 3] == 0).all()


def test_reduction_plain_matches_pallas_and_numpy():
    """The plain pixel->face reduction (the CUDA reduction kernel's plain
    version) against `segment_face_grads_pallas` in interpret mode and a
    numpy add.at, on random planes (tests/test_rasterize.py:260-285).
    rtol/atol 1e-4: the three sum in different orders."""
    B, F, isz = 2, 53, 128
    rng = np.random.RandomState(4)
    faces = random_faces(rng, B, F)
    fi, _ = TR.rasterize_face_maps(torch.from_numpy(faces), None, isz)
    acc_x = rng.randn(B, 3, isz, isz).astype(np.float32)
    acc_y = rng.randn(B, 3, isz, isz).astype(np.float32)
    got = TR.segment_face_grads_plain(torch.from_numpy(acc_x),
                                      torch.from_numpy(acc_y), fi, F).numpy()
    planes = [-p for v in range(3) for p in (acc_x[:, v], acc_y[:, v])]
    acc8 = np.stack(planes + [np.zeros_like(acc_x[:, 0])] * 2, axis=1)
    aux, cb = JRP.pack_seg_aux(jnp.asarray(faces), isz)
    pallas = np.asarray(JRP.segment_face_grads_pallas(
        jnp.asarray(acc8), jnp.asarray(fi.numpy()), aux, cb, isz,
        interpret=True))[:, :F, :6]
    hit = fi.numpy() >= 0
    seg = (np.where(hit, fi.numpy(), 0) + np.arange(B)[:, None, None] * F
           ).reshape(-1)
    ref = np.zeros((B * F, 6), np.float64)
    for c in range(6):
        np.add.at(ref[:, c], seg, np.where(hit, planes[c], 0.0).reshape(-1))
    ref = ref.reshape(B, F, 6)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("walk", [0, 8])
def test_silhouette_vjp_matches_jax(walk):
    """SilhouetteFn (forward rasterizer + backward) against `jax.vjp` of
    `_make_silhouette_fn`: alpha equal; face gradients to rtol 1e-5 (the
    same arithmetic; reduction order may differ)."""
    isz = 40
    faces, valid, _, _, cot = _scene(5, 2, 19, isz)
    sil = JR._make_silhouette_fn(isz, TR.DEFAULT_NEAR, TR.DEFAULT_FAR, EPS,
                                 walk)
    a_j, vjp = jax.vjp(lambda f: sil(f, jnp.asarray(valid)),
                       jnp.asarray(faces))
    (g_j,) = vjp(jnp.asarray(cot.numpy()))
    ft = torch.from_numpy(faces).requires_grad_(True)
    a_t = TR.SilhouetteFn.apply(ft, torch.from_numpy(valid), isz,
                                TR.DEFAULT_NEAR, TR.DEFAULT_FAR, EPS, walk)
    (g_t,) = torch.autograd.grad(a_t, ft, cot)
    np.testing.assert_array_equal(a_t.detach().numpy(), np.asarray(a_j))
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5,
                               atol=1e-6 * np.abs(g_j).max())


def test_silhouette_vjp_matches_nmr_oracle():
    """Against the loop-based numpy oracle of the reference's CUDA
    backward (tests/nmr_oracle.py), exact walk; rtol/atol 1e-3 as
    tests/test_rasterize.py gives the JAX package (the oracle sums in
    float64)."""
    faces = random_faces(np.random.RandomState(3), batch=1, num_faces=5)
    isz = 16
    cot = np.random.RandomState(1).randn(1, isz, isz).astype(np.float32)
    ft = torch.from_numpy(faces).requires_grad_(True)
    a = TR.SilhouetteFn.apply(ft, torch.ones(1, 5, dtype=torch.bool), isz,
                              TR.DEFAULT_NEAR, TR.DEFAULT_FAR, EPS, 0)
    (g,) = torch.autograd.grad(a, ft, torch.from_numpy(cot))
    fi_o, _, _, _ = oracle.forward_maps(faces, image_size=isz)
    alpha_o = (fi_o >= 0).astype(np.float32)
    np.testing.assert_array_equal(a.detach().numpy(), alpha_o)
    g_o = oracle.silhouette_backward(faces, fi_o, alpha_o, cot,
                                     image_size=isz, eps=EPS)
    assert np.abs(g_o).max() > 0
    np.testing.assert_allclose(g.numpy(), g_o, rtol=1e-3, atol=1e-3)


def _mesh_batch(batch=2, seed=0):
    """Posed spheres (make_sphere_mesh(4, 8)) in front of the camera, with
    the bank's adjacency table."""
    v, f = make_sphere_mesh(4, 8)
    bank = build_mesh_bank([(v, f)])
    rng = np.random.RandomState(seed)
    verts = np.stack([bank.vertices[0] * rng.uniform(1.0, 2.0, 3)
                      + [rng.uniform(-.2, .2), rng.uniform(-.2, .2),
                         -rng.uniform(2.2, 3.0)]
                      for _ in range(batch)]).astype(np.float32)
    faces = np.repeat(bank.faces, batch, 0)
    valid = np.repeat(bank.face_valid, batch, 0)
    adj = np.repeat(bank.adjacency, batch, 0)
    return verts, faces, valid, adj


@pytest.mark.parametrize("fill_back", [False, True])
def test_vertices_to_faces_adj_backward_matches_jax(fill_back):
    """The gather-over-adjacency backward against JAX's custom VJP (and
    the forward against the plain gather).  rtol 1e-6: the per-vertex sum
    over its faces may add in another order."""
    verts, faces, _, adj = _mesh_batch()
    if fill_back:
        faces = np.concatenate([faces, faces[:, :, ::-1]], axis=1)
    cot = np.random.RandomState(3).randn(*faces.shape, 3).astype(np.float32)
    fv_j, vjp = jax.vjp(lambda v: JC.vertices_to_faces_adj(
        v, jnp.asarray(faces), jnp.asarray(adj), fill_back),
        jnp.asarray(verts))
    (g_j,) = vjp(jnp.asarray(cot))
    vt = torch.from_numpy(verts).requires_grad_(True)
    fv_t = TCam.vertices_to_faces_adj(vt, torch.from_numpy(faces),
                                      torch.from_numpy(adj), fill_back)
    (g_t,) = torch.autograd.grad(fv_t, vt, torch.from_numpy(cot))
    np.testing.assert_array_equal(fv_t.detach().numpy(), np.asarray(fv_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("grad_walk,aa", [(0, True), (8, False)])
def test_render_silhouette_and_grad_match_jax(grad_walk, aa):
    """render(..., Silhouette, vertex_adjacency=...) and its gradient in
    the vertices against JAX's render at 32^2 with per-image viewing
    angles.  Silhouettes equal; vertex gradients to rtol 1e-4 of their
    largest value (the camera and perspective arithmetic differ from XLA's
    CPU code by an ulp, which moves a walk term by as much)."""
    verts, faces, valid, adj = _mesh_batch(seed=1)
    ang = np.asarray([27.0, 31.0], np.float32)
    cot = np.random.RandomState(2).randn(2, 1, 32, 32).astype(np.float32)
    kw = dict(image_size=32, anti_aliasing=aa, grad_walk=grad_walk)

    def j_fn(v):
        return j_render(v, jnp.asarray(faces), JRenderType.Silhouette,
                        jnp.asarray(valid), viewing_angle=jnp.asarray(ang),
                        vertex_adjacency=jnp.asarray(adj), **kw)

    s_j, vjp = jax.vjp(j_fn, jnp.asarray(verts))
    (g_j,) = vjp(jnp.asarray(cot))
    vt = torch.from_numpy(verts).requires_grad_(True)
    s_t = render(vt, torch.from_numpy(faces), RenderType.Silhouette,
                 torch.from_numpy(valid), viewing_angle=torch.from_numpy(ang),
                 vertex_adjacency=torch.from_numpy(adj), **kw)
    (g_t,) = torch.autograd.grad(s_t, vt, torch.from_numpy(cot))
    assert s_t.shape == (2, 1, 32, 32) and 0.05 < float(s_t.detach().mean()) < 0.95
    np.testing.assert_array_equal(s_t.detach().numpy(), np.asarray(s_j))
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                               atol=1e-4 * np.abs(g_j).max())


def test_render_other_types_not_ported():
    """render() of the RGB type (texture sampling and lighting) is ROADMAP
    A9's and raises naming it."""
    verts, faces, _, _ = _mesh_batch()
    with pytest.raises(NotImplementedError, match="A9"):
        render(torch.from_numpy(verts), torch.from_numpy(faces),
               RenderType.RGB)


@pytest.mark.parametrize("render_type,aa", [
    (RenderType.Depth, True), (RenderType.Depth, False),
    (RenderType.Normal, True), (RenderType.Normal, False)])
def test_render_depth_normal_and_grad_match_jax(render_type, aa):
    """render(..., Depth / Normal) and its gradient in the vertices against
    JAX's render at 32^2 with per-image viewing angles, with and without
    the adjacency gather.  Normal maps equal (the face index is equal and
    the colours are the normals of the same vertices); depth within 4e-6
    (measured 3.8e-6 with a background of 100: XLA's CPU code contracts
    the barycentric sums into FMAs and inverts by reciprocal, one ulp of
    the depth); vertex gradients within 2e-6 of their largest value
    (measured 1.6e-6)."""
    verts, faces, valid, adj = _mesh_batch(seed=1)
    ang = np.asarray([27.0, 31.0], np.float32)
    ch = 3 if render_type == RenderType.Normal else 1
    cot = np.random.RandomState(2).randn(2, ch, 32, 32).astype(np.float32)
    kw = dict(image_size=32, anti_aliasing=aa)

    def j_fn(v):
        return j_render(v, jnp.asarray(faces), JRenderType(int(render_type)),
                        jnp.asarray(valid), viewing_angle=jnp.asarray(ang),
                        **kw)

    m_j, vjp = jax.vjp(j_fn, jnp.asarray(verts))
    (g_j,) = vjp(jnp.asarray(cot))
    m_j, g_j = np.asarray(m_j), np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    for a in (None, torch.from_numpy(adj)):
        vt = torch.from_numpy(verts).requires_grad_(True)
        m_t = render(vt, torch.from_numpy(faces), render_type,
                     torch.from_numpy(valid),
                     viewing_angle=torch.from_numpy(ang),
                     vertex_adjacency=a, **kw)
        (g_t,) = torch.autograd.grad(m_t, vt, torch.from_numpy(cot))
        assert m_t.shape == (2, ch, 32, 32)
        if render_type == RenderType.Normal:
            np.testing.assert_array_equal(m_t.detach().numpy(), m_j)
            assert np.abs(m_j).max() > 0.5
        else:
            np.testing.assert_allclose(m_t.detach().numpy(), m_j, rtol=0,
                                       atol=4e-6)
            assert (m_j < 100).mean() > 0.05
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=2e-6 * np.abs(g_j).max())


def test_depth_vjp_face_grads_match_jax():
    """The depth VJP's face gradients (ops/rasterize.DepthFn:
    `_depth_grad` over the recomputed pixel attributes, summed per face in
    pixel order) against JAX's `_make_depth_fn` on 2 x 23 random faces at
    40^2: the depth within 1e-6, face gradients within 2e-7 of their
    largest value (measured 1.5e-7)."""
    rng = np.random.RandomState(0)
    faces = np.concatenate([rng.uniform(-1.2, 1.2, (2, 23, 3, 2)),
                            rng.uniform(1.5, 6.0, (2, 23, 3, 1))],
                           -1).astype(np.float32)
    valid = np.ones((2, 23), bool)
    valid[1, 4] = False
    cot = rng.randn(2, 40, 40).astype(np.float32)
    d_j, vjp = jax.vjp(lambda f: JR._make_depth_fn(40, 0.1, 100.0)(
        f, jnp.asarray(valid)), jnp.asarray(faces))
    (g_j,) = vjp(jnp.asarray(cot))
    g_j = np.asarray(g_j)
    ft = torch.from_numpy(faces).requires_grad_(True)
    d_t = TR.DepthFn.apply(ft, torch.from_numpy(valid), 40, 0.1, 100.0)
    (g_t,) = torch.autograd.grad(d_t, ft, torch.from_numpy(cot))
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j),
                               rtol=0, atol=1e-6)
    assert np.abs(g_j).max() > 1 and not g_t[1, 4].any()
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                               atol=2e-7 * np.abs(g_j).max())


def test_segment_sum_sorted_adds_in_row_order():
    """segment_sum_sorted: each segment's rows added one after another in
    their order (the same bits as a sequential float32 loop), empty
    segments zero; and the colour gather's backward (_FaceRowGather) is
    the per-face sum of the pixels' cotangents."""
    rng = np.random.RandomState(1)
    vals = (rng.randn(500, 3) * 10.0 ** rng.randint(-3, 4, (500, 1))
            ).astype(np.float32)
    seg = rng.randint(0, 40, 500)
    seg[seg == 7] = 8
    got = TR.segment_sum_sorted(torch.from_numpy(vals),
                                torch.from_numpy(seg), 41).numpy()
    want = np.zeros((41, 3), np.float32)
    for v, s in zip(vals, seg):
        want[s] += v
    np.testing.assert_array_equal(got, want)
    colors = torch.from_numpy(rng.randn(2, 6, 3).astype(np.float32)
                              ).requires_grad_(True)
    fi = torch.from_numpy(rng.randint(-1, 6, (2, 5, 5)).astype(np.int32))
    rgb = TR._gather_face_colors(fi, colors)
    cot = torch.from_numpy(rng.randn(2, 5, 5, 3).astype(np.float32))
    (g,) = torch.autograd.grad(rgb, colors, cot)
    want = np.zeros((2, 6, 3), np.float32)
    for b in range(2):
        for y in range(5):
            for x in range(5):
                if fi[b, y, x] >= 0:
                    want[b, fi[b, y, x]] += cot[b, y, x].numpy()
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-6)


def test_backward_wrappers_dispatch_cpu_to_plain():
    """On CPU tensors the walk and reduction wrappers run the plain
    versions (the walk: the fused kernel's plain version, which builds the
    invariant stack) and count no kernel launch; the kernel launchers
    refuse CPU tensors."""
    isz = 24
    faces, valid, fi, alpha, cot = _scene(6, 1, 9, isz)
    pp = TR.face_pixel_table(torch.from_numpy(faces), isz)
    calls = (TR.walk_grads_plain.calls, TR.segment_face_grads_plain.calls,
             TR.edge_invariant_stack.calls)
    launches = (TC.walk_grads_cuda.launches,
                TC.segment_face_grads_cuda.launches)
    acc = TC.walk_grads(alpha, cot, pp, fi, 4, EPS)
    g = TC.segment_face_grads(acc[1], acc[0], fi, faces.shape[1])
    assert len(TC.rasterize_face_index(torch.from_numpy(faces),
                                       torch.from_numpy(valid), isz)) == 2
    assert acc.shape == (2, 1, 3, isz, isz) and g.shape == (1, 9, 6)
    assert (TR.walk_grads_plain.calls, TR.segment_face_grads_plain.calls,
            TR.edge_invariant_stack.calls) \
        == (calls[0] + 2, calls[1] + 1, calls[2] + 2)
    assert (TC.walk_grads_cuda.launches,
            TC.segment_face_grads_cuda.launches) == launches
    with pytest.raises(ValueError):
        TC.walk_grads_cuda(alpha, cot, pp, fi, 4, EPS)
    with pytest.raises(ValueError):
        TC.segment_face_grads_cuda(acc[1], acc[0], fi, 9)
    with pytest.raises(ValueError):
        TC.won_pixel_boxes_cuda(fi, 9)


@pytest.mark.parametrize("isz,num_faces", [(40, 23), (57, 61)])
def test_won_pixel_boxes_match_numpy(isz, num_faces):
    """won_pixel_boxes (the plain version of the reduction's box pass)
    against a numpy min / max over the pixels of each face: exact.  Faces
    that win no pixel (invalid, hidden, off screen) get the empty box
    (S, -1, S, -1), and so does every face of a padded slot (an image of
    invalid faces, as the refinement's padded objects).  Every won pixel
    lies in its face's box; 57^2 is not a multiple of any tile."""
    faces, valid, fi, _, _ = _scene(isz, 3, num_faces, isz)
    fi[2] = -1                                   # a padded slot
    got = TR.won_pixel_boxes(fi, num_faces).numpy()
    want = np.tile(np.asarray([isz, -1, isz, -1], np.int32),
                   (3, num_faces, 1))
    f = fi.numpy()
    for b in range(3):
        for k in range(num_faces):
            ys, xs = np.nonzero(f[b] == k)
            if len(xs):
                want[b, k] = [xs.min(), xs.max(), ys.min(), ys.max()]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    won = np.isin(np.arange(num_faces), f[0])
    assert won.any() and not won.all() and not won[3]
    assert (got[2] == [isz, -1, isz, -1]).all()

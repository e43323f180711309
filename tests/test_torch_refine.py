"""The port's silhouette refinement (geometric_main --num_opts N:
models/derenderer.render_blob(training=True), pipelines/derender_infer
refine_silhouettes / derender_image) against the JAX package's, on the
CPU, at the small shapes of tests/test_derender_infer.py, with the same
derenderer weights carried over by utils/port."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sdn3d_tpu.data.synthetic import make_sphere_mesh
from sdn3d_tpu.geometry.assets import build_mesh_bank
from sdn3d_tpu.models import derenderer as JD
from sdn3d_tpu.pipelines import derender_infer as JI
from sdn3d_tpu_torch.geometry.assets import build_mesh_bank as t_build_bank
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.ops import rasterize as TR
from sdn3d_tpu_torch.pipelines import derender_infer as TI
from sdn3d_tpu_torch.utils.port import derenderer_state_dict_from_jax

MESHES = [make_sphere_mesh(4, 8)] * 2
OPT_KEYS = TI._OPT_KEYS


@pytest.fixture(scope="module")
def setup():
    model = JD.Derenderer(num_classes=2)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)),
        jnp.zeros((1, 2)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = TD.Derenderer(num_classes=2)
    tmodel.load_state_dict(derenderer_state_dict_from_jax(variables))
    j_bank = JD.DeviceMeshBank.from_host(build_mesh_bank(MESHES))
    t_bank = TD.DeviceMeshBank.from_host(t_build_bank(MESHES), device="cpu")
    kw = dict(image_size=64, render_size=64, max_objects=4)
    return ((model, variables, j_bank, JI.DerenderInferConfig(**kw)),
            (tmodel.eval(), t_bank, TI.DerenderInferConfig(**kw)))


def fake_scene(h=96, w=160):
    """tests/test_derender_infer.py's frame: two cars with box masks."""
    rng = np.random.RandomState(0)
    image = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    rois = np.asarray([[20, 30, 60, 80], [40, 90, 85, 150]], np.float32)
    masks = np.zeros((2, 1, h, w), np.float32)
    for i, r in enumerate(rois):
        masks[i, 0, int(r[0]) + 5:int(r[2]) - 5, int(r[1]) + 5:int(r[3]) - 5] = 1
    return image, rois, masks, np.asarray([1, 2])


def _jax_start(setup):
    """JAX's encoded (unrefined) host blob, the mask crops and the ignore
    crops of fake_scene, as derender_encode builds them."""
    (jm, jv, jb, jc), _ = setup
    image, rois, masks, class_ids = fake_scene()
    objs, blob = JI.derender_encode(jv, jm, jb, image, class_ids, masks,
                                    rois, jc)
    ign_full = JI.build_default_ignores(
        masks, np.asarray(blob["_log_depths"])[:2],
        np.asarray(blob["_droi_norms"])[:2])
    ign = np.zeros((4, 1, 64, 64), np.float32)
    from sdn3d_tpu.data import vkitti as VK
    for i in range(2):
        ign[i, 0] = VK.transform_mask(ign_full[i, 0], rois[i], 64)
    mobjs = JI.prepare_objects(image, rois, masks, class_ids, jc)
    return {k: np.asarray(v) for k, v in blob.items()}, mobjs["masks"], ign


def test_build_default_ignores_and_mask_crops_match_jax(setup):
    """Ignore maps (numpy, the same operations) and the render_size mask
    crops of prepare_objects(with_masks=True): equal."""
    (_, _, _, jc), (_, _, tc) = setup
    image, rois, masks, class_ids = fake_scene()
    masks3 = np.concatenate([masks, masks[:1, :, ::-1]], 0)
    rng = np.random.RandomState(1)
    log_depths = rng.normal(0, 1, (3, 1)).astype(np.float32)
    droi = rng.uniform(0.1, 0.5, (3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        TI.build_default_ignores(masks3, log_depths, droi),
        JI.build_default_ignores(masks3, log_depths, droi))
    got = TI.prepare_objects(image, rois, masks, class_ids, tc,
                             with_masks=True)
    want = JI.prepare_objects(image, rois, masks, class_ids, jc)
    assert got["masks"].shape == (4, 1, 64, 64) and got["masks"].sum() > 0
    np.testing.assert_array_equal(got["masks"], want["masks"])
    assert "masks" not in TI.prepare_objects(image, rois, masks, class_ids,
                                             tc)


def test_adam_step_matches_optax():
    """Five steps of `adam_step` against optax.adam(3e-2) on the same
    gradients: parameters within 1 ulp (XLA's CPU backend may fuse the
    moment updates into FMAs)."""
    rng = np.random.RandomState(2)
    p0 = rng.normal(0, 1, (3, 7)).astype(np.float32)
    grads = [rng.normal(0, 10.0 ** -i, (3, 7)).astype(np.float32)
             for i in range(5)]
    opt = optax.adam(3e-2)
    pj, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    pt = torch.from_numpy(p0)
    mu, nu = torch.zeros_like(pt), torch.zeros_like(pt)
    for step, g in enumerate(grads, 1):
        upd, state = opt.update(jnp.asarray(g), state)
        pj = optax.apply_updates(pj, upd)
        pt, mu, nu = TI.adam_step(pt, torch.from_numpy(g), mu, nu, step,
                                  3e-2)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=np.spacing(np.abs(pj)).max())


def test_render_blob_training_gradients_match_jax(setup):
    """render_blob(training=True, force_no_sample=True): the differentiable
    silhouettes under the training camera, and the gradients they carry
    to theta / translation2d / log_scale / FFD, against JAX's on the same
    blob (the real slots of JAX's encoding).  Masks equal; each entry's
    gradient within 3% of its largest value and pointing the same way
    (cosine >= 0.999).  Why not tighter: the deformed vertices differ
    from XLA's in the last ulp (XLA sums the FFD product in four strided
    FMA accumulators; 179 of 240 coordinates here), and a vertex an ulp
    away can move a walk gate, whose term reaches diff/eps: measured, one
    slot's theta gradient moves by 1.4% of the largest entry, every other
    entry by <= 0.1%.  From equal vertices the walk agrees bit for bit
    (tests/test_torch_silhouette_grad.py)."""
    blob, masks, _ = _jax_start(setup)
    (_, _, jb, _), (_, tb, _) = setup
    blob = {k: v[:2] for k, v in blob.items()}
    target = masks[:2]

    def j_loss(p):
        b = {k: jnp.asarray(v) for k, v in blob.items()}
        b.update(p)
        out = JD.render_blob(b, jb, JD.TargetType.reproject, 64, 64,
                             training=True, force_no_sample=True)
        return jnp.mean((out["_masks"] - target) ** 2), out["_masks"]

    (_, m_j), g_j = jax.value_and_grad(j_loss, has_aux=True)(
        {k: jnp.asarray(blob[k]) for k in OPT_KEYS})
    bt = {k: torch.from_numpy(v) for k, v in blob.items()}
    params = {k: bt[k].clone().requires_grad_(True) for k in OPT_KEYS}
    bt.update(params)
    out = TD.render_blob(bt, tb, TD.TargetType.reproject, 64, 64,
                         training=True, force_no_sample=True)
    loss = torch.mean((out["_masks"] - torch.from_numpy(target)) ** 2)
    g_t = torch.autograd.grad(loss, [params[k] for k in OPT_KEYS])
    np.testing.assert_array_equal(out["_masks"].detach().numpy(),
                                  np.asarray(m_j))
    assert 0.05 < float(out["_masks"].detach().mean()) < 0.95
    for k, g in zip(OPT_KEYS, g_t):
        want = np.asarray(g_j[k])
        # every entry carries a gradient, finite and not all zero
        assert torch.isfinite(g).all() and (g != 0).any(), k
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=0.03 * np.abs(want).max(), err_msg=k)
        cos = (g.numpy() * want).sum() / np.linalg.norm(g.numpy()) \
            / np.linalg.norm(want)
        assert cos >= 0.999, (k, cos)
    with pytest.raises(NotImplementedError):
        TD.render_blob(bt, tb, TD.TargetType.reproject, 64, 64,
                       training=True)


def test_refine_one_step_matches_jax(setup):
    """One refinement step from JAX's encoded blob: the refined entries of
    the real slots within 1e-5 (measured: 1 ulp), the padded slots NaN on
    both sides only where JAX's are; then the refined blobs through
    derender_image's given-blob path give instance planes equal and
    normal/depth bytes within the ±1 allowance of
    tests/test_torch_derender_infer.py."""
    blob, masks, ign = _jax_start(setup)
    (jm, jv, jb, jc), (tm, tb, tc) = setup
    jc1 = dataclasses.replace(jc, num_opts=1)
    tc1 = dataclasses.replace(tc, num_opts=1)
    rj = JI.refine_silhouettes({k: jnp.asarray(v) for k, v in blob.items()},
                               jb, jnp.asarray(masks), jnp.asarray(ign), jc1)
    trace = []
    rt = TI.refine_silhouettes({k: torch.from_numpy(v)
                                for k, v in blob.items()}, tb,
                               torch.from_numpy(masks), torch.from_numpy(ign),
                               tc1, trace=trace)
    for k in OPT_KEYS:
        want = np.asarray(rj[k])
        assert np.abs(want[:2] - blob[k][:2]).max() > 1e-3, k   # it moved
        np.testing.assert_allclose(rt[k].numpy()[:2], want[:2], rtol=0,
                                   atol=1e-5, err_msg=k)
    assert len(trace) == 1 and trace[0].shape == (2, 4)
    image, rois, img_masks, class_ids = fake_scene()
    objs = JI.prepare_objects(image, rois, img_masks, class_ids, jc,
                              with_masks=False)
    want = JI.derender_image(jv, jm, jb, image, class_ids, img_masks, rois,
                             jc, encoded=(objs, {k: np.asarray(v)
                                                 for k, v in rj.items()}))
    got = TI.derender_image(tm, tb, image, class_ids, img_masks, rois, tc,
                            encoded=(objs, {k: v.numpy()
                                            for k, v in rt.items()}),
                            device="cpu")
    np.testing.assert_array_equal(got["instance_png"], want["instance_png"])
    for k in ("normal_png", "depth_png"):
        diff = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (k, diff.sum())


def test_refine_trace_sums_to_loss(setup):
    """The per-slot loss shares of `trace` add up to the loss of a batch
    without padded slots (two steps, real slots only)."""
    blob, masks, ign = _jax_start(setup)
    _, (_, tb, tc) = setup
    bt = {k: torch.from_numpy(v[:2]) for k, v in blob.items()}
    m, i = torch.from_numpy(masks[:2]), torch.from_numpy(ign[:2])
    trace = []
    TI.refine_silhouettes(bt, tb, m, i, dataclasses.replace(tc, num_opts=2),
                          trace=trace)
    out = TD.render_blob(bt, tb, TD.TargetType.reproject, 64, 64,
                         training=True, force_no_sample=True)
    loss0 = torch.mean(((out["_masks"] - m) ** 2 + 100.0 * torch.mean(
        bt["_ffd_coeffs"] ** 2)) * (1 - i))
    assert len(trace) == 2
    torch.testing.assert_close(trace[0].sum(), loss0, rtol=1e-5, atol=0)
    assert torch.isfinite(trace[1]).all()


@pytest.mark.parametrize("ffd_scale", [1.0, 0.0])
def test_refine_losses_follow_jax_over_ten_steps(setup, ffd_scale):
    """Ten refinement steps of the real slots of JAX's encoded blob, its
    FFD coefficients as encoded (scale 1) or zeroed (scale 0: as small as
    a random encoder gives them): the port's per-step loss (the sum of
    `trace`) against the losses JAX's `_refine_jit` returns.

    Allowed: steps 1-3 within 2e-4 relative (measured 5e-5), every step
    within 15% (measured 0.4% at scale 1, 8.9% at scale 0; the
    trajectories separate as in the end-to-end test below).  The shape
    of the curves is the point.  From the encoded coefficients the reg
    term dominates and both totals fall.  From zero coefficients the
    totals of both packages RISE above their start (measured: JAX 0.276
    -> peak 0.417, port -> 0.387), because Adam moves every coefficient
    by about lr a step while the silhouette term falls (port: 0.276 ->
    0.102).  That is the refine path's curve on the card with random
    weights, whose check follows the silhouette term."""
    blob, masks, ign = _jax_start(setup)
    (_, _, jb, jc), (_, tb, tc) = setup
    blob = {k: v[:2] for k, v in blob.items()}
    blob["_ffd_coeffs"] = (blob["_ffd_coeffs"] * ffd_scale).astype(np.float32)
    run = JI._refine_jit(jc.image_size, jc.render_size, 10, jc.opt_lr,
                         jc.ffd_opt_reg, True)
    _, l_j = run({k: jnp.asarray(blob[k]) for k in OPT_KEYS},
                 {k: jnp.asarray(v) for k, v in blob.items()}, jb,
                 jnp.asarray(masks[:2]), jnp.asarray(ign[:2]))
    l_j = np.asarray(l_j)
    trace = []
    TI.refine_silhouettes({k: torch.from_numpy(v) for k, v in blob.items()},
                          tb, torch.from_numpy(masks[:2]),
                          torch.from_numpy(ign[:2]),
                          dataclasses.replace(tc, num_opts=10), trace=trace)
    shares = torch.stack(trace).sum(-1).numpy()          # [10, (sil, reg)]
    l_t = shares.sum(1)
    assert len(l_j) == len(l_t) == 10 and np.isfinite(l_t).all()
    np.testing.assert_allclose(l_t[:3], l_j[:3], rtol=2e-4)
    np.testing.assert_allclose(l_t, l_j, rtol=0.15)
    if ffd_scale:
        assert l_j[-1] < 0.5 * l_j[0] and l_t[-1] < 0.5 * l_t[0]
    else:
        assert l_j.max() > 1.3 * l_j[0] and l_t.max() > 1.3 * l_t[0]
        assert shares[0, 1] == 0 and shares[-1, 1] > 0
        assert shares[-1, 0] < 0.5 * shares[0, 0]


def test_derender_image_refined_end_to_end(setup):
    """From the raw frame with num_opts=3 (the port's own crops, encoder
    and refinement) against JAX's.

    Allowed: instance maps disagree on <= 2% of pixels (measured 75 of
    15,360, 0.5%); the refined entries of the real slots within 0.1
    (measured 0.027 on coefficients of magnitude ~1); normal bytes may
    differ on <= 25% and depth values on <= 50% of the frame (measured
    12.8% and 32.6%); depth (not refined) to rtol 1e-4 as without
    refinement.  Why: the encoders agree to rtol 1e-4 (summation order),
    one refinement step agrees to an ulp (previous test), but later steps
    separate the trajectories.  Adam normalises each entry's gradient, so
    an entry whose gradient is ~0 moves by up to lr on rounding noise, and
    a ulp-moved vertex can flip a silhouette pixel or a walk gate, whose
    terms reach diff/eps.  The refined shapes differ by that much, which
    moves every normal and depth value on the cars a little."""
    (jm, jv, jb, jc), (tm, tb, tc) = setup
    image, rois, masks, class_ids = fake_scene()
    jc3 = dataclasses.replace(jc, num_opts=3)
    tc3 = dataclasses.replace(tc, num_opts=3)
    enc_j = JI.derender_encode(jv, jm, jb, image, class_ids, masks, rois, jc3)
    enc_t = TI.derender_encode(tm, image, class_ids, masks, rois, tc3,
                               device="cpu", bank=tb)
    for k in OPT_KEYS:
        np.testing.assert_allclose(enc_t[1][k][:2],
                                   np.asarray(enc_j[1][k])[:2], rtol=0,
                                   atol=0.1, err_msg=k)
    want = JI.derender_image(jv, jm, jb, image, class_ids, masks, rois, jc3,
                             encoded=enc_j)
    got = TI.derender_image(tm, tb, image, class_ids, masks, rois, tc3,
                            encoded=enc_t, device="cpu")
    assert (got["instance_map"] == want["instance_map"]).mean() >= 0.98
    assert (got["instance_map"] > 0).mean() > 0.1
    for k, share in (("normal_png", 0.25), ("depth_png", 0.5)):
        assert (got[k] != want[k]).mean() <= share, k
    assert got["json_obj"].keys() == want["json_obj"].keys()
    for k in got["json_obj"]:
        np.testing.assert_allclose(got["json_obj"][k]["depth"],
                                   want["json_obj"][k]["depth"], rtol=1e-4)


def test_silhouette_descent_converges():
    """The port's differentiable silhouette and Adam drive a triangle
    toward a target mask (tests/test_rasterize.py:112-145, through the
    port): the loss falls below 0.35 of its start in 60 steps."""
    isz = 32
    target = TR.rasterize_silhouettes(
        torch.tensor([[[[-0.5, -0.5, 3.0], [0.6, -0.4, 3.0],
                        [0.0, 0.7, 3.0]]]]), image_size=isz,
        anti_aliasing=False)
    f = torch.tensor([[[[-0.2, -0.1, 3.0], [0.8, -0.1, 3.0],
                        [0.3, 0.9, 3.0]]]])
    mu, nu = torch.zeros_like(f), torch.zeros_like(f)
    losses = []
    for step in range(1, 61):
        fg = f.clone().requires_grad_(True)
        a = TR.rasterize_silhouettes(fg, image_size=isz, anti_aliasing=False)
        loss = torch.mean((a - target) ** 2)
        (g,) = torch.autograd.grad(loss, fg)
        losses.append(float(loss.detach()))
        f, mu, nu = TI.adam_step(f, g, mu, nu, step, 2e-2)
    assert losses[-1] < 0.35 * losses[0], (losses[0], losses[-1])


def test_geometric_main_num_opts_writes_contract(tmp_path):
    """cli.geometric_main --num_opts 2 --device cpu refines and writes the
    five-file contract (the CLI no longer refuses --num_opts)."""
    import json
    import os

    from PIL import Image

    from sdn3d_tpu_torch.cli import geometric_main
    from sdn3d_tpu_torch.geometry.assets import SHAPENET_CARS
    from sdn3d_tpu_torch.geometry.obj import save_obj

    v, f = make_sphere_mesh(3, 6)
    for cls, obj in SHAPENET_CARS:
        d = tmp_path / "shapenet" / cls / obj / "models"
        d.mkdir(parents=True)
        save_obj(str(d / "model_normalized.obj"), v, f)
    image, rois, masks, class_ids = fake_scene()
    Image.fromarray(image).save(tmp_path / "frame.png")
    np.savez(tmp_path / "gt.npz", rois=rois, masks=masks,
             class_ids=class_ids)
    seen = []
    refine = TI.refine_silhouettes

    def counting(*args, **kw):
        seen.append(args[4].num_opts)
        return refine(*args, **kw)

    TI.refine_silhouettes = counting
    try:
        geometric_main.main([
            "--source", "gt", "--input_image", str(tmp_path / "frame.png"),
            "--input_masks", str(tmp_path / "gt.npz"),
            "--shapenet_root", str(tmp_path / "shapenet"),
            "--image_size", "32", "--render_size", "16", "--device", "cpu",
            "--num_opts", "2", "--output_dir", str(tmp_path / "out")])
    finally:
        TI.refine_silhouettes = refine
    assert seen == [2]
    for suffix in (".png", "-normal.png", "-depth.png", ".json", ".pkl"):
        assert os.path.exists(tmp_path / "out" / ("frame" + suffix))
    with open(tmp_path / "out" / "frame.json") as fh:
        objs = json.load(fh)
    assert objs and all(np.isfinite(o["alpha"]) for o in objs.values())

"""One rank of a data-parallel group for tests/test_torch_parallel.py.

    python -m tests.torch_ddp_worker SPEC RANK WORLD INIT_FILE OUT

joins a gloo group through a FileStore at INIT_FILE, runs the jobs that
the torch.save file SPEC lists (`JOBS[kind](job)`), and torch.saves a
list of their results to OUT.  The same job functions run in the test's
own process with no group, which is world size 1.  Imports no JAX."""

import sys

import numpy as np
import torch

from sdn3d_tpu_torch import parallel
from sdn3d_tpu_torch.cli.geometric_train import step_generator
from sdn3d_tpu_torch.data import synthetic as TS
from sdn3d_tpu_torch.geometry.assets import build_mesh_bank
from sdn3d_tpu_torch.models import derenderer as TD
from sdn3d_tpu_torch.models import semantic as TSEM
from sdn3d_tpu_torch.pipelines import derender as TP
from sdn3d_tpu_torch.pipelines import semantic as TPS

HEAD_KEYS = ("_theta_deltas", "_translation2ds", "_log_scales",
             "_log_depths", "_class_probs", "_ffd_coeffs")
STATS = ("running_mean", "running_var")


def _np(t):
    return t.detach().cpu().numpy()


def _rows(global_rows):
    return parallel.local_batch_slice(global_rows)


def _tensors(batch, dtype):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def _given_draws(idx):
    """select_class returning the given classes and their log-probs."""
    def select(class_probs, generator=None, sample=False):
        i = torch.from_numpy(np.array(idx)).long()
        logp = torch.log(torch.gather(class_probs, 1, i[:, None])[:, 0]
                         + 1e-20)
        return i.to(torch.int32), logp
    return select


def _bank(dtype):
    meshes = [TS.make_sphere_mesh(4, 8)] * 3
    bank = TD.DeviceMeshBank.from_host(build_mesh_bank(meshes), device="cpu")
    bank.ffd_B, bank.ffd_P0 = bank.ffd_B.to(dtype), bank.ffd_P0.to(dtype)
    return bank


def _derender_state(job, dtype):
    model = TD.Derenderer(num_classes=3).to(dtype)
    state = TP.TrainState.from_fields(job["fields"], model)
    state.mu, state.nu = state.mu.to(dtype), state.nu.to(dtype)
    trainer = TP.DerenderTrainer(
        model=model, bank=_bank(dtype), mode=TD.TargetType.BY_NAME[job["mode"]],
        image_size=job["image"], render_size=job["image"])
    return trainer, state


def _stats(*nets):
    return {f"{i}.{n}": _np(v) for i, net in enumerate(nets)
            for n, v in net.state_dict().items() if n.endswith(STATS)}


def _errors(got, want):
    """{name: (max |got - want|, max |want|)} for the tensors of `want`."""
    return {n: (float(np.abs(got[n] - w).max()), float(np.abs(w).max()))
            for n, w in want.items()}


def _derender_result(state, losses):
    sd = {n: _np(v) for n, v in state.model.state_dict().items()
          if v.is_floating_point()}
    sd["opt.mu"], sd["opt.nu"] = _np(state.mu), _np(state.nu)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "params": sd}


def derender_step(job):
    """One train step of the derenderer on this rank's slice of the global
    batch, in job["dtype"], the class draws from step_generator(seed, 0)
    over the global batch.  With job["want"] (world size 1's result) the
    per-tensor errors against it come back instead of the tensors."""
    dtype = getattr(torch, job["dtype"])
    trainer, state = _derender_state(job, dtype)
    B = len(job["batch"]["images"])
    batch = _tensors(parallel.shard_batch(job["batch"], B), dtype)
    gen = parallel.global_draw(step_generator(job["seed"], 0, "cpu"), B)
    state, losses = trainer.train_step(state, batch, gen)
    out = _derender_result(state, losses)
    out["stats"] = _stats(state.model)
    if "want" in job:
        out["errors"] = _errors(out.pop("params"), job["want"]["params"])
    return out


def derender_halves(job):
    """The float32 step in its two halves from JAX's inputs on this
    rank's rows: the loss's gradient in this rank's encoder outputs (at
    JAX's outputs, with JAX's class draws) and the loss dict summed over
    the ranks; the encoder's VJP of JAX's cotangent summed over the
    ranks (fc1 / fc2 pre-activations within the forwards' disagreement
    moved onto JAX's side of the ReLU, as tests/test_torch_derender_train
    does), and the running statistics that training forward leaves."""
    trainer, _ = _derender_state(job, torch.float32)
    B = len(job["batch"]["images"])
    rows = _rows(B)
    b = _tensors(parallel.shard_batch(job["batch"], B), torch.float32)
    mroi, droi = TD.roi_features(b["roi_norms"])
    e = {k: torch.from_numpy(job["enc"][k][rows].copy()).requires_grad_(True)
         for k in HEAD_KEYS}
    blob = {"_roi_norms": b["roi_norms"], "_mroi_norms": mroi,
            "_droi_norms": droi, "_focals": b["focals"], **e}
    select = TD.select_class
    TD.select_class = _given_draws(job["draws"][rows])
    try:
        blob.update(TD.render_blob(blob, trainer.bank, trainer.mode,
                                   job["image"], job["image"],
                                   training=True))
    finally:
        TD.select_class = select
    losses = trainer.losses(blob, b)
    g = torch.autograd.grad(sum(losses.values()), [e[k] for k in HEAD_KEYS],
                            allow_unused=True)
    head = {k: (np.zeros_like(job["enc"][k][rows]) if gk is None
                else _np(gk)) for k, gk in zip(HEAD_KEYS, g)}

    _, state = _derender_state(job, torch.float32)
    model = state.model.train()
    flips = []

    def align(name):
        def hook(_, __, out):
            ref = torch.from_numpy(np.array(job["inter"][name][rows]))
            band = float((out - ref).abs().max())
            flip = (out > 0) != (ref > 0)
            flips.append((name, int(flip.sum()), band,
                          float(out[flip].abs().max()) if flip.any() else 0.0))
            return out + torch.where(flip, ref - out, 0.0).detach()
        return hook

    for name in ("fc1", "fc2"):
        getattr(model, name).register_forward_hook(align(name))
    out = model(b["images"], mroi, droi)
    params = list(model.named_parameters())
    grads = torch.autograd.grad(
        [out[k] for k in HEAD_KEYS], [p for _, p in params],
        [torch.from_numpy(np.array(job["g_enc"][k][rows])) for k in HEAD_KEYS])
    grads = parallel.sum_across_ranks(list(grads))
    return {"head": head, "rows": (rows.start, rows.stop),
            "losses": {k: float(v) for k, v in
                       parallel.sum_values({k: v.detach() for k, v in
                                            losses.items()}).items()},
            "enc": {n: _np(g) for (n, _), g in zip(params, grads)},
            "flips": flips, "stats": _stats(model)}


def _semantic_model(job, dtype):
    """The job's weights: its "encoder" / "decoder" state_dicts, or else
    torch's initialisers drawn from its "init_seed" (the same weights in
    every process)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(job.get("init_seed", 0))
        model = TSEM.SemanticModel(num_class=job["num_class"])
    if "encoder" in job:
        model.encoder.load_state_dict(job["encoder"])
        model.decoder.load_state_dict(job["decoder"])
    return model.to(dtype).train()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def semantic_step(job):
    """One train step of the semantic model on this rank's slice of the
    global batch (images NHWC, labels), in job["dtype"], the dropout
    masks from step_generator(seed, 0) over the global batch.  Returns the
    metrics, the running statistics and, with job["want"], the per-tensor
    errors of the parameters and traces against world size 1's."""
    dtype = getattr(torch, job["dtype"])
    model = _semantic_model(job, dtype)
    trainer = TPS.SemanticTrainer(model)
    state = trainer.init()
    B = len(job["images"])
    x = _nchw(parallel.shard_batch(job["images"], B)).to(dtype)
    y = torch.from_numpy(parallel.shard_batch(job["labels"], B)).long()
    gen = parallel.global_draw(step_generator(job["seed"], 0, "cpu"), B)
    state, metrics = trainer.train_step(state, x, y, gen)
    params = {f"{i}.{n}": _np(p) for i, net in enumerate(
        (model.encoder, model.decoder)) for n, p in net.named_parameters()}
    params.update({f"trace.{i}": _np(t) for i, t in enumerate(
        state.trace_enc + state.trace_dec)})
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "stats": _stats(model.encoder, model.decoder)}
    if "want" in job:
        out["errors"] = _errors(params, job["want"]["params"])
    else:
        out["params"] = params
    return out


def semantic_halves(job):
    """The float32 step in its two halves from JAX's inputs on this
    rank's rows: the decoder's loss, accuracy (summed over the ranks) and
    gradients (in its parameters, summed; in this rank's C4, C5) from
    JAX's features and dropout masks; the encoder's VJP of JAX's
    cotangent, summed; the running statistics after both forwards."""
    B = len(job["images"])
    rows = _rows(B)
    tm = _semantic_model(job, torch.float32)
    conv_out = [_nchw(f)[rows].requires_grad_(True) for f in job["conv_out"]]
    y = torch.from_numpy(job["labels"][rows]).long()
    total, acc = TPS.SemanticTrainer(tm).objective(
        tm.decoder(conv_out, dropout=[m[rows] for m in job["masks"]]), y)
    dec = list(tm.decoder.parameters())
    grads = torch.autograd.grad(total, dec + conv_out[2:])
    g_dec = parallel.sum_across_ranks(list(grads[:len(dec)]))
    metrics = parallel.sum_values({"loss": total.detach(),
                                   "acc": acc.detach()})

    tm2 = _semantic_model(job, torch.float32)
    feats = tm2.encoder.stages(_nchw(job["images"])[rows])[1:]
    g_enc = torch.autograd.grad(
        feats, list(tm2.encoder.parameters()),
        grad_outputs=[_nchw(g)[rows] for g in job["g_conv"]])
    g_enc = parallel.sum_across_ranks(list(g_enc))
    tm2.decoder([_nchw(f)[rows] for f in job["conv_out"]],
                dropout=[m[rows] for m in job["masks"]])
    return {"rows": (rows.start, rows.stop),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "g_dec": {n: _np(g) for (n, _), g in
                      zip(tm.decoder.named_parameters(), g_dec)},
            "g_conv": [np.transpose(_np(g), (0, 2, 3, 1))
                       for g in grads[len(dec):]],
            "g_enc": {n: _np(g) for (n, _), g in
                      zip(tm2.encoder.named_parameters(), g_enc)},
            "stats": _stats(tm2.encoder, tm2.decoder)}


def mesh(job):
    """The mesh helpers on this rank."""
    m = parallel.make_mesh()
    out = {"rank": parallel.rank(), "world": parallel.world_size(),
           "mesh": (m.rank, m.world_size, m.local_rank, m.local_world_size,
                    m.node, m.nodes),
           "slice": parallel.local_batch_slice(8),
           "sharding": parallel.multihost_batch_sharding(
               parallel.make_multihost_mesh(), 8),
           "shard": parallel.shard_batch({"a": np.arange(8), "b": [
               np.arange(16).reshape(8, 2)]}),
           "count": float(parallel.global_count(
               torch.tensor(float(parallel.rank() + 1)))),
           "mean": float(parallel.global_mean(
               torch.arange(4.0) + 4 * parallel.rank()))}
    try:
        parallel.check_world_divides(3)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    g = torch.Generator().manual_seed(7)
    out["draw"] = _np(parallel.rand_rows((2, 3), parallel.global_draw(g, 4)))
    return out


def pack(tree):
    """numpy arrays in a tree of dicts / lists / tuples as tagged tensors:
    torch.save writes tensors as raw storage, and pickles arrays (10x
    slower to load at the semantic model's size)."""
    if isinstance(tree, dict):
        return {k: pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(pack(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return ("__numpy__", torch.from_numpy(np.require(tree, requirements=(
            "C", "W"))))
    return tree


def unpack(tree):
    if isinstance(tree, tuple) and len(tree) == 2 and \
            tree[0] == "__numpy__":
        return tree[1].numpy()
    if isinstance(tree, dict):
        return {k: unpack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unpack(v) for v in tree)
    return tree


JOBS = {f.__name__: f for f in (derender_step, derender_halves,
                                 semantic_step, semantic_halves, mesh)}


def main(spec, rank, world, init_file, out):
    torch.set_num_threads(1)
    parallel.initialize_multihost("cpu", init_method=f"file://{init_file}",
                                  rank=int(rank), world_size=int(world))
    try:
        results = [JOBS[job["kind"]](job) for job in unpack(torch.load(
            spec, weights_only=False))]
    finally:
        parallel.shutdown()
    torch.save(pack(results), out)


if __name__ == "__main__":
    main(*sys.argv[1:])

"""Semantic branch training CLI, PyTorch port (mirrors
semantic/vkitti_train.py; JAX cli/semantic_train.py).

Trains the dilated-ResNet50 + PPM segmenter with the reference's two
poly-LR SGD optimizers (pipelines/semantic.SemanticTrainer) on random
batches (`--synthetic`, or no --data_root) or on random crops of VKITTI
scenegt (`vkitti_batches`).  Both streams draw from
numpy.random.RandomState(--seed) in the JAX CLI's order, the first batch
included, which the JAX CLI spends on its init, so the batches are the
JAX package's byte for byte.  Initial weights are drawn by torch from
--seed; each step's dropout draws come from a torch.Generator seeded from
(--seed, iteration) (JAX: PRNGKey(iteration)).  Every --save_every
iterations and at the last one the state is saved as a core/checkpoint
step (fields "encoder", "decoder", "opt_enc", "opt_dec", "step"; the
arguments as the manifest's meta), which semantic_test --ckpt_dir and
semantic_eval --ckpt_dir serve.  Runs on --device (default cuda).

Data parallelism (the JAX package's device mesh): started by torchrun,
`python -m torch.distributed.run --nproc_per_node N -m
sdn3d_tpu_torch.cli.semantic_train ...`, each process draws the global
batch's random numbers, loads and trains on its slice of --batch_size
(NCCL between cards, one process a card; gloo with --device cpu), with
BatchNorm over the global batch, the loss and accuracy as each rank's
part of the global batch's, the dropout masks of the global batch, the
gradients summed over the ranks before the two SGD steps, and rank 0's
initial weights; rank 0 logs and saves (parallel/mesh.py).  Without
torchrun's environment it trains in one process, with no collectives.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"))
    p.add_argument("--ckpt_dir", default="./semantic_ckpt")
    p.add_argument("--num_class", type=int, default=14)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--lr_encoder", type=float, default=2e-2)
    p.add_argument("--lr_decoder", type=float, default=2e-2)
    p.add_argument("--max_iters", type=int, default=100_000)
    p.add_argument("--num_iters", type=int, default=100)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true",
                   help="train on random data (smoke/benchmark mode)")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the batch stream (numpy RandomState, 0 "
                        "gives the JAX CLI's), the initial weights and "
                        "each step's dropout draws")
    return p


def synthetic_batches(args, rng):
    """Random images [B, crop, crop, 3] float32 in [0, 1) and labels
    [B, crop/8, crop/8] int32 in [-1, num_class)."""
    while True:
        yield (rng.rand(args.batch_size, args.crop_size, args.crop_size, 3
                        ).astype(np.float32),
               rng.randint(-1, args.num_class,
                           (args.batch_size, args.crop_size // 8,
                            args.crop_size // 8)).astype(np.int32))


def vkitti_batches(args, rng, rows: slice = None):
    """Random crops from VKITTI scenegt (semantic/vkitti_dataset.py): a
    frame drawn over the whole train list, a crop corner, then
    prepare_train_sample on the crop at the crop's own scale, with the
    labels shifted by +1.  With `rows` (a rank's slice of the batch) every
    draw of the global batch is made and only those rows are loaded (the
    others read their frame's size alone)."""
    import random

    from PIL import Image

    from sdn3d_tpu_torch.data import vkitti
    from sdn3d_tpu_torch.data.semantic_data import prepare_train_sample

    table = vkitti.get_tables("segm", args.data_root)
    files = vkitti.get_lists("train")
    while True:
        imgs, labels = [], []
        keep = range(args.batch_size)[rows or slice(None)]
        for i in range(args.batch_size):
            f = files[rng.randint(len(files))]
            world, scene, _ = f.split("/")
            path = os.path.join(args.data_root, "vkitti_1.3.1_rgb", f)
            s = args.crop_size
            if i not in keep:
                W, H = Image.open(path).size
                rng.randint(max(1, H - s))
                rng.randint(max(1, W - s))
                rng.randint(1 << 30)
                continue
            rgb = np.asarray(Image.open(path).convert("RGB"))
            gt = np.asarray(Image.open(os.path.join(
                args.data_root, "vkitti_1.3.1_scenegt", f)).convert("RGB"))
            seg = vkitti.decode_scenegt(gt, world, scene, table)
            H, W = rgb.shape[:2]
            y = rng.randint(max(1, H - s))
            x = rng.randint(max(1, W - s))
            out = prepare_train_sample(
                rgb[y:y + s, x:x + s], seg[y:y + s, x:x + s] + 1,
                random.Random(int(rng.randint(1 << 30))),
                scales=(args.crop_size,))
            imgs.append(out["image"][:s, :s])
            labels.append(out["label"][:s // 8, :s // 8])
        yield np.stack(imgs), np.stack(labels)


def build_trainer(args):
    """The CLI's SemanticTrainer for `args` on args.device, its model's
    weights drawn from args.seed (inside fork_rng: the caller's global
    generator is untouched)."""
    import torch

    from sdn3d_tpu_torch.models.semantic import SemanticModel
    from sdn3d_tpu_torch.pipelines.semantic import SemanticTrainer

    from sdn3d_tpu_torch import parallel

    device = torch.device(args.device)
    if parallel.active() and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = SemanticModel(num_class=args.num_class,
                              dtype=args.compute_dtype)
    model = model.to(device)
    parallel.broadcast_module(model)
    return SemanticTrainer(model, lr_encoder=args.lr_encoder,
                           lr_decoder=args.lr_decoder,
                           max_iters=args.max_iters)


def to_batch(imgs: np.ndarray, labels: np.ndarray, device):
    """A host batch (NHWC float32 images, int32 labels) on `device`:
    images [B, 3, H, W], labels int64."""
    from sdn3d_tpu_torch.utils.transfer import to_device

    x = to_device(imgs, device).permute(0, 3, 1, 2).contiguous()
    return x, to_device(labels, device).long()


def main(argv=None):
    """Returns the trainer's state after the last iteration."""
    from sdn3d_tpu_torch import parallel
    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    from sdn3d_tpu_torch.core.checkpoint import save_checkpoint

    args = build_argparser().parse_args(argv)
    owns_group = parallel.in_launcher() and not parallel.active()
    if parallel.in_launcher():
        parallel.initialize_multihost(args.device)
    rows = parallel.local_batch_slice(args.batch_size)
    lead = parallel.rank() == 0
    trainer = build_trainer(args)
    device = next(trainer.model.parameters()).device
    rng = np.random.RandomState(args.seed)
    if args.synthetic or not args.data_root:
        batches = (parallel.shard_batch(b, args.batch_size)
                   for b in synthetic_batches(args, rng))
    else:
        batches = vkitti_batches(args, rng,
                                 rows if parallel.active() else None)
    next(batches)      # the batch the JAX CLI spends on init (:99-100)
    state = trainer.init()
    step_fn = trainer.make_train_step()

    for it in range(args.num_iters):
        x, y = to_batch(*next(batches), device)
        state, metrics = step_fn(state, x, y, parallel.global_draw(
            step_generator(args.seed, it, device), args.batch_size))
        if it % 10 == 0 and lead:
            print(f"iter {it}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['acc']):.4f}", flush=True)
        if lead and ((it + 1) % args.save_every == 0
                     or it + 1 == args.num_iters):
            save_checkpoint(args.ckpt_dir, it + 1, state.fields(),
                            meta=vars(args))
    if lead:
        print("done")
    if owns_group:
        parallel.shutdown()
    return state


if __name__ == "__main__":
    main()

"""Textural branch (pix2pixHD) training CLI, PyTorch port (mirrors
textural/train.py; JAX cli/textural_train.py): one fused iteration a batch
(pipelines/textural.make_train_iteration: the G update, the history pool,
the D update) with checkpoint and resume.

Batches are synthetic (`--synthetic`) or frames of the reference's
precomputed layout (`--data_root`, `--segm_dir`, `--geo_dir`: the RGB,
semantic_test's labels and geometric_main's instance maps, JSON and
normals under `world/topic/#####`; data/textural_data.
TexturalVKittiDataset over `--split`).  The weights of netG / netE (and
netGlobalE) are drawn from `--seed`, the discriminator's and VGG's from a
generator seeded from it, and each iteration's draws (the global
encoder's z, the pool's decisions) from a torch.Generator seeded from
(--seed, iteration).  As in JAX, the run resumes from the newest step of
--ckpt_dir and counts its iterations from 0, saving the state as a
core/checkpoint train-state step (netG, netE, netD, vgg, netGlobalE,
opt_g, opt_d, step; the arguments as the manifest's meta) every
--save_every iterations and at the last one; textural_test, edit_vkitti,
edit_benchmark and edit_chain --textural_ckpt serve it.  Runs on --device
(default cuda), with cuDNN's deterministic algorithms and TF32 off, so two
runs give the same bits.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", default=os.environ.get("VKITTI_ROOT_DIR"))
    p.add_argument("--segm_dir", default=None)
    p.add_argument("--geo_dir", default=None)
    p.add_argument("--ckpt_dir", default="./textural_ckpt")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--load_size", type=int, default=624)
    p.add_argument("--fine_width", type=int, default=624)
    p.add_argument("--fine_height", type=int, default=192)
    p.add_argument("--num_iters", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--no_vgg", action="store_true")
    p.add_argument("--use_global_encoder", action="store_true",
                   help="global VAE latent conditioning + KL loss "
                        "(reference --no_global_encoder=0)")
    p.add_argument("--pool_size", type=int, default=0,
                   help="GAN history buffer for the D fake loss")
    p.add_argument("--split", default="train", choices=["train", "test"],
                   help="VKITTI split to enumerate (frames the benchmark's "
                        "per-stage programs write fall in 'test')")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--no_augment", action="store_true",
                   help="disable train-time color jitter "
                        "(reference --use_augmentation default True)")
    p.add_argument("--small", action="store_true",
                   help="small nets (smoke mode)")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initial weights and of each "
                        "iteration's draws")
    return p


def synthetic_batch(args, rng: np.random.RandomState, cfg) -> dict:
    """A random batch, numpy, the JAX CLI's draws in its order."""
    H, W = args.fine_height, args.fine_width
    B = args.batch_size
    inst = rng.randint(0, 4, (B, H, W)).astype(np.int32)
    return {
        "label": rng.randint(0, cfg.label_nc, (B, H, W)).astype(np.int32),
        "inst": inst * 1000,
        "inst_slots": inst,
        "image": rng.rand(B, H, W, 3).astype(np.float32) * 2 - 1,
        "pose": rng.randint(0, cfg.pose_bins + 1,
                            (B, H, W)).astype(np.int32),
        "normal": rng.rand(B, H, W, 3).astype(np.float32),
    }


def train_config(args):
    """The TexturalConfig of the arguments (JAX's)."""
    from sdn3d_tpu_torch.pipelines.textural import (SMALL_NET_OVERRIDES,
                                                    TexturalConfig)

    common = dict(use_vgg_loss=not args.no_vgg, lr=args.lr,
                  use_global_encoder=args.use_global_encoder,
                  pool_size=args.pool_size,
                  compute_dtype=args.compute_dtype)
    if args.small:
        common.update(SMALL_NET_OVERRIDES)
    return TexturalConfig(**common)


def build_trainer(args, cfg):
    """(TexturalTrainer on args.device, its state): the nets drawn from
    args.seed, then restored from the newest step of args.ckpt_dir if
    there is one (the step printed)."""
    import torch

    from sdn3d_tpu_torch.core.checkpoint import (latest_step,
                                                 restore_checkpoint)
    from sdn3d_tpu_torch.pipelines.textural import TexturalTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    # drawn inside fork_rng: the caller's global generator is untouched
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        trainer = TexturalTrainer(cfg)
    trainer.to(device)
    state = trainer.init(torch.Generator().manual_seed(args.seed),
                         args.fine_height, args.fine_width)
    if latest_step(args.ckpt_dir) is not None:
        fields, step0 = restore_checkpoint(args.ckpt_dir)
        state.load_fields(fields)
        print(f"resumed from step {step0}")
    return trainer, state


def main(argv=None):
    """Train; returns (trainer, state)."""
    from sdn3d_tpu_torch.cli.geometric_train import step_generator
    from sdn3d_tpu_torch.core.checkpoint import save_checkpoint

    args = build_argparser().parse_args(argv)
    cfg = train_config(args)
    rng = np.random.RandomState(0)

    dataset = None
    if not args.synthetic and args.data_root and args.segm_dir \
            and args.geo_dir:
        from sdn3d_tpu_torch.data.textural_data import TexturalVKittiDataset
        dataset = TexturalVKittiDataset(
            args.data_root, args.segm_dir, args.geo_dir, split=args.split,
            load_size=args.load_size,
            fine_wh=(args.fine_width, args.fine_height),
            max_instances=cfg.max_instances,
            augment=not args.no_augment)
        print(f"train set: {len(dataset)} frames")
    elif not args.synthetic and (args.data_root or args.segm_dir
                                 or args.geo_dir):
        raise SystemExit("dataset mode needs --data_root AND --segm_dir "
                         "AND --geo_dir (semantic + geometric precomputed "
                         "outputs, textural/README.md Train); pass "
                         "--synthetic for random batches")

    trainer, state = build_trainer(args, cfg)
    train_iter = trainer.make_train_iteration()
    pool = (trainer.device_pool(args.fine_height, args.fine_width)
            if cfg.pool_size > 0 else None)
    device = trainer.device
    for it in range(args.num_iters):
        if dataset is not None:
            batch = dataset.batch(rng, args.batch_size)
        else:
            batch = synthetic_batch(args, rng, cfg)
        state, losses, pool = train_iter(
            state, batch, step_generator(args.seed, it, device), pool)
        if it % 10 == 0:
            msg = " ".join(f"{k}={float(v):.3f}" for k, v in losses.items())
            print(f"iter {it}: {msg}", flush=True)
        if (it + 1) % args.save_every == 0 or it + 1 == args.num_iters:
            save_checkpoint(args.ckpt_dir, it + 1, state.fields(),
                            meta=vars(args))
    print("done")
    return trainer, state


if __name__ == "__main__":
    main()

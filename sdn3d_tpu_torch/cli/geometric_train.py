"""Geometric branch (derenderer) training CLI, PyTorch port (mirrors
geometric/scripts/main.py --do train; JAX cli/geometric_train.py).

Modes map to TargetType bitmasks (derender3d/__init__.py): pretrain
(geometry-only losses), full (geometry + reprojection), finetune and
extend.  Batches are synthetic (`--synthetic`, or no real dataset root)
or per-object VKITTI items (`--dataset vkitti --vkitti_root`) through the
threaded prefetch loader; the kitti and cityscapes datasets are ROADMAP
A9.  The mesh bank is 8 spheres with `--synthetic` or without
`--shapenet_root`.  Each step draws its REINFORCE classes from a
torch.Generator seeded from (--seed, iteration).  The state is saved as a
core/checkpoint step (fields "derenderer", "opt_state", "step"; the
arguments as the manifest's meta) every --save_every iterations and at
the last one; geometric_main --ckpt_dir serves it.  Runs on --device
(default cuda) and trains on one card: the JAX package's data-parallel
device mesh becomes DDP with ROADMAP A8.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["pretrain", "full", "finetune",
                                      "extend"], default="full")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--render_size", type=int, default=384)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--mask_weight", type=float, default=0.1)
    p.add_argument("--ffd_coeff_reg", type=float, default=1.0)
    p.add_argument("--num_iters", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--ckpt_dir", default="./derender_ckpt")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--shapenet_root",
                   default=os.environ.get("SHAPENET_ROOT_DIR"))
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic mesh bank + random batches (smoke mode)")
    p.add_argument("--dataset",
                   choices=["vkitti", "kitti", "cityscapes"],
                   default="vkitti",
                   help="training corpus; selection by (dataset, mode) "
                        "mirrors derender3d/data_loader.py:43-82 (kitti "
                        "and cityscapes are not ported yet, ROADMAP A9)")
    p.add_argument("--vkitti_root",
                   default=os.environ.get("VKITTI_ROOT_DIR"),
                   help="train on real VKITTI per-object items (threaded "
                        "prefetch loader); otherwise synthetic batches")
    p.add_argument("--kitti_object_root",
                   default=os.environ.get("KITTI_OBJECT_ROOT_DIR"))
    p.add_argument("--kitti_semantics_root",
                   default=os.environ.get("KITTI_SEMANTICS_ROOT_DIR"))
    p.add_argument("--cityscapes_root",
                   default=os.environ.get("CITYSCAPES_ROOT_DIR"))
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--grad_walk", type=int, default=64,
                   help="parsed and never read, as in the JAX CLI: the "
                        "silhouette gradient's walk window is 64 for "
                        "render_size > 128, else exact (render_blob)")
    p.add_argument("--device", default="cuda",
                   help="torch device; nothing falls back to the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initial weights and of each "
                        "step's class draws")
    return p


def step_generator(seed: int, it: int, device) -> "torch.Generator":
    """The class-draw generator of iteration `it`, seeded from (seed, it)
    (JAX: PRNGKey(it))."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, it]).generate_state(1)[0]))
    return g


def main(argv=None):
    import torch

    from sdn3d_tpu_torch.core.checkpoint import save_checkpoint
    from sdn3d_tpu_torch.data.synthetic import (centred_square_masks,
                                                make_derender_batch,
                                                make_sphere_mesh)
    from sdn3d_tpu_torch.geometry.assets import (build_mesh_bank,
                                                 load_shapenet_bank)
    from sdn3d_tpu_torch.models.derenderer import (
        Derenderer, DeviceMeshBank, TargetType)
    from sdn3d_tpu_torch.pipelines.derender import DerenderTrainer

    args = build_argparser().parse_args(argv)
    mode = TargetType.BY_NAME[args.mode]
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")

    if args.synthetic or not args.shapenet_root:
        verts, faces = make_sphere_mesh(8, 16)
        bank_host = build_mesh_bank([(verts, faces)] * 8)
        print("synthetic mesh bank (8x sphere)")
    else:
        bank_host = load_shapenet_bank(args.shapenet_root)
    bank = DeviceMeshBank.from_host(bank_host, device=device)

    # drawn inside fork_rng: the caller's global generator is untouched
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = Derenderer(num_classes=8, dtype=args.compute_dtype)
    model = model.to(device)
    trainer = DerenderTrainer(
        model=model, bank=bank, mode=mode, image_size=args.image_size,
        render_size=args.render_size, mask_weight=args.mask_weight,
        ffd_coeff_reg=args.ffd_coeff_reg, lr=args.lr,
        weight_decay=args.weight_decay)

    def to_device(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()}

    def make_batch(seed):
        b = make_derender_batch(args.batch_size, args.image_size, seed)
        if mode & TargetType.reproject:
            b.update(centred_square_masks(args.batch_size, args.render_size))
        return to_device(b)

    have_real_data = ((args.dataset == "vkitti" and args.vkitti_root)
                      or (args.dataset == "kitti"
                          and (args.kitti_object_root
                               or args.kitti_semantics_root))
                      or (args.dataset == "cityscapes"
                          and args.cityscapes_root))

    def batches():
        """Real per-object stream (dataset picked by (dataset, mode) as
        the reference's data_loader does) or synthetic smoke batches."""
        if have_real_data and not args.synthetic:
            from sdn3d_tpu_torch.data.loader import PrefetchLoader
            from sdn3d_tpu_torch.data.select import select_derender_dataset

            ds, sampler = select_derender_dataset(
                args.dataset, mode,
                vkitti_root=args.vkitti_root,
                kitti_object_root=args.kitti_object_root,
                kitti_semantics_root=args.kitti_semantics_root,
                cityscapes_root=args.cityscapes_root,
                is_train=True, image_size=args.image_size,
                render_size=args.render_size)
            print(f"{args.dataset} derender dataset: {len(ds)} objects"
                  + (" (weighted hybrid sampler)" if sampler else ""))
            it = 0
            while it < args.num_iters:
                loader = PrefetchLoader(ds, args.batch_size,
                                        sampler=sampler,
                                        num_workers=args.num_workers,
                                        device=device, seed=it)
                for b in loader:
                    yield b
                    it += 1
                    if it >= args.num_iters:
                        return
        else:
            for i in range(args.num_iters):
                yield make_batch(i + 1)

    state = trainer.init()
    step_fn = trainer.make_train_step()
    for it, batch in enumerate(batches()):
        state, losses = step_fn(state, batch,
                                step_generator(args.seed, it, device))
        if it % 10 == 0:
            msg = " ".join(f"{k}={float(v):.4f}" for k, v in losses.items())
            print(f"iter {it}: {msg}", flush=True)
        if (it + 1) % args.save_every == 0 or it + 1 == args.num_iters:
            save_checkpoint(args.ckpt_dir, it + 1, state.fields(),
                            meta=vars(args))
    print("done")
    return state


if __name__ == "__main__":
    main()

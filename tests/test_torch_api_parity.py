"""Name-level parity: every public name of the JAX package has its
counterpart in the port, or a stated reason in RENAMED or ABSENT.

Both trees are read with `ast`; neither package is imported, so this
needs no JAX and takes well under a second.  A public name is a
top-level `def`, `class` or UPPER-case constant of a JAX module whose
name does not start with an underscore, and every name that a JAX
`__init__.py` re-exports.  Its counterpart is the same name defined or
imported at the top level of the port's module of the same path
(`MODULES` lists the paths that differ), or the entry in RENAMED.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "sdn3d_tpu"
PORT = ROOT / "sdn3d_tpu_torch"

# JAX module -> the port module that holds its counterparts
MODULES = {"ops/rasterize_pallas.py": "ops/rasterize_cuda.py"}

# "jax module:name" -> ("port module:name", why the name differs)
RENAMED = {
    "core/optimizers.py:sparse_adam": (
        "core/optimizers.py:sparse_adam_step",
        "optax's GradientTransformation as tensor functions: "
        "sparse_adam_init / scale_by_sparse_adam / sparse_adam_step"),
    "cli/edit_vkitti.py:assemble_edit_conditioning": (
        "ops/edit_conditioning.py:edit_conditioning",
        "the edit frames' conditioning is built on the device, a batch at a "
        "time (csrc/edit_conditioning.cu; its plain twin on the CPU)"),
    "data/kitti.py:hybrid_weights": (
        "data/loader.py:hybrid_weights",
        "moved beside the port's HybridDataset and samplers"),
    "models/maskrcnn.py:MRBottleneck": (
        "models/maskrcnn.py:Bottleneck",
        "the reference's own name (maskrcnn/model.py Bottleneck)"),
    "models/maskrcnn.py:MRResNet": (
        "models/maskrcnn.py:FPN",
        "the ResNet-101 stages are FPN's C1-C5 Sequentials, the "
        "reference's fpn.C1..C5 keys"),
    "models/semantic.py:ConvBNReLU": (
        "models/semantic.py:conv_bn_relu",
        "an nn.Sequential of conv, BatchNorm and ReLU, for the reference's "
        "conv3x3_bn_relu keys .0 / .1"),
    "ops/rasterize_pallas.py:rasterize_face_index_pallas": (
        "ops/rasterize_cuda.py:rasterize_face_index_cuda",
        "B1: the CUDA kernel's wrapper (csrc/rasterize.cu)"),
    "ops/rasterize_pallas.py:segment_face_grads_pallas": (
        "ops/rasterize_cuda.py:segment_face_grads_cuda",
        "B2: the CUDA kernel's wrapper (csrc/segment_face_grads.cu)"),
    "ops/rasterize_pallas.py:walk_grads_pallas": (
        "ops/rasterize_cuda.py:walk_grads_cuda",
        "B3: the CUDA kernel's wrapper (csrc/silhouette_walk.cu)"),
    "ops/rasterize_pallas.py:pack_faces": (
        "ops/rasterize_cuda.py:pack_faces",
        "B1's face records and boxes, in the CUDA kernel's layout"),
    "ops/rasterize_pallas.py:recompute_pixel_attributes": (
        "ops/rasterize.py:pixel_attributes",
        "plain tensor code, beside the depth gradient that uses it"),
    "ops/rasterize_pallas.py:pack_seg_aux": (
        "ops/rasterize_cuda.py:won_pixel_boxes_cuda",
        "B2's culling boxes: the CUDA reduction builds them in its box "
        "pass from the face index"),
    "parallel/mesh.py:make_mesh_for_batch": (
        "parallel/mesh.py:check_world_divides",
        "a process group cannot shrink to the batch: it raises, naming "
        "the world size that would divide it"),
    "parallel/mesh.py:batch_sharding": (
        "parallel/mesh.py:shard_batch",
        "each rank takes its rows of the global batch"),
    "parallel/mesh.py:replicated_sharding": (
        "parallel/mesh.py:broadcast_module",
        "parameters are replicated by rank 0's broadcast"),
    "parallel/__init__.py:make_mesh_for_batch": (
        "parallel/__init__.py:check_world_divides",
        "as parallel/mesh.py:make_mesh_for_batch"),
    "parallel/__init__.py:batch_sharding": (
        "parallel/__init__.py:shard_batch",
        "as parallel/mesh.py:batch_sharding"),
    "parallel/__init__.py:replicated_sharding": (
        "parallel/__init__.py:broadcast_module",
        "as parallel/mesh.py:replicated_sharding"),
    "pipelines/semantic.py:multiscale_inference": (
        "pipelines/semantic.py:multiscale_probs_device",
        "the uint8 frame is uploaded and normalised on the card"),
    "pipelines/semantic.py:multiscale_labels": (
        "pipelines/semantic.py:multiscale_labels_fused",
        "the uint8-upload form (with multiscale_labels_device / _begin)"),
    "utils/flops.py:compiled_costs": (
        "utils/flops.py:count_flops",
        "XLA's cost analysis has no torch counterpart; torch's FLOP "
        "counter gives FLOPs only"),
}

_CONVERTER = ("its job is done by the key layout: the port's modules keep "
              "the reference's state_dict keys, so a reference checkpoint "
              "loads with load_state_dict (the port's utils/port.py holds "
              "the inverse converters, JAX to port)")
_TILE = ("TPU-only: a tile or grid parameter of the Pallas kernels; the "
         "CUDA kernels' tiling lives in csrc/ and ops/rasterize_cuda.py")
_CACHE = ("XLA-only: XLA's persistent compilation cache; the port builds "
          "its kernels once into sdn3d_tpu_torch/_build/")

# "jax module:name" -> why the port has no counterpart
ABSENT = {
    "core/cache.py:DEFAULT_CACHE_DIR": _CACHE,
    "core/cache.py:enable_compilation_cache": _CACHE,
    "parallel/mesh.py:DATA_AXIS": (
        "XLA-only: the name of jax.sharding's mesh axis; a torch.distributed "
        "process group has no named axes"),
    **{f"ops/rasterize_pallas.py:{n}": _TILE for n in (
        "TILE_H", "TILE_W", "FACE_CHUNK", "GROUP", "PER_FACE_CULL",
        "PER_FACE_CULL_V3", "KERNEL_VERSION", "VGROUP", "UNROLL_FACE_V3",
        "TILE_H3", "N_ROWS", "AUX_ROWS", "SEG_GROUP", "SEG_CHUNK",
        "WALK_INV_ROWS", "WALK_TILE_S", "WALK_UNROLL")},
    **{f"utils/port.py:{n}": _CONVERTER for n in (
        "t_conv", "t_convT", "t_linear", "port_semantic", "port_derenderer",
        "port_global_generator", "port_encoder",
        "port_multiscale_discriminator", "port_maskrcnn", "port_vgg19",
        "port_lpips")},
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def public_names(path: pathlib.Path):
    """[(name, line)] of a JAX module's public top-level definitions and,
    for an __init__.py, its re-exports."""
    out = []
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not node.name.startswith("_"):
                out.append((node.name, node.lineno))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id.isupper() \
                            and not n.id.startswith("_"):
                        out.append((n.id, node.lineno))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            for a in node.names:
                name = a.asname or a.name
                if not name.startswith("_"):
                    out.append((name, node.lineno))
    return out


def defined_names(path: pathlib.Path) -> set:
    """Every name a port module binds at its top level."""
    out = set()
    if not path.exists():
        return out
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def port_module(rel: str) -> str:
    return MODULES.get(rel, rel)


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_the_trees_are_there():
    assert len(JAX_MODULES) > 70, JAX_MODULES
    assert (PORT / "__init__.py").exists()


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    port_rel = port_module(rel)
    have = defined_names(PORT / port_rel)
    missing = [f"sdn3d_tpu/{rel}:{line} {name} has no counterpart in "
               f"sdn3d_tpu_torch/{port_rel}"
               for name, line in public_names(JAX / rel)
               if f"{rel}:{name}" not in RENAMED
               and f"{rel}:{name}" not in ABSENT and name not in have]
    assert not missing, "\n".join(missing)


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_counterpart_exists(key):
    rel, name = key.split(":")
    assert name in dict(public_names(JAX / rel)), \
        f"RENAMED lists {key}, which the JAX package no longer has"
    target, reason = RENAMED[key]
    t_rel, t_name = target.split(":")
    assert t_name in defined_names(PORT / t_rel), \
        f"RENAMED maps {key} to sdn3d_tpu_torch/{target}, which is missing"
    assert reason.strip()


@pytest.mark.parametrize("key", sorted(ABSENT))
def test_absent_names_exist_and_have_a_reason(key):
    rel, name = key.split(":")
    assert name in dict(public_names(JAX / rel)), \
        f"ABSENT lists {key}, which the JAX package no longer has"
    assert name not in defined_names(PORT / port_module(rel)), \
        f"ABSENT lists {key}, but the port has it"
    reason = ABSENT[key].lower()
    assert reason.startswith(("xla-only", "tpu-only", "its job is done by "
                                                      "the key layout")), \
        f"{key}: {ABSENT[key]!r} is not an allowed reason"
    assert "not ported" not in reason and "later" not in reason

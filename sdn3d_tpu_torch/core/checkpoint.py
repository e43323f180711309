"""Checkpoint manager: torch state_dicts per step + a JSON manifest.

Counterpart of sdn3d_tpu/core/checkpoint.py with the same directory layout:
DIR/step-{N}/ per saved step and DIR/manifest.json {"step", "meta"} (the
training meta a test or edit program rebuilds its nets from); resume and
restore pick the newest step.  A step directory holds one torch file per
top-level field, `{field}.pt`: the nets' state_dicts under the keys the
CLIs read ("encoder" / "decoder" for the semantic model, "derenderer",
"netG" / "netE" (and "netGlobalE" with the global encoder) for the
textural nets, "maskrcnn") and, in a train-state step, the trainer's own
fields, which `restore_variables` leaves on disk:
  - derenderer training (cli/geometric_train): derenderer.pt,
    opt_state.pt ({"count", "mu", "nu"}, the moments by parameter name),
    step.pt;
  - textural training (cli/textural_train): netG.pt, netE.pt, netD.pt
    (the reference's `scale{i}_layer{j}.0.*` keys), vgg.pt (torchvision's
    `features.N.*`), netGlobalE.pt (only with the global encoder), opt_g.pt
    (over netG, netE, netGlobalE: moments named "netG.*", "netE.*",
    "netGlobalE.*") and opt_d.pt ({"count", "mu", "nu"} each), step.pt;
    the manifest's meta is the CLI's vars(args), as in JAX, from which
    pipelines/textural.config_from_train_meta rebuilds the nets, and
    restore_variables(dir, ["netG", "netE"]) serves the step;
  - semantic training (cli/semantic_train): encoder.pt, decoder.pt,
    opt_enc.pt and opt_dec.pt ({"count", "trace"}: each SGD optimizer's
    schedule count and momentum traces by parameter name), step.pt; the
    manifest's meta is vars(args); semantic_test and semantic_eval
    --ckpt_dir read encoder.pt and decoder.pt;
  - Mask R-CNN training (cli/detect_train): maskrcnn.pt (the reference
    layout, which geometric_main and edit_chain --maskrcnn_ckpt read),
    opt_state.pt ({"labels": {name: "train" | "transfer" | "freeze"},
    "trace": {group: {name: momentum trace}}}), step.pt; the manifest's
    meta is vars(args).
The JAX package's orbax step directories are not readable here; their
variables convert with utils/port into a step of this layout.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

_SUFFIX = ".pt"


def save_checkpoint(directory: str, step: int, state: Mapping[str, Any],
                    meta: Optional[dict] = None) -> str:
    """Save each field of `state` (a state_dict or any torch-saveable
    value) to directory/step-{step}/{field}.pt, replacing an existing step,
    and write the manifest.  Returns the step's path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step-{step}")
    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, value in state.items():
        torch.save(value, os.path.join(tmp, name + _SUFFIX))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump({"step": step, "meta": meta or {}}, f, indent=2)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step-"):
            try:
                steps.append(int(name.split("-", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _step_fields(directory: str, step: Optional[int]
                 ) -> Tuple[str, Dict[str, str], int]:
    """(step path, {field: file}, step) of the given or newest step."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step-{step}")
    fields = {n[:-len(_SUFFIX)]: os.path.join(path, n)
              for n in sorted(os.listdir(path)) if n.endswith(_SUFFIX)}
    if not fields:
        raise ValueError(f"{path} holds no torch fields ({_SUFFIX} files): "
                         f"an orbax step of the JAX package is not readable "
                         f"here; convert its variables with utils/port")
    return path, fields, step


def _load(file: str):
    return torch.load(file, map_location="cpu", weights_only=True)


def restore_checkpoint(directory: str, step: Optional[int] = None
                       ) -> Tuple[Dict[str, Any], int]:
    """Every field of the given (or newest) step: ({field: value}, step)."""
    _, fields, step = _step_fields(directory, step)
    return {name: _load(f) for name, f in fields.items()}, step


def restore_variables(directory: str, names: Sequence[str],
                      step: Optional[int] = None
                      ) -> Tuple[Dict[str, Any], int]:
    """The nets `names` of the given (or newest) step, from a step of
    bare nets or of a whole train state, whose other fields (step count,
    optimizer state) are not read: ({name: state_dict}, step)."""
    path, fields, step = _step_fields(directory, step)
    missing = [n for n in names if n not in fields]
    if missing:
        raise ValueError(f"checkpoint at {path} has no {missing} field: "
                         f"{list(fields)}")
    return {n: _load(fields[n]) for n in names}, step


def load_meta(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


def load_state_dicts(path: str, names: Sequence[str]) -> Dict[str, Any]:
    """The nets `names` behind a CLI's checkpoint argument: a step
    directory (restore_variables, the newest step), or a torch file written
    from JAX variables by utils/port: the bare state_dict for one name, a
    dict keyed by the names for several."""
    if os.path.isdir(path):
        nets, step = restore_variables(path, names)
        print(f"restored {', '.join(names)} from {path} step {step}")
        return nets
    sd = _load(path)
    print(f"restored {', '.join(names)} state_dict file {path}")
    return {names[0]: sd} if len(names) == 1 else {n: sd[n] for n in names}

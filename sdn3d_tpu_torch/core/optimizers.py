"""Sparse-aware Adam (NR-9 equivalent), PyTorch port of
sdn3d_tpu/core/optimizers.py.

The reference ships a custom chainer Adam rule
(geometric/neural_renderer/optimizers.py:9-39) with two behaviors:

1. a weight element whose gradient is exactly zero is NOT updated — its
   Adam moments are frozen and the parameter is left untouched (the cupy
   kernel guards the whole update on ``grad != 0``);
2. a per-parameter learning-rate multiplier (``param.lr``).

No entry point uses it.  As in pipelines/derender_infer.adam_step it is
written as plain tensor functions: the parameters, gradients and moments
are trees of tensors (nested dicts, or a flat {name: tensor} dict), the
arithmetic is elementwise in optax's order, and the step count is global
(chainer's t, one increment an update, not one an element).
utils/port.sparse_adam_state_from_jax converts the JAX package's state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import torch


def tree_map(fn: Callable, *trees):
    """fn over the leaves of nested dicts of tensors of the same keys."""
    if isinstance(trees[0], Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass
class SparseAdamState:
    """count: the global step count (chainer's t); mu, nu: the moments,
    trees of the parameters' shape."""
    count: int
    mu: Any
    nu: Any


def sparse_adam_init(params) -> SparseAdamState:
    """Count 0 and zero moments."""
    return SparseAdamState(0, tree_map(torch.zeros_like, params),
                           tree_map(torch.zeros_like, params))


def scale_by_sparse_adam(grads, state: SparseAdamState, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8
                         ) -> Tuple[Any, SparseAdamState]:
    """Adam moment scaling that skips zero-gradient elements (JAX
    `scale_by_sparse_adam`).  Where ``grad == 0`` the moments keep their
    values and the update is zero; elsewhere chainer's
    ``m += (1-b1)(g-m)`` / ``v += (1-b2)(g²-v)`` (v clipped at 0), and the
    update ``alpha_t·m / (sqrt(v) + eps)`` with the bias correction
    ``alpha_t = sqrt(1-b2^t) / (1-b1^t)`` of the global count t, in float32
    as the JAX package computes it.  Returns (updates, new state)."""
    t = state.count + 1

    def upd(g, m, v):
        tf = torch.tensor(float(t), dtype=torch.float32, device=g.device)
        alpha_t = torch.sqrt(1.0 - torch.pow(b2, tf)) \
            / (1.0 - torch.pow(b1, tf))
        live = g != 0
        m2 = torch.where(live, m + (1 - b1) * (g - m), m)
        v2 = torch.where(live, torch.clamp_min(v + (1 - b2) * (g * g - v),
                                               0.0), v)
        step = torch.where(live, alpha_t * m2 / (torch.sqrt(v2) + eps),
                           torch.zeros_like(m2))
        return step, m2, v2

    out = tree_map(upd, grads, state.mu, state.nu)
    return _leaf(out, 0), SparseAdamState(t, _leaf(out, 1), _leaf(out, 2))


def _leaf(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _leaf(v, i) for k, v in tree.items()}
    return tree[i]


def apply_lr_scales(updates, lr_scales):
    """Per-parameter learning-rate multipliers (``param.lr``): `lr_scales`
    is a prefix of the updates' tree whose leaves are numbers, each
    scaling its whole subtree (or a tree of the same keys, one number a
    parameter)."""
    if not isinstance(lr_scales, Mapping):
        return tree_map(lambda u: u * lr_scales, updates)
    return {k: (apply_lr_scales(v, lr_scales[k]) if k in lr_scales else v)
            for k, v in updates.items()}


def sparse_adam_step(params, grads, state: SparseAdamState,
                     learning_rate: float, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8,
                     lr_scales: Optional[Any] = None
                     ) -> Tuple[Any, SparseAdamState]:
    """One step of the JAX package's `sparse_adam(learning_rate, b1, b2,
    eps, lr_scales)` followed by optax.apply_updates: the scaled moments,
    the lr scales, then -learning_rate times the update added to each
    parameter.  Returns (new params, new state); the inputs are not
    written."""
    updates, state = scale_by_sparse_adam(grads, state, b1, b2, eps)
    if lr_scales is not None:
        updates = apply_lr_scales(updates, lr_scales)
    params = tree_map(lambda p, u: p + (-learning_rate) * u, params, updates)
    return params, state


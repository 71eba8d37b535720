"""AdamW from scratch (``src/repro/optim/adamw.py``), over the port's
parameter tree.

The same arithmetic as JAX's, leaf by leaf, in fp32: global-norm clipping,
the warmup + cosine / linear / constant schedule, bias-corrected moments
kept in ``moment_dtype``, and decoupled weight decay on matrices only
(``ndim >= 2``). Every quantity stays a device tensor — the step count,
the learning rate, the clip scale — so an update never synchronises with
the host (L3 runs several back to back). ``update(..., inplace=True)``
writes the new parameters and moments into the old tensors (the PyTorch
counterpart of donation, linkage L2+); otherwise it returns new ones and
leaves the old intact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    count: torch.Tensor     # () int32, steps taken
    mu: Any                 # first moments, the params' tree
    nu: Any                 # second moments


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | linear | constant


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a device tensor), fp32: linear
    warmup over ``warmup_steps``, then cosine or linear decay to 0 at
    ``total_steps``, or constant."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    else:
        decay = 1 - frac
    return cfg.lr * warm * decay


def global_norm(grads, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, summed leaf by
    leaf in tree order as JAX's Python ``sum`` does.

    With ``specs`` (and ``mesh``) ``grads`` holds this rank's pieces of a
    sharded gradient, and this is the norm of the whole gradient: each
    piece's squares counted once (a piece replicated over an axis only on
    index 0 of that axis), then summed over every rank."""
    if specs is None:
        total = None
        for g in tree.leaves(grads):
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    from repro_torch.sharding.rules import spec_axes, spec_leaves
    leaves = tree.leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g, spec in zip(leaves, spec_leaves(specs)):
        cut = spec_axes(spec)
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in cut):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(mesh.world.sum_(total))


def init(cfg: AdamWConfig, params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    device = tree.leaves(params)[0].device
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree.tree_map(zeros, params),
                      nu=tree.tree_map(zeros, params))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
           inplace: bool = False, specs=None, mesh=None
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step (``adamw.py:63-96``): (new params, new state,
    {"grad_norm", "lr"}). ``grads`` has the params' structure. With
    ``specs`` (the params' spec tree) and ``mesh``, every tree holds this
    rank's pieces: the clip reads the whole gradient's norm, and the rest
    is elementwise, piece by piece; a piece keeps its leaf's ``ndim``, so
    weight decay still falls on the matrices alone."""
    count = state.count + 1
    gnorm = global_norm(grads, specs, mesh)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0 else None)
    lr = schedule_lr(cfg, count)
    cf = count.float()
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)

    def upd(g, m, v, p):
        gf = g.float() if scale is None else g.float() * scale
        m32 = m.float() * cfg.b1 + gf * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + gf * gf * (1 - cfg.b2)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2 and cfg.weight_decay > 0:
            step = step + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        new_m, new_v = m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype)
        if inplace:
            p.copy_(new_p), m.copy_(new_m), v.copy_(new_v)
            return p, m, v
        return new_p, new_m, new_v

    outs = [upd(g, m, v, p) for g, m, v, p in zip(
        tree.leaves(grads), tree.leaves(state.mu), tree.leaves(state.nu),
        tree.leaves(params))]
    new_params = tree.unflatten(params, (o[0] for o in outs))
    new_mu = tree.unflatten(state.mu, (o[1] for o in outs))
    new_nu = tree.unflatten(state.nu, (o[2] for o in outs))
    if inplace:
        state.count.copy_(count)
        count = state.count
    return (new_params, AdamWState(count, new_mu, new_nu),
            {"grad_norm": gnorm, "lr": lr})

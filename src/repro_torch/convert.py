"""Weights from the JAX package into the port — the only way they cross.

``params_from_jax`` takes the tree ``repro.models.init_params`` returns
(its leaves as numpy arrays, or anything ``np.asarray`` reads: a caller
holding jax arrays passes them as they are, and this module never imports
jax), with ``blocks`` stacked per block-pattern position and dense weights
in ``(d_in, d_out)`` layout, and returns the port's parameters: one dict per
layer in execution order (block-major, as the JAX scan runs them), the same
keys, the same layout. A tree without ``lm_head`` is a tied-embedding model;
one without ``embed`` an ``embeds_in`` model (its inputs are embeddings).
MoE layers carry over as they are (``router`` (D, E) and the ``wi``, ``wg``,
``wo`` expert stacks (E, D, F) / (E, F, D), one more leading block axis in
the tree), and so do RWKV layers (the mixer's projections, decay bias,
token-shift mixes, group-norm scale and per-head bonus ``u`` (nh, hd); the
channel mix's ``wk``, ``wv``, ``wr`` and mixes), and so do Mamba layers
(``in_proj``, ``conv_w``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``,
``D``, ``out_proj``), and so do cross-attention layers (``xq``, ``xk``,
``xv``, ``xo`` and the gate ``xgate``). Every leaf keeps its dtype: JAX's
``init_params`` casts every float32 leaf to ``param_dtype``
(``transformer.py:67``),
``A_log`` and ``D`` included, and the port's init casts the same leaves. A
bfloat16 leaf (an ``ml_dtypes`` array, which ``torch.from_numpy`` cannot
read) goes through float32, exactly. ``train_state_from_jax`` takes a
whole JAX ``TrainState`` across the same way: the parameters and both
AdamW moments through ``params_from_jax``'s mapping, the step count and
the step as int32 scalars.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device, tree


def _tensor(a, device) -> torch.Tensor:
    """One leaf on ``device`` in its own dtype (a bfloat16 one through
    float32, exactly)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return _tensor(arr.astype(np.float32), device).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(jax_tree: Dict[str, Any],
                    device="cuda") -> Dict[str, Any]:
    """JAX parameter tree -> the port's parameters on ``device`` (``cuda``
    unless the caller asks for the CPU; ``cuda`` without a GPU raises)."""
    device = resolve_device(device)
    blocks = jax_tree["blocks"]
    num_blocks = np.shape(tree.leaves(blocks[0])[0])[0]
    layers = [tree.tree_map(lambda a, b=b: _tensor(np.asarray(a)[b], device),
                            group)
              for b in range(num_blocks) for group in blocks]
    params = {"layers": layers,
              "final_norm": tree.tree_map(lambda a: _tensor(a, device),
                                          jax_tree["final_norm"])}
    if "embed" in jax_tree:
        params["embed"] = _tensor(jax_tree["embed"], device)
    if "lm_head" in jax_tree:
        params["lm_head"] = _tensor(jax_tree["lm_head"], device)
    return params


def train_state_from_jax(state, device="cuda"):
    """A JAX ``TrainState`` (``params``, ``opt`` = ``AdamWState(count, mu,
    nu)``, ``step``; leaves as numpy arrays or anything ``np.asarray``
    reads) -> the port's ``TrainState`` on ``device``, every leaf in its
    own dtype (the moments in JAX's ``moment_dtype``)."""
    from repro_torch.core.step import TrainState
    from repro_torch.optim.adamw import AdamWState
    device = resolve_device(device)

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)
    opt = state.opt
    return TrainState(
        params=params_from_jax(state.params, device),
        opt=AdamWState(count=scalar(opt.count),
                       mu=params_from_jax(opt.mu, device),
                       nu=params_from_jax(opt.nu, device)),
        step=scalar(state.step))

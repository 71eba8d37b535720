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
read) goes through float32, exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a, device) -> torch.Tensor:
    """One leaf on ``device`` in its own dtype (a bfloat16 one through
    float32, exactly)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return _tensor(arr.astype(np.float32), device).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """JAX parameter tree -> the port's parameters on ``device`` (``cuda``
    unless the caller asks for the CPU; ``cuda`` without a GPU raises)."""
    device = resolve_device(device)
    blocks = tree["blocks"]
    num_blocks = np.shape(next(_leaves(blocks[0])))[0]
    layers = [_map(group, lambda a, b=b: _tensor(np.asarray(a)[b], device))
              for b in range(num_blocks) for group in blocks]
    params = {"layers": layers,
              "final_norm": _map(tree["final_norm"],
                                 lambda a: _tensor(a, device))}
    if "embed" in tree:
        params["embed"] = _tensor(tree["embed"], device)
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"], device)
    return params

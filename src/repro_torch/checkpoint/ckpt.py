"""Checkpointing with atomic commits (``src/repro/checkpoint/ckpt.py``).

Layout, as JAX's: ``<dir>/step_<N>/arrays.npz`` (``leaf_<i>``, the state's
leaves in tree order) and ``meta.json`` (step, extra, each leaf's dtype);
a ``COMMIT`` marker is written last, so a crash mid-save never leaves a
checkpoint that ``latest_step`` picks up. bfloat16, which numpy lacks, is
stored as its uint16 bits.

``restore`` puts the arrays on the device of the state it is given, in
that state's dtypes. A sharded state is saved as its full logical arrays
(``save(..., specs, mesh)``: gathered over the mesh, written by rank 0
alone), so the files are the unsharded layout, and ``restore(...,
specs, mesh)`` keeps this rank's pieces of them under the *current*
mesh, whatever mesh wrote them: the elastic restore (JAX
``ckpt.py:94-118``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


def _encode(x) -> Tuple[np.ndarray, str]:
    """npz-safe encoding: bf16 views as uint16."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, a.dtype.name


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, state, extra: Optional[Dict] = None,
         specs=None, mesh=None) -> str:
    """Atomically write a checkpoint for ``step``. Returns its path. With
    ``specs`` (and ``mesh``), ``state`` is this rank's pieces: every rank
    calls this, the full arrays are gathered, and rank 0 writes them."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if specs is not None:
        from repro_torch.sharding.rules import gather
        state = gather(state, specs, mesh)
        if mesh.rank != 0:
            return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        arrays, dtypes = {}, {}
        for i, x in enumerate(tree.leaves(state)):
            arrays[f"leaf_{i}"], dtypes[f"leaf_{i}"] = _encode(x)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": step, "extra": extra or {}, "dtypes": dtypes}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if (name.startswith("step_")
                and os.path.exists(os.path.join(path, "COMMIT"))):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, state_like, specs=None, mesh=None):
    """The checkpoint of ``step`` in the structure of ``state_like`` (a
    tree of tensors), each leaf on its ``state_like`` leaf's device and in
    its dtype. With ``specs`` (and ``mesh``), ``state_like`` holds this
    rank's pieces, and each full array read is cut to this rank's piece
    on the host before it moves."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like = tree.leaves(state_like)
    if len(meta["dtypes"]) != len(like):
        raise ValueError(f"checkpoint {path} holds {len(meta['dtypes'])} "
                         f"leaves; the state has {len(like)}")
    cut = [None] * len(like)
    if specs is not None:
        from repro_torch.sharding.rules import shard_leaf, spec_leaves
        cut = spec_leaves(specs)

    def load(i, x):
        t = _decode(z[f"leaf_{i}"], meta["dtypes"][f"leaf_{i}"])
        if cut[i] is not None:
            t = shard_leaf(t, cut[i], mesh, mesh.coords)
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"checkpoint {path} leaf {i}: shape "
                             f"{tuple(t.shape)}, the state's "
                             f"{tuple(x.shape)}")
        return t.to(device=x.device, dtype=x.dtype)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        out = [load(i, x) for i, x in enumerate(like)]
    return tree.unflatten(state_like, out)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)

"""Checkpointing with atomic commits (``src/repro/checkpoint/ckpt.py``).

Layout, as JAX's: ``<dir>/step_<N>/arrays.npz`` (``leaf_<i>``, the state's
leaves in tree order) and ``meta.json`` (step, extra, each leaf's dtype);
a ``COMMIT`` marker is written last, so a crash mid-save never leaves a
checkpoint that ``latest_step`` picks up. bfloat16, which numpy lacks, is
stored as its uint16 bits.

``restore`` puts the arrays on the device of the state it is given, in
that state's dtypes. Elastic restore onto another mesh waits for
training over a mesh (ROADMAP entry 9b).
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


def save(ckpt_dir: str, step: int, state, extra: Optional[Dict] = None
         ) -> str:
    """Atomically write a checkpoint for ``step``. Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
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


def restore(ckpt_dir: str, step: int, state_like):
    """The checkpoint of ``step`` in the structure of ``state_like`` (a
    tree of tensors), each leaf on its ``state_like`` leaf's device and in
    its dtype."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like = tree.leaves(state_like)
    if len(meta["dtypes"]) != len(like):
        raise ValueError(f"checkpoint {path} holds {len(meta['dtypes'])} "
                         f"leaves; the state has {len(like)}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        out = [_decode(z[f"leaf_{i}"], meta["dtypes"][f"leaf_{i}"])
               .to(device=x.device, dtype=x.dtype)
               for i, x in enumerate(like)]
    return tree.unflatten(state_like, out)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)

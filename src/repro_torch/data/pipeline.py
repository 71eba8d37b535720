"""Deterministic synthetic token pipeline with device staging
(``src/repro/data/pipeline.py``).

A seeded, restartable stream of next-token-prediction batches: documents
of tokens that follow a fixed bigram successor table 85 % of the time (so
the loss can fall), as (B, S) ``inputs``/``labels``; an ``embeds_in``
model's inputs are (B, S, D) embeddings, and a cross-attention model's
batch carries its context ``xctx``. The generator is numpy's, with JAX's
draws in JAX's order, so the same seed and step give JAX's batch bit for
bit. ``stacked_at`` stacks K consecutive batches for the L3 step.

Determinism contract: ``Pipeline(seed).batch_at(step)`` always regenerates
the same batch — checkpoint/restart replays the stream exactly, which is
what makes the driver's recovery exact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 1234
    vocab_cap: int = 0            # 0 = arch vocab


class Pipeline:
    """Stateless-per-step batch generator (step index -> batch)."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        self.vocab = min(cfg.vocab_size, dcfg.vocab_cap or cfg.vocab_size)
        # fixed bigram successor table gives the stream learnable structure
        rng = np.random.default_rng(dcfg.seed)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab,),
                                  dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        d = self.dcfg
        rng = np.random.default_rng((d.seed, step))
        B, S = d.global_batch, d.seq_len
        start = rng.integers(0, self.vocab, size=(B, 1), dtype=np.int32)
        noise = rng.random((B, S + 1)) < 0.15
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = start[:, 0]
        for t in range(1, S + 1):
            toks[:, t] = self._succ[toks[:, t - 1]]
        rand = rng.integers(0, self.vocab, size=(B, S + 1), dtype=np.int32)
        toks = np.where(noise, rand, toks)
        batch: Dict[str, Any] = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.embeds_in:
            batch["inputs"] = rng.standard_normal(
                (B, S, self.cfg.d_model), dtype=np.float32) * 0.1
        if self.cfg.xattn_ctx_len:
            batch["xctx"] = rng.standard_normal(
                (B, self.cfg.xattn_ctx_len, self.cfg.xattn_ctx_dim),
                dtype=np.float32) * 0.1
        return batch

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1

    def stacked_at(self, step: int, k: int) -> Dict[str, np.ndarray]:
        """K consecutive batches stacked on a leading dim (L3 staging)."""
        bs = [self.batch_at(step + i) for i in range(k)]
        return {key: np.stack([b[key] for b in bs]) for key in bs[0]}


def stage(batch: Dict[str, np.ndarray], device="cuda", specs=None,
          mesh=None) -> Dict[str, torch.Tensor]:
    """Host -> device copy of a batch (the "copy into the pinned stack"),
    each array as a tensor of its dtype on ``device`` (``cuda`` unless the
    caller asks for the CPU). With ``specs`` (a spec an array, as
    ``build_sharded_train_step`` returns them) and ``mesh``, this rank's
    rows alone (JAX ``pipeline.py:78-82``): every rank of a data row its
    share, or the whole batch where the spec replicates it."""
    from repro_torch.sharding.rules import shard_leaf
    device = resolve_device(device)

    def put(k, v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if specs is not None:
            t = shard_leaf(t, specs[k], mesh, mesh.coords)
        return t.to(device)
    return {k: put(k, v) for k, v in batch.items()}

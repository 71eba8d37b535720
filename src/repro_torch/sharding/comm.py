"""Collectives of the port's mesh serving: the one place they are issued.

``AxisComm`` runs collectives over one mesh axis (the ranks that share
every other coordinate). Every collective is built from ``all_reduce``
and ``broadcast``, the two that gloo takes for CUDA tensors as well as
CPU ones, so the same code runs over gloo (ranks on the CPU, or sharing
one card) and over NCCL (a card a rank). An axis of size 1 is the
identity: no call reaches ``torch.distributed``, and the single-device
path computes bit for bit what it computed before.

``TensorParallel`` is what the model layers read (``ModelOptions.tp``):
Megatron-style tensor parallelism over the "model" axis. Column-parallel
projections (``wq``/``wk``/``wv`` and their biases, ``wi``/``wg``) need
no collective: each rank computes its heads or its slice of ``d_ff``.
Row-parallel ones (attention's and the MLP's ``wo``) end in one
``all_reduce``. The vocab-parallel embedding zeroes the ids outside the
rank's rows and sums; the vocab-parallel ``lm_head`` writes the rank's
slice of the logits into zeros and sums, which is exact (every other
entry adds zero).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


class AxisComm:
    """Collectives over one process group: ``size`` ranks, this one at
    ``index``; ``src`` is the global rank of index 0 (the broadcast
    root)."""

    def __init__(self, group=None, size: int = 1, index: int = 0,
                 src: int = 0):
        self.group, self.size, self.index, self.src = group, size, index, src

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place (``t`` contiguous)."""
        if self.size > 1:
            import torch.distributed as dist
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Index 0's ``t`` on every rank of the axis, in place."""
        if self.size > 1:
            import torch.distributed as dist
            dist.broadcast(t, src=self.src, group=self.group)
        return t

    def place(self, local: torch.Tensor, full_len: int,
              dim: int = 0) -> torch.Tensor:
        """Every rank's ``local`` slice of ``dim`` (the ranks' slices
        consecutive, this one's at ``index``) assembled into the full
        tensor on every rank: written into zeros, then summed."""
        if self.size == 1:
            return local
        shape = list(local.shape)
        n = shape[dim]
        shape[dim] = full_len
        out = torch.zeros(shape, dtype=local.dtype, device=local.device)
        out.narrow(dim, self.index * n, n).copy_(local)
        return self.sum_(out)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """The model layers' view of tensor parallelism over "model".

    heads        attention is head-parallel: its ``wo`` is row-parallel
                 (else attention runs replicated, no reduce)
    ff           the dense MLP's ``d_ff`` is split: its ``wo`` is
                 row-parallel
    vocab        (lo, hi): this rank's rows of the embedding and columns
                 of ``lm_head``, of ``vocab_size`` (None: replicated)
    kv_heads     the KV heads this rank's query heads read when the KV
                 heads are not split (HKV does not divide by the axis):
                 every rank computes and caches every head (None: every
                 cached head is local)
    """
    comm: AxisComm
    heads: bool = False
    ff: bool = False
    vocab: Optional[Sequence[int]] = None
    vocab_size: int = 0
    kv_heads: Optional[slice] = None

    def row_parallel(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """The output of a row-parallel product, summed over the axis
        (``split``: the product's inner dimension is split)."""
        return self.comm.sum_(y) if split else y

    def kv_view(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The KV heads (along ``dim``) this rank's queries attend to."""
        if self.kv_heads is None:
            return t
        sl = self.kv_heads
        return t.narrow(dim, sl.start, sl.stop - sl.start).contiguous()

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the vocab-parallel embedding: the ids in this rank's
        range looked up, the others zero, summed over the axis."""
        if self.vocab is None:
            return table[ids]
        lo, hi = self.vocab
        # a negative id reads from the end, as indexing the whole table does
        ids = torch.where(ids < 0, ids + self.vocab_size, ids)
        mine = (ids >= lo) & (ids < hi)
        rows = table[torch.where(mine, ids - lo, 0)]
        return self.comm.sum_(rows * mine[..., None].to(rows.dtype))

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """The full logits from this rank's vocab columns."""
        if self.vocab is None:
            return local
        return self.comm.place(local, self.vocab_size, local.dim() - 1)

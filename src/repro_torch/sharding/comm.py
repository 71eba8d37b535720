"""Collectives of the port's meshes: the one place they are issued.

``AxisComm`` runs collectives over one mesh axis (the ranks that share
every other coordinate). Every collective is built from ``all_reduce``
and ``broadcast``, the two that gloo takes for CUDA tensors as well as
CPU ones, so the same code runs over gloo (ranks on the CPU, or sharing
one card) and over NCCL (a card a rank). An axis of size 1 is the
identity: no call reaches ``torch.distributed``, and the single-device
path computes bit for bit what it computed before. Every collective adds
the bytes of the tensor it is given to a per-process count by kind
(``traffic``), which the training mesh and the compressed reduce log.

``TensorParallel`` is what the model layers read (``ModelOptions.tp``):
Megatron-style tensor parallelism over the "model" axis. Column-parallel
projections (``wq``/``wk``/``wv`` and their biases, ``wi``/``wg``) need
no collective forward: each rank computes its heads or its slice of
``d_ff``. Row-parallel ones (attention's and the MLP's ``wo``) end in one
``all_reduce``. The vocab-parallel embedding zeroes the ids outside the
rank's rows and sums; the vocab-parallel ``lm_head`` writes the rank's
slice of the logits into zeros and sums, which is exact (every other
entry adds zero).

Under training autograd must see those sums (Megatron's "f" and "g"):
``enter`` is the identity forward and a sum over "model" backward, at
the input of each column-parallel block (every rank's share of the
input's gradient added up); ``row_parallel`` and the embedding's sum are
a sum forward and the identity backward; the logits' ``place`` passes
back the rank's slice of the incoming gradient. Without grad (serving)
each is the in-place collective it was, so serving's outputs do not
move.

The zoo's other layers read their local widths here, not from a
shrunken config: the rank's experts (``experts``), its slice of Mamba's
inner width (``di``) and its RWKV heads (``rwkv``). Two more collectives
serve them under training: ``sum_both``, a sum over "model" forward and
backward (Mamba's ``x_proj`` output, partial from a row-parallel product,
feeds work split over the channels again, whose gradient is partial
too), and ``all_to_all`` over the ranks the experts are cut over under
``ep_resident`` (``ep``), whose backward is the reverse exchange. ``once``
marks a value every rank computes whole whose gradient is then summed
over "model" (the MoE aux loss): its gradient is divided by the axis
size, so the sum counts it once.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Sequence

import torch

#: bytes handed to each kind of collective in this process
_TRAFFIC: Dict[str, int] = collections.Counter()


def traffic() -> Dict[str, int]:
    """Bytes of the tensors handed to each kind of collective in this
    process since the last ``reset_traffic`` ("all_reduce", "broadcast",
    and "all_to_all": the broadcasts of an all-to-all, every index's send
    buffer once; what one rank sends or receives through the call, not
    what the backend moves inside it)."""
    return dict(_TRAFFIC)


def reset_traffic() -> None:
    _TRAFFIC.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    _TRAFFIC[kind] += t.numel() * t.element_size()


class AxisComm:
    """Collectives over one process group: ``size`` ranks, this one at
    ``index``; ``src`` is the global rank of index 0 (the broadcast
    root) and ``ranks`` the global rank of every index."""

    def __init__(self, group=None, size: int = 1, index: int = 0,
                 src: int = 0, ranks: Optional[Sequence[int]] = None):
        self.group, self.size, self.index, self.src = group, size, index, src
        self.ranks = (tuple(ranks) if ranks is not None
                      else tuple(range(src, src + size)))

    def _reduce_(self, t: torch.Tensor, op: str) -> torch.Tensor:
        if self.size > 1:
            import torch.distributed as dist
            _count("all_reduce", t)
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op),
                            group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place (``t`` contiguous)."""
        return self._reduce_(t, "SUM")

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the axis, in place."""
        return self._reduce_(t, "MAX")

    def broadcast_(self, t: torch.Tensor, index: int = 0,
                   kind: str = "broadcast") -> torch.Tensor:
        """Index ``index``'s ``t`` on every rank of the axis, in place
        (its bytes counted under ``kind``)."""
        if self.size > 1:
            import torch.distributed as dist
            _count(kind, t)
            dist.broadcast(t, src=self.ranks[index], group=self.group)
        return t

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def all_gather(self, local: torch.Tensor, dim: int = 0,
                   kind: str = "broadcast") -> torch.Tensor:
        """Every index's ``local`` (equal shapes) concatenated along
        ``dim`` in index order, on every rank: one broadcast from each
        index, so every piece arrives bit for bit."""
        if self.size == 1:
            return local
        local = local.contiguous()
        parts = [self.broadcast_(local if i == self.index
                                 else torch.empty_like(local), i, kind)
                 for i in range(self.size)]
        return torch.cat(parts, dim)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk ``j`` of ``x``'s first dimension (``size`` equal chunks)
        to index ``j``: returns the chunks every index sent this one, in
        index order. Applied twice it is the identity, so it is its own
        reverse. Built from ``all_gather`` (gloo has no all-to-all for
        every tensor): every index's whole ``x`` reaches every rank, counted
        under "all_to_all"."""
        if self.size == 1:
            return x
        n = x.shape[0] // self.size
        if n * self.size != x.shape[0]:
            raise ValueError(f"all_to_all: dimension 0 of size {x.shape[0]} "
                             f"does not split into {self.size} chunks")
        every = self.all_gather(x, 0, "all_to_all")
        return torch.cat([every.narrow(0, i * x.shape[0] + self.index * n, n)
                          for i in range(self.size)])

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


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Enter(torch.autograd.Function):
    """Megatron's "f": the identity forward, the gradient summed over the
    axis backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum_(g.contiguous().clone()), None


class _Sum(torch.autograd.Function):
    """Megatron's "g": a sum over the axis forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, y, comm):
        return comm.sum_(y.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """A sum over the axis forward and backward ("g" then "f")."""

    @staticmethod
    def forward(ctx, y, comm):
        ctx.comm = comm
        return comm.sum_(y.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum_(g.contiguous().clone()), None


class _Once(torch.autograd.Function):
    """The identity forward; the gradient divided by the axis size
    backward."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _AllToAll(torch.autograd.Function):
    """``AxisComm.all_to_all`` forward; the reverse exchange (the same
    one) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g.contiguous()), None


class _Place(torch.autograd.Function):
    """``AxisComm.place`` forward; backward, this rank's slice of the
    incoming gradient (the same on every rank)."""

    @staticmethod
    def forward(ctx, local, comm, full_len, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, local.shape[dim]
        return comm.place(local, full_len, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.comm.index * ctx.n, ctx.n), None, None,
                None)


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
    experts      (lo, hi): this rank's MoE experts, of ``num_experts``
                 (routing stays global; the output is summed over the
                 axis). None: every expert, or ``ep``'s
    di           (lo, hi): this rank's channels of Mamba's inner width
                 (its ``xin`` and ``z`` halves of ``in_proj``; ``x_proj``
                 and ``out_proj`` row-parallel). None: replicated
    rwkv         (lo, hi): this rank's RWKV time-mix heads (``wo``
                 row-parallel). None: replicated
    ep           ``ep_resident``: the ranks the experts are cut over (every
                 rank of the mesh); a MoE layer's dispatched tokens move
                 to their experts' rank and back by ``all_to_all``
    """
    comm: AxisComm
    heads: bool = False
    ff: bool = False
    vocab: Optional[Sequence[int]] = None
    vocab_size: int = 0
    kv_heads: Optional[slice] = None
    experts: Optional[Sequence[int]] = None
    di: Optional[Sequence[int]] = None
    rwkv: Optional[Sequence[int]] = None
    ep: Optional[AxisComm] = None

    @staticmethod
    def width(rng: Optional[Sequence[int]], full: int) -> int:
        """The local width of a (lo, hi) range (``full`` when None)."""
        return full if rng is None else rng[1] - rng[0]

    def enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """The input of a column-parallel block (``split``: its output
        dimension is split): its gradient summed over the axis."""
        if split and self.comm.size > 1 and _tracked(x):
            return _Enter.apply(x, self.comm)
        return x

    def _sum(self, y: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(y, self.comm) if _tracked(y) else self.comm.sum_(y)

    def row_parallel(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """The output of a row-parallel product, summed over the axis
        (``split``: the product's inner dimension is split)."""
        return self._sum(y) if split and self.comm.size > 1 else y

    def sum_both(self, y: torch.Tensor) -> torch.Tensor:
        """A partial result summed over the axis, whose gradient is
        partial on every rank too and is summed the same way."""
        if self.comm.size == 1:
            return y
        return (_SumBoth.apply(y, self.comm) if _tracked(y)
                else self.comm.sum_(y))

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """A value every rank computes whole, whose gradient is then summed
        over the axis: its gradient divided by the axis size."""
        if self.comm.size > 1 and _tracked(t):
            return _Once.apply(t, self.comm.size)
        return t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``ep``'s all-to-all (its gradient the reverse exchange)."""
        if _tracked(x):
            return _AllToAll.apply(x.contiguous(), self.ep)
        return self.ep.all_to_all(x.contiguous())

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
        # F.embedding: its CUDA backward sums each row's gradients in a
        # fixed order (the rows read are the indexing's, bit for bit)
        rows = torch.nn.functional.embedding(torch.where(mine, ids - lo, 0),
                                             table)
        return self._sum(rows * mine[..., None].to(rows.dtype))

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """The full logits from this rank's vocab columns (whose input went
        through ``enter``)."""
        if self.vocab is None:
            return local
        dim = local.dim() - 1
        if _tracked(local):
            return _Place.apply(local, self.comm, self.vocab_size, dim)
        return self.comm.place(local, self.vocab_size, dim)

"""Where one rank's share of a sharded serving engine lives: its weights,
its configuration at local widths, its slot rows, and the collectives of
each axis (JAX ``serve/cache.py:236-290`` and ``core/step.py:261-278``,
which let ``jit`` place the same things by the partition rules).

``serve_shard(cfg, params, mesh, n_slots)`` resolves ``ArchSharding``'s
decisions for one rank:

  weights   cut by ``serve_param_specs``: column-parallel ``wq``/``wk``/
            ``wv``/``wi``/``wg`` (and biases), row-parallel ``wo``,
            vocab-parallel ``embed``/``lm_head``, the rest replicated.
  config    the local head counts and ``d_ff`` (``local_config``), so
            every layer and kernel sees the local shapes: at model 2 the
            full-width tinyllama-1.1b runs HQ 16, HKV 2 a rank.
  KV        the cache holds the local KV heads (``tp_kv``), or every head
            when HKV does not divide by the model axis: then the rank
            holds ``wk``/``wv`` whole (JAX's spec still column-shards
            them; the weights never change, so they are cut whole once
            here) and its queries read their heads' slice
            (``TensorParallel.kv_heads``).
  slots     split over "data" when they divide (``serve_slot_axis``):
            this rank computes ``rows`` only, and the programs' tokens are
            merged over the data axis; otherwise replicated.

MoE (expert parallelism), Mamba and RWKV layers at model > 1 raise
``NotImplementedError`` naming ROADMAP entry 9c; data-only meshes serve
every servable config.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ATTN, DENSE, SWA, ArchConfig
from repro_torch.sharding.comm import AxisComm, TensorParallel
from repro_torch.sharding.rules import ArchSharding, shard, tp_size


def _entry_9c(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} at a model axis > 1 is not ported yet (ROADMAP entry 9c); "
        "data-only meshes serve it")


def local_config(cfg: ArchConfig, sh: ArchSharding) -> ArchConfig:
    """``cfg`` at one model shard's widths: the local query heads (when
    ``tp_heads``), KV heads (when ``tp_kv`` too) and ``d_ff`` (when
    ``tp_ff``); ``head_dim`` fixed."""
    tp = tp_size(sh.mesh)
    if tp == 1:
        return cfg
    return dataclasses.replace(
        cfg, d_head=cfg.head_dim,
        n_heads=cfg.n_heads // tp if sh.tp_heads else cfg.n_heads,
        n_kv_heads=(cfg.n_kv_heads // tp if sh.tp_heads and sh.tp_kv
                    else cfg.n_kv_heads),
        d_ff=cfg.d_ff // tp if sh.tp_ff else cfg.d_ff)


def tensor_parallel(cfg: ArchConfig, sh: ArchSharding,
                    comm: AxisComm) -> TensorParallel:
    """The layers' view of ``sh`` for the rank at ``comm.index`` of the
    model axis. Raises ``NotImplementedError`` for what model > 1 does not
    serve yet."""
    tp = comm.size
    if tp == 1:
        return TensorParallel(comm)
    for spec in cfg.block_pattern:
        if spec.mixer not in (ATTN, SWA) or spec.mlp != DENSE:
            raise _entry_9c(f"a {spec.mixer}/{spec.mlp} layer")
    m = comm.index
    kv_heads = None
    if sh.tp_heads and not sh.tp_kv:
        # every KV head is cached; this rank's query heads
        # [m * hq, (m + 1) * hq) read heads [q0 // G, (q1 - 1) // G + 1)
        hq = cfg.n_heads // tp
        G = cfg.n_heads // cfg.n_kv_heads
        if hq % G and G % hq:
            raise _entry_9c(f"{cfg.n_heads} query heads over "
                            f"{cfg.n_kv_heads} KV heads split {tp} ways "
                            "(query groups straddle ranks)")
        kv_heads = slice(m * hq // G, (m * hq + hq - 1) // G + 1)
    elif sh.tp_kv and not sh.tp_heads:
        raise _entry_9c("KV heads split without the query heads")
    vocab = None
    if sh.tp_vocab:
        n = cfg.vocab_size // tp
        vocab = (m * n, (m + 1) * n)
    return TensorParallel(comm, heads=sh.tp_heads, ff=sh.tp_ff, vocab=vocab,
                          vocab_size=cfg.vocab_size, kv_heads=kv_heads)


def check_mesh(cfg: ArchConfig, mesh) -> None:
    """Raise what serving ``cfg`` over ``mesh`` (a shape is enough) would
    raise in the ranks, before any rank starts."""
    sh = ArchSharding(cfg, mesh)
    tensor_parallel(cfg, sh, AxisComm(size=tp_size(mesh)))


@dataclasses.dataclass
class ServeShard:
    """One rank's share of a sharded engine (``serve_shard``)."""
    mesh: Any
    sharding: ArchSharding
    cfg: ArchConfig            # the global config
    local_cfg: ArchConfig      # at this rank's widths
    tp: TensorParallel         # ModelOptions.tp
    data: AxisComm             # the slots' axis
    rows: slice                # this rank's slot rows (slotted backend)
    params: Any                # this rank's weights
    n_slots: int

    @property
    def slots_split(self) -> bool:
        return self.rows.stop - self.rows.start < self.n_slots

    def merge_slots(self, local, split: bool):
        """Every slot's values (dim 0) on every rank: with ``split`` each
        rank computed its ``rows``, written into zeros and summed over the
        data axis; else every data rank computed every slot, and data rank
        0's values are broadcast, so the ranks agree by construction."""
        if self.data.size == 1:
            return local
        if split:
            return self.data.place(local, self.n_slots, 0)
        return self.data.broadcast_(local.contiguous())


def serve_shard(cfg: ArchConfig, params, mesh, n_slots: int) -> ServeShard:
    """Resolve the partition rules for this rank of ``mesh`` and cut
    ``params`` (full, on this rank's device) into its pieces."""
    sh = ArchSharding(cfg, mesh)
    model = mesh.comm("model") if "model" in mesh.axis_names else AxisComm()
    tp = tensor_parallel(cfg, sh, model)
    data = mesh.comm("data") if "data" in mesh.axis_names else AxisComm()
    rows = slice(0, n_slots)
    if sh.serve_slot_axis(n_slots) is not None and data.size > 1:
        n = n_slots // data.size
        rows = slice(data.index * n, (data.index + 1) * n)
    specs = sh.serve_param_specs(params)
    if tp.kv_heads is not None:
        # every KV head computed on every rank: wk/wv (and biases) whole
        for layer in specs["layers"]:
            mixer = layer["mixer"]
            for k in ("wk", "wv", "bk", "bv"):
                if k in mixer:
                    mixer[k] = (None,) * len(mixer[k])
    local = shard(params, specs, mesh)
    return ServeShard(mesh, sh, cfg, local_config(cfg, sh), tp, data, rows,
                      local, n_slots)

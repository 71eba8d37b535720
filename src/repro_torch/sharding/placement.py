"""Where one rank's share of a sharded serving engine or training state
lives: its weights, its configuration at local widths, its slot rows or
batch rows, and the collectives of each axis (JAX ``serve/cache.py:
236-290`` and ``core/step.py:128-175, 261-278``, which let ``jit`` place
the same things by the partition rules).

``serve_shard(cfg, params, mesh, n_slots)`` resolves ``ArchSharding``'s
decisions for one serving rank:

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

``train_layout(cfg, mesh, state_like, global_batch)`` resolves them for
one training rank, and ``train_shard`` also cuts a full ``TrainState``:
the parameters and both AdamW moments by ``param_specs`` (FSDP over
"data" on the dimension the rule names, tensor parallelism over
"model"; a dimension the axis does not divide stays whole, where JAX's
sharding pads it), the batch by ``train_batch_specs``. Where the KV heads do not
split, ``wk``/``wv`` (and their biases) are whole over "model" here too,
and their gradients are summed over it (``model_summed``): every rank
uses only its own heads of them.

MoE (expert parallelism), Mamba and RWKV layers at model > 1 raise
``NotImplementedError`` naming ROADMAP entry 9c; data-only meshes serve
and train every config.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ATTN, DENSE, SWA, ArchConfig
from repro_torch.sharding.comm import AxisComm, TensorParallel
from repro_torch.sharding.rules import (P, ArchSharding, _piece, _zip_specs,
                                        shard, tp_size)


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
    specs = _whole_kv(sh.serve_param_specs(params), sh)
    local = shard(params, specs, mesh)
    return ServeShard(mesh, sh, cfg, local_config(cfg, sh), tp, data, rows,
                      local, n_slots)


_KV_LEAVES = ("wk", "wv", "bk", "bv")


def _every_kv_head(sh: ArchSharding) -> bool:
    """Every KV head computed on every rank: the query heads split over
    "model" and the KV heads do not (``TensorParallel.kv_heads``)."""
    return tp_size(sh.mesh) > 1 and sh.tp_heads and not sh.tp_kv


def _whole_kv(specs, sh: ArchSharding):
    """Where every KV head is computed on every rank, ``wk``/``wv`` and
    their biases whole over "model" (their other entries, FSDP's,
    kept)."""
    if _every_kv_head(sh):
        for layer in specs["layers"]:
            mixer = layer["mixer"]
            for k in _KV_LEAVES:
                if k in mixer:
                    mixer[k] = P(*(None if d == "model" else d
                                   for d in mixer[k]))
    return specs


@dataclasses.dataclass
class TrainShard:
    """One rank's share of a sharded training run (``train_layout``,
    ``train_shard``). ``specs`` is the state's spec tree (a
    ``TrainState`` of specs), ``batch_specs`` the batch's; ``model_summed``
    holds, in ``repro_torch.tree.leaves`` order of the parameters, whether
    a leaf's gradient is summed over "model" (whole ``wk``/``wv``)."""
    mesh: Any
    local_cfg: ArchConfig      # at this rank's widths
    tp: TensorParallel         # ModelOptions.tp
    data: AxisComm             # the batch's axis
    specs: Any
    batch_specs: Any
    model_summed: list
    state: Any = None          # this rank's pieces (``train_shard``)


def _fit(leaf, spec, mesh):
    """``spec`` less the axes of a dimension they do not divide: that
    dimension stays whole over them (JAX's sharding would pad it)."""
    return P(*(dim if leaf.shape[d] % _piece(mesh, mesh.coords, dim)[0] == 0
               else None for d, dim in enumerate(spec)))


def train_layout(cfg: ArchConfig, mesh, state_like, global_batch: int, *,
                 ep_resident: bool = False) -> TrainShard:
    """Resolve the partition rules for this rank of ``mesh`` over a
    ``TrainState`` (only its structure and shapes are read: ``meta``
    tensors will do). Raises ``NotImplementedError`` for what model > 1
    does not train yet."""
    from repro_torch import tree
    from repro_torch.core.step import TrainState
    from repro_torch.optim.adamw import AdamWState
    sh = ArchSharding(cfg, mesh, ep_resident=ep_resident)
    model = mesh.comm("model") if "model" in mesh.axis_names else AxisComm()
    tp = tensor_parallel(cfg, sh, model)
    pspecs = _zip_specs(lambda leaf, spec: _fit(leaf, spec, mesh),
                        state_like.params,
                        _whole_kv(sh.param_specs(state_like.params), sh))
    specs = TrainState(params=pspecs,
                       opt=AdamWState(count=P(), mu=pspecs, nu=pspecs),
                       step=P())
    summed = tree.tree_map(lambda _: False, state_like.params)
    if _every_kv_head(sh):
        for layer in summed["layers"]:
            for k in _KV_LEAVES:
                if k in layer["mixer"]:
                    layer["mixer"][k] = True
    data = mesh.comm("data") if "data" in mesh.axis_names else AxisComm()
    return TrainShard(mesh, local_config(cfg, sh), tp, data, specs,
                      sh.train_batch_specs(global_batch),
                      tree.leaves(summed))


def train_shard(cfg: ArchConfig, state, mesh, global_batch: int, *,
                ep_resident: bool = False) -> TrainShard:
    """``train_layout`` with this rank's pieces of the full ``state`` (on
    this rank's device; the full one may be freed after)."""
    out = train_layout(cfg, mesh, state, global_batch,
                       ep_resident=ep_resident)
    out.state = shard(state, out.specs, mesh)
    return out

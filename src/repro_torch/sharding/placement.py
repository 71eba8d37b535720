"""Where one rank's share of a sharded serving engine or training state
lives: its weights, its configuration at local widths, its slot rows or
batch rows, and the collectives of each axis (JAX ``serve/cache.py:
236-290`` and ``core/step.py:128-175, 261-278``, which let ``jit`` place
the same things by the partition rules).

``serve_shard(cfg, params, mesh, n_slots)`` resolves ``ArchSharding``'s
decisions for one serving rank:

  weights   cut by ``serve_param_specs``: column-parallel ``wq``/``wk``/
            ``wv``/``wi``/``wg`` (and biases), row-parallel ``wo``,
            vocab-parallel ``embed``/``lm_head``, MoE experts over "model"
            (``tp_experts``), Mamba's channels (``tp_di``), RWKV's heads
            (``tp_rwkv``), the rest replicated.
  config    the local head counts and ``d_ff`` (``local_config``), so
            every attention layer and kernel sees the local shapes: at
            model 2 the full-width tinyllama-1.1b runs HQ 16, HKV 2 a rank.
            The other widths (the rank's experts, its slice of Mamba's
            ``di``, its RWKV heads) are ``TensorParallel``'s: ``d_model``
            is the residual width, from which ``di`` and the RWKV head
            count derive, and jamba's dense and MoE layers share a
            ``d_ff`` they split differently, so no one shrunken config
            holds them.
  KV        the cache holds the local KV heads (``tp_kv``), or every head
            when HKV does not divide by the model axis: then the rank
            holds ``wk``/``wv`` whole (JAX's spec still column-shards
            them; the weights never change, so they are cut whole once
            here) and its queries read their heads' slice
            (``TensorParallel.kv_heads``). The Mamba and RWKV state rows
            hold the rank's channels and heads.
  slots     split over "data" when they divide (``serve_slot_axis``):
            this rank computes ``rows`` only, and the programs' tokens are
            merged over the data axis; otherwise replicated.

Where a width does not divide the model axis (JAX's decision flag is
False) its layer runs replicated on every rank: whole weights, no
collective. Departures from JAX's spec tree (``_port_specs``), each
because GSPMD only lays a tensor out where the port must compute on its
pieces:

  ``wk``/``wv``  whole where every KV head is computed (``_whole_kv``).
  ``in_proj``    Mamba's (D, 2·di) is cut as two halves (``rules.Halves``):
                 the rank's channels of ``xin`` and of ``z``. JAX's spec
                 shards the last dimension contiguously.
  ``w_bias``, ``ln_scale``  the RWKV time mix's per-channel decay bias and
                 group-norm scale are cut over "model" with the heads
                 (JAX's spec replicates them): they act on the rank's
                 channels only.
  channel mix    RWKV's ``wk`` is column-parallel over ``d_ff`` (when
                 ``tp_ff``), ``wv`` row-parallel over it and ``wr`` whole;
                 JAX's spec shards the output ``D`` of ``wv`` and ``wr``,
                 a layout no Megatron product has.

``train_layout(cfg, mesh, state_like, global_batch)`` resolves them for
one training rank, and ``train_shard`` also cuts a full ``TrainState``:
the parameters and both AdamW moments by ``param_specs`` (FSDP over
"data" on the dimension the rule names, tensor parallelism over
"model"; a dimension the axis does not divide stays whole, where JAX's
sharding pads it), the batch by ``train_batch_specs``. A whole piece
whose gradient each rank computes only in part is summed over "model"
(``model_summed``): ``wk``/``wv`` (and biases) where the KV heads do not
split, the MoE router (each rank's dispatch reaches its experts only),
and the RWKV time mix's token-shift mixes (they feed column-parallel
products). Under ``ep_resident`` the expert pieces are cut over every
axis (JAX's spec) and stay resident: never gathered over "data", their
tokens moved by ``TensorParallel.all_to_all`` (``resident``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import MOE, RWKV, ArchConfig
from repro_torch.sharding.comm import AxisComm, TensorParallel
from repro_torch.sharding.rules import (P, ArchSharding, Halves, _piece,
                                        _zip_specs, shard, tp_size)


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


def _has(cfg: ArchConfig, mixer: str = "", mlp: str = "") -> bool:
    return any(s.mixer == mixer or s.mlp == mlp for s in cfg.block_pattern)


def _range(full: int, comm: AxisComm):
    n = full // comm.size
    return (comm.index * n, (comm.index + 1) * n)


def tensor_parallel(cfg: ArchConfig, sh: ArchSharding, comm: AxisComm,
                    ep: AxisComm = None) -> TensorParallel:
    """The layers' view of ``sh`` for the rank at ``comm.index`` of the
    model axis (``ep``: the ranks the experts are cut over under
    ``ep_resident``). Raises ``NotImplementedError`` for the head layouts
    tensor parallelism cannot run."""
    tp = comm.size
    if tp == 1 and ep is None:
        return TensorParallel(comm)
    m = comm.index
    kv_heads = None
    if sh.tp_heads and not sh.tp_kv:
        # every KV head is cached; this rank's query heads
        # [m * hq, (m + 1) * hq) read heads [q0 // G, (q1 - 1) // G + 1)
        hq = cfg.n_heads // tp
        G = cfg.n_heads // cfg.n_kv_heads
        if hq % G and G % hq:
            raise NotImplementedError(
                f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads "
                f"split {tp} ways: query groups straddle ranks, so a rank "
                "would need a KV head its neighbour's queries read too")
        kv_heads = slice(m * hq // G, (m * hq + hq - 1) // G + 1)
    elif sh.tp_kv and not sh.tp_heads:
        raise NotImplementedError(
            "KV heads split without the query heads: a rank's queries would "
            "read KV heads another rank caches")
    vocab = None
    if sh.tp_vocab and tp > 1:
        vocab = _range(cfg.vocab_size, comm)
    experts = di = rwkv = None
    if tp > 1 and ep is None and sh.tp_experts and _has(cfg, mlp=MOE):
        experts = _range(cfg.moe.num_experts, comm)
    if tp > 1 and sh.tp_di:
        di = _range(cfg.mamba.expand * cfg.d_model, comm)
    if tp > 1 and sh.tp_rwkv and _has(cfg, mixer=RWKV):
        rwkv = _range(cfg.d_model // cfg.rwkv_head_dim, comm)
    return TensorParallel(comm, heads=sh.tp_heads, ff=sh.tp_ff, vocab=vocab,
                          vocab_size=cfg.vocab_size, kv_heads=kv_heads,
                          experts=experts, di=di, rwkv=rwkv, ep=ep)


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
    specs = _port_specs(sh.serve_param_specs(params), sh)
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


def _port_specs(specs, sh: ArchSharding):
    """JAX's spec tree with the port's departures (module docstring),
    in place: the whole KV projections, Mamba's ``in_proj`` in halves,
    the RWKV time mix's per-channel leaves with its heads, and the RWKV
    channel mix's Megatron layout."""
    _whole_kv(specs, sh)
    if tp_size(sh.mesh) == 1:
        return specs
    tp = "model"
    for layer in specs["layers"]:
        mixer, mlp = layer["mixer"], layer["mlp"]
        if "in_proj" in mixer and tp in mixer["in_proj"]:
            mixer["in_proj"] = Halves(mixer["in_proj"])
        if "w_bias" in mixer and sh.tp_rwkv:
            mixer["w_bias"] = mixer["ln_scale"] = P(tp)
        if "mix_k" in mlp:             # the RWKV channel mix
            f = mlp["wk"][0]           # the FSDP entry (None serving)
            mlp["wk"] = P(f, tp if sh.tp_ff else None)
            mlp["wv"] = P(tp if sh.tp_ff else None, f)
            mlp["wr"] = P(f, None)
    return specs


@dataclasses.dataclass
class TrainShard:
    """One rank's share of a sharded training run (``train_layout``,
    ``train_shard``). ``specs`` is the state's spec tree (a
    ``TrainState`` of specs), ``batch_specs`` the batch's; ``model_summed``
    holds, in ``repro_torch.tree.leaves`` order of the parameters, whether
    a leaf's gradient is summed over "model" (whole ``wk``/``wv``, the
    router, the RWKV mixes), and ``resident`` whether a leaf is an
    ``ep_resident`` expert piece (its gradient already holds every rank's
    tokens: scaled, not reduced over "data")."""
    mesh: Any
    local_cfg: ArchConfig      # at this rank's widths
    tp: TensorParallel         # ModelOptions.tp
    data: AxisComm             # the batch's axis
    specs: Any
    batch_specs: Any
    model_summed: list
    resident: list
    state: Any = None          # this rank's pieces (``train_shard``)


def _fit(leaf, spec, mesh):
    """``spec`` less the axes of a dimension they do not divide: that
    dimension stays whole over them (JAX's sharding would pad it). A
    ``Halves`` spec is fitted to each half."""
    shape = tuple(leaf.shape)
    if isinstance(spec, Halves):
        fitted = _fit_shape(shape[:-1] + (2, shape[-1] // 2), spec.halved(),
                            mesh)
        return Halves(fitted[:-2] + fitted[-1:])
    return _fit_shape(shape, spec, mesh)


def _fit_shape(shape, spec, mesh):
    return P(*(dim if shape[d] % _piece(mesh, mesh.coords, dim)[0] == 0
               else None for d, dim in enumerate(spec)))


def train_layout(cfg: ArchConfig, mesh, state_like, global_batch: int, *,
                 ep_resident: bool = False) -> TrainShard:
    """Resolve the partition rules for this rank of ``mesh`` over a
    ``TrainState`` (only its structure and shapes are read: ``meta``
    tensors will do). Raises ``NotImplementedError`` for the head layouts
    tensor parallelism cannot run, and ``ValueError`` under
    ``ep_resident`` when the experts do not divide over every rank."""
    from repro_torch import tree
    from repro_torch.core.step import TrainState
    from repro_torch.optim.adamw import AdamWState
    ep_resident = ep_resident and cfg.moe is not None and mesh.size > 1
    if ep_resident and cfg.moe.num_experts % mesh.size:
        raise ValueError(f"ep_resident cuts the {cfg.moe.num_experts} "
                         f"experts over all {mesh.size} ranks: they must "
                         "divide")
    sh = ArchSharding(cfg, mesh, ep_resident=ep_resident)
    model = mesh.comm("model") if "model" in mesh.axis_names else AxisComm()
    tp = tensor_parallel(cfg, sh, model,
                         ep=mesh.world if ep_resident else None)
    pspecs = _zip_specs(lambda leaf, spec: _fit(leaf, spec, mesh),
                        state_like.params,
                        _port_specs(sh.param_specs(state_like.params), sh))
    specs = TrainState(params=pspecs,
                       opt=AdamWState(count=P(), mu=pspecs, nu=pspecs),
                       step=P())
    summed = tree.tree_map(lambda _: False, state_like.params)
    resident = tree.tree_map(lambda _: False, state_like.params)
    for layer, flags, res in zip(state_like.params["layers"],
                                 summed["layers"], resident["layers"]):
        if _every_kv_head(sh):
            for k in _KV_LEAVES:
                if k in flags["mixer"]:
                    flags["mixer"][k] = True
        if "router" in layer["mlp"]:
            if tp.experts is not None:
                flags["mlp"]["router"] = True
            if ep_resident:
                for k in ("wi", "wg", "wo"):
                    res["mlp"][k] = True
        if tp.rwkv is not None and "w_bias" in layer["mixer"]:
            for k in flags["mixer"]:
                if k.startswith("mix_"):
                    flags["mixer"][k] = True
    data = mesh.comm("data") if "data" in mesh.axis_names else AxisComm()
    return TrainShard(mesh, local_config(cfg, sh), tp, data, specs,
                      sh.train_batch_specs(global_batch),
                      tree.leaves(summed), tree.leaves(resident))


def train_shard(cfg: ArchConfig, state, mesh, global_batch: int, *,
                ep_resident: bool = False) -> TrainShard:
    """``train_layout`` with this rank's pieces of the full ``state`` (on
    this rank's device; the full one may be freed after)."""
    out = train_layout(cfg, mesh, state, global_batch,
                       ep_resident=ep_resident)
    out.state = shard(state, out.specs, mesh)
    return out

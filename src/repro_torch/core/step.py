"""Step programs of the port (``src/repro/core/step.py``): the training
step (``TrainState``, ``make_train_step``, ``LinkedStep``,
``build_train_step``) and the serving programs (the prefill program, the
uniform, slotted and paged decode programs, the unified serve program of
chunked prefill and the speculative verify program, slotted and paged,
and the sampler with its per-slot threefry key chains,
``repro_torch.core.prng``), each built at a point of the linkage
spectrum.

PyTorch runs eagerly, so a "program" here is a Python callable: at L3 it
runs ``decode_steps`` microsteps (training: ``nss_steps`` optimizer
steps) back to back without a host sync and keeps their outputs on the
device; at L2+ it updates the cache (training: the parameters and
moments) in place; at L0/L1 it leaves the caller's cache or state intact
and returns a new one.

Under a serving mesh each rank runs the same programs on its shard: the
model layers issue their tensor-parallel collectives
(``ModelOptions.tp``), and the KV backends merge the slots and broadcast
the host-built operands. Under a training mesh each rank runs
``ShardedTrainStep`` on its pieces of the state (FSDP over "data",
Megatron over "model"). As in JAX (``step.py:358-359``) a mesh needs a
linked level: L0 with a mesh raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.core.linkage import L0_EAGER, L3_NSS, LinkageConfig
from repro_torch.models import init_params, loss_fn
from repro_torch.models import decode_step as model_decode
from repro_torch.models import decode_step_paged as model_decode_paged
from repro_torch.models import decode_step_slots as model_decode_slots
from repro_torch.models import prefill
from repro_torch.models import serve_chunk_step as model_chunk
from repro_torch.models import serve_chunk_step_paged as model_chunk_paged
from repro_torch.models import serve_verify_step as model_verify
from repro_torch.models import serve_verify_step_paged as model_verify_paged
from repro_torch.models.layers import ModelOptions
from repro_torch.models.transformer import _check_pageable, clone_cache
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# Training (step.py:33-126)
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor      # () int32


def init_train_state(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                     generator: torch.Generator, device="cuda",
                     param_dtype=torch.float32) -> TrainState:
    """Random parameters (``init_params``), zero moments, step 0, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = init_params(cfg, generator, device, param_dtype)
    return TrainState(params=params, opt=adamw.init(ocfg, params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(cfg: ArchConfig, opts: ModelOptions,
                    ocfg: adamw.AdamWConfig, *, inplace: bool = False
                    ) -> Callable:
    """The single-step function, the microstep of every linkage level:
    ``(state, batch) -> (state, metrics)``, metrics {"loss", "ce",
    "moe_aux", "grad_norm", "lr"} as 0-dim device tensors. The gradient is
    taken with respect to detached aliases of the parameters, so the state
    needs no ``requires_grad``; a parameter the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it. ``inplace`` updates the
    state's tensors (linkage L2+)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = tree.leaves(state.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree.unflatten(state.params, live),
                                    batch, cfg, opts)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = tree.unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)])
        new_params, new_opt, om = adamw.update(ocfg, grads, state.opt,
                                               state.params, inplace=inplace)
        step = state.step.add_(1) if inplace else state.step + 1
        metrics = {k: v.detach() for k, v in {**metrics, **om}.items()}
        return TrainState(new_params, new_opt, step), metrics

    return train_step


def _synchronize(metrics: Dict[str, torch.Tensor]) -> None:
    for v in metrics.values():
        if v.is_cuda:
            torch.cuda.current_stream(v.device).synchronize()
            return


@dataclasses.dataclass
class LinkedStep:
    """A training step linked at some point of the UKL spectrum."""
    fn: Callable                   # (state, batch) -> (state, metrics)
    linkage: LinkageConfig
    _pending: Any = None           # RET: the last metrics, not yet read

    def __call__(self, state, batch):
        state, metrics = self.fn(state, batch)
        if self.linkage.ret_async:
            # "ret": return without synchronizing; keep the metrics
            self._pending = metrics
            return state, None
        # "iret": full synchronization on every return
        _synchronize(metrics)
        return state, metrics

    def sync(self) -> Optional[Dict[str, Any]]:
        """RET mode: read the most recent metrics on the host, floats (L3's
        "loss_steps" a list); None when there are none."""
        if self._pending is None:
            return None
        out = {k: v.tolist() for k, v in self._pending.items()}
        self._pending = None
        return out


def build_train_step(cfg: ArchConfig, opts: ModelOptions,
                     ocfg: adamw.AdamWConfig,
                     linkage: LinkageConfig) -> LinkedStep:
    """The training step at ``linkage``'s level. L0 and L1 are functional
    (the caller's state survives; L0 takes no shortcut); L2 updates the
    state's tensors in place, the counterpart of donation; L3 runs one
    microstep per leading index of the batch (``nss_steps`` batches
    stacked, ``data.Pipeline.stacked_at``) with no host sync between them
    and returns the last microstep's metrics, on the device, with every
    microstep's loss stacked as "loss_steps" (K,) (JAX keeps that history
    on the device and returns the last step's alone)."""
    linkage.validate()
    micro = make_train_step(cfg, opts, ocfg, inplace=linkage.donate)
    return LinkedStep(fn=_linked(micro, linkage), linkage=linkage)


def _linked(micro: Callable, linkage: LinkageConfig) -> Callable:
    """``micro`` at ``linkage``'s level: itself, or at L3 one microstep a
    leading index of the batch with every microstep's loss stacked as
    "loss_steps"."""
    if linkage.level != L3_NSS:
        return micro

    def fused(state, batch_k):
        losses = []
        for i in range(batch_k["labels"].shape[0]):
            state, metrics = micro(state, {k: v[i] for k, v in
                                           batch_k.items()})
            losses.append(metrics["loss"])
        return state, dict(metrics, loss_steps=torch.stack(losses))
    return fused


#: the loss metrics of a sharded step, means over the data axis
_LOSS_KEYS = ("loss", "ce", "moe_aux")


class ShardedTrainStep:
    """One rank's training step over a (data, model) mesh
    (``build_sharded_train_step``): ``(state pieces, batch rows) ->
    (state pieces, metrics)``, at the linkage level's shape (L3: the
    batch's leading index runs the microsteps). Each microstep:

      1. gathers the FSDP dimension of every parameter over "data", all
         at once (a broadcast from each data rank of its pieces of a
         dtype, flattened): the rank then holds the model-local
         parameters whole, so its peak memory holds them, their
         gradients and the flat reduce buffer (each of the model-local
         size) beside the pieces, the moments and the activations;
      2. runs the forward and backward at the local widths (``ModelOptions
         .tp``: Megatron's collectives over "model", which autograd sees;
         the flash and rmsnorm ``Function``s at the local shapes);
      3. sums over "model" the gradients of the whole pieces each rank
         computes only in part (``wk``/``wv`` where the KV heads do not
         split, the MoE router, the RWKV token-shift mixes), then reduces
         every gradient as a mean over "data" (one all-reduce of the
         flattened gradients a dtype; this rank keeps its FSDP piece);
         an ``ep_resident`` expert piece is left out of that reduce: the
         all-to-all's backward already brought it every rank's tokens
         (each data row's once from every model rank), so it is divided
         by the mesh size instead;
      4. clips by the whole gradient's norm (``adamw.global_norm`` over
         the pieces) and runs AdamW on the pieces: in place at L2+,
         functional at L1.

    The loss metrics are the global batch's (the mean over "data": every
    data rank holds as many sequences, and as many MoE routing groups), so
    every rank returns the same metrics. ``grads`` is steps 1-3 alone,
    ``apply`` step 4."""

    def __init__(self, opts: ModelOptions, ocfg: adamw.AdamWConfig,
                 linkage: LinkageConfig, layout):
        from repro_torch.sharding.rules import spec_leaves
        self.layout, self.ocfg, self.linkage = layout, ocfg, linkage
        self.opts = dataclasses.replace(opts, tp=layout.tp)
        self.specs = spec_leaves(layout.specs.params)
        data = layout.data
        # each leaf's FSDP dimension (None: whole over "data")
        self.fsdp_dim = [next((d for d, dim in enumerate(spec)
                               if dim == "data"), None)
                         if data.size > 1 else None for spec in self.specs]
        self._fn = _linked(self._micro, linkage)

    def __call__(self, state, batch):
        return self._fn(state, batch)

    def _by_dtype(self, tensors, fsdp_only: bool):
        """{dtype: [leaf index, ...]} (of the FSDP-cut leaves alone when
        ``fsdp_only``; never the resident expert pieces)."""
        out: Dict[torch.dtype, list] = {}
        for i, t in enumerate(tensors):
            if self.layout.resident[i]:
                continue
            if not fsdp_only or self.fsdp_dim[i] is not None:
                out.setdefault(t.dtype, []).append(i)
        return out

    def _gather(self, pieces):
        data = self.layout.data
        full = list(pieces)
        for idx in self._by_dtype(pieces, True).values():
            flat = torch.cat([pieces[i].reshape(-1) for i in idx])
            every = data.all_gather(flat, 0).view(data.size, -1)
            off = 0
            for i in idx:
                p, n = pieces[i], pieces[i].numel()
                full[i] = torch.cat([every[r, off:off + n].view(p.shape)
                                     for r in range(data.size)],
                                    self.fsdp_dim[i])
                off += n
        return full

    def _reduce(self, grads):
        """The mean over "data" of each full gradient, this rank's FSDP
        piece of it (the whole of a leaf not cut over "data"). Frees
        ``grads``' entries as it goes."""
        data = self.layout.data
        n = data.size
        out = list(grads)
        for i, res in enumerate(self.layout.resident):
            if res:
                out[i] = grads[i] / self.layout.mesh.size
        if n == 1:
            return out
        for idx in self._by_dtype(grads, False).values():
            shapes = [grads[i].shape for i in idx]
            flat = data.sum_(torch.cat([grads[i].reshape(-1) for i in idx]))
            for i in idx:
                grads[i] = None
            off = 0
            for i, shape in zip(idx, shapes):
                g = flat[off:off + shape.numel()].view(shape)
                off += shape.numel()
                d = self.fsdp_dim[i]
                if d is not None:
                    k = shape[d] // n
                    g = g.narrow(d, data.index * k, k)
                out[i] = (g / n).contiguous()
        return out

    def grads(self, params, batch):
        """(this rank's pieces of the gradient of the global batch's mean
        loss, {"loss", "ce", "moe_aux"} of the global batch)."""
        lay = self.layout
        live = [f.detach().requires_grad_(True)
                for f in self._gather(tree.leaves(params))]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree.unflatten(params, live), batch,
                                    lay.local_cfg, self.opts)
            grads = list(torch.autograd.grad(loss, live, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, live)]
        del live, loss
        model = lay.tp.comm
        for g, summed in zip(grads, lay.model_summed):
            if summed:
                model.sum_(g)
        out = self._reduce(grads)
        m = torch.stack([metrics[k].detach().float().reshape(())
                         for k in _LOSS_KEYS])
        m = lay.data.sum_(m) / lay.data.size
        return (tree.unflatten(params, out),
                {k: m[i] for i, k in enumerate(_LOSS_KEYS)})

    def apply(self, state: TrainState, grads, metrics):
        """Step 4: AdamW on the pieces with ``grads``' pieces (from
        ``grads``): (new state, the step's metrics)."""
        lay = self.layout
        inplace = self.linkage.donate
        new_params, new_opt, om = adamw.update(
            self.ocfg, grads, state.opt, state.params, inplace=inplace,
            specs=lay.specs.params, mesh=lay.mesh)
        step = state.step.add_(1) if inplace else state.step + 1
        return TrainState(new_params, new_opt, step), {**metrics, **om}

    def _micro(self, state: TrainState, batch):
        return self.apply(state, *self.grads(state.params, batch))


def build_sharded_train_step(cfg: ArchConfig, opts: ModelOptions,
                             ocfg: adamw.AdamWConfig,
                             linkage: LinkageConfig, mesh, state_like,
                             global_batch: int, ep_resident: bool = False
                             ) -> Tuple[ShardedTrainStep, Any, Any]:
    """The training step over ``mesh`` (JAX ``step.py:128-175``): returns
    (fn, state_specs, batch_specs). ``fn`` is this rank's
    ``ShardedTrainStep``; ``state_specs`` the ``TrainState`` of specs its
    state is cut by (``sharding.placement.train_shard`` cuts it), and
    ``batch_specs`` the batch's (``data.stage(..., specs, mesh)`` stages
    this rank's rows; at L3 with a leading microstep dimension).
    ``state_like`` may hold ``meta`` tensors: only its structure and
    shapes are read, as JAX reads ``ShapeDtypeStruct``s. L0 raises
    ``ValueError``, as ``check_mesh_linkage`` does for serving. Every
    layer family trains at a model axis > 1: MoE experts split over
    "model" (or, with ``ep_resident``, over every rank, resident, their
    tokens moved by an all-to-all), Mamba's inner width and RWKV's heads
    split; the scans train on their plain versions. Wrap ``fn`` in
    ``LinkedStep`` for the linkage's return mode."""
    from repro_torch.sharding.placement import train_layout
    linkage.validate()
    check_mesh_linkage(linkage, True)
    layout = train_layout(cfg, mesh, state_like, global_batch,
                          ep_resident=ep_resident)
    bspecs = layout.batch_specs
    if linkage.level == L3_NSS:
        bspecs = {k: (None,) + tuple(v) for k, v in bspecs.items()}
    return (ShardedTrainStep(opts, ocfg, linkage, layout),
            layout.specs, bspecs)


def check_mesh_linkage(linkage: LinkageConfig, sharded: bool) -> None:
    """Serving or training over a mesh (``sharded``: a rank's program has
    ``opts.tp`` set, an engine or a launcher has a mesh) needs a linked
    level, as in JAX, whose eager L0 cannot carry shardings."""
    if sharded and linkage.level == L0_EAGER:
        raise ValueError("a mesh needs a jitted linkage level (L1-L3)")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Token-sampling policy (``step.py:178``). ``temperature == 0`` is
    greedy argmax (the default, and the mode the token-identity tests pin
    down). Otherwise logits are divided by ``temperature``, optionally
    truncated to the ``top_k`` highest, and sampled with a per-slot
    threefry key threaded through the serving programs: each slot's chain
    is seeded from (seed, request id) at admission, so a request's sampled
    stream depends only on the request and the seed, never on the slot it
    landed in or when it was admitted."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def request_key(self, rid: int, device="cpu") -> torch.Tensor:
        """``fold_in(PRNGKey(seed), rid)``: the (2,) key a request's chain
        starts from, made on ``device``."""
        return prng.fold_in(prng.PRNGKey(self.seed, device), rid)


def make_sampler(sampling: Optional[SamplingConfig]) -> Callable:
    """(logits (B,V), keys (B,2)) -> (tokens (B,) int32, new keys)
    (``step.py:199-215``). Greedy: argmax (ties to the first index, as
    ``jnp.argmax``), the keys returned as they came. Sampled: every row's
    key splits in two; the first half is the row's next key, the second
    draws the token by the Gumbel-max trick over ``logits / temperature``
    in float32, masked to the values at or above the ``top_k``-th
    largest."""
    if sampling is None or sampling.temperature <= 0.0:
        def greedy(logits, keys):
            return torch.argmax(logits, dim=-1).to(torch.int32), keys
        return greedy

    def sample(logits, keys):
        splits = prng.split(keys)                          # (B, 2, 2)
        new_keys, subs = splits[:, 0], splits[:, 1]
        lg = logits.float() / sampling.temperature
        if sampling.top_k > 0:
            kth = torch.topk(lg, sampling.top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg >= kth, lg, float("-inf"))
        return prng.categorical(subs, lg).to(torch.int32), new_keys
    return sample


def _gate(mask: torch.Tensor, new, old):
    """Rows of ``new`` where ``mask`` (B,), else of ``old``: the key
    chains of the rows a program emitted for (a greedy sampler returns its
    keys unchanged, and nothing needs choosing)."""
    if new is old:
        return old
    return torch.where(mask[:, None], new, old)


def program_label(cfg: ArchConfig, linkage: LinkageConfig,
                  kind: str) -> str:
    """A stable human-readable label for a serving program — ``kind`` is the
    program family the engine dispatched ("decode", "serve_chunk",
    "verify", "prefill_admit").
    Telemetry stamps it on ``engine_step`` trace events."""
    tag = linkage.level
    if linkage.level == L3_NSS:
        tag += f"x{linkage.decode_steps}"
    if linkage.ret_async:
        tag += "+ret"
    if linkage.shortcut:
        tag += "+shortcut"
    return f"{kind}/{tag}/d{cfg.d_model}L{cfg.num_blocks}"


def _serving_decode_fn(one: Callable, linkage: LinkageConfig) -> Callable:
    """Lift a one-token microstep ``(params, cache, tokens, keys) -> (cache,
    nxt, keys)`` over the linkage spectrum: at L3 ``decode_steps`` tokens
    per program (one host transition per K tokens), else one. Returns
    ``(params, cache, tokens (B,), keys (B,2)) -> (cache, tokens (B, K),
    keys)``."""
    if linkage.level == L3_NSS:
        def many(params, cache, tokens, keys):
            seq = []
            for _ in range(linkage.decode_steps):
                cache, tokens, keys = one(params, cache, tokens, keys)
                seq.append(tokens)
            return cache, torch.stack(seq, dim=1), keys   # (B, K)
        return many

    def single(params, cache, tokens, keys):
        cache, nxt, keys = one(params, cache, tokens, keys)
        return cache, nxt[:, None], keys
    return single


def make_decode_fn(cfg: ArchConfig, opts: ModelOptions,
                   linkage: LinkageConfig) -> Callable:
    """Uniform-layout greedy decode (every row at one position):
    ``decode_steps`` tokens per program at L3, else one. ``(params, cache,
    tokens (B,)) -> (cache, tokens (B, K))``, as JAX's."""
    sample = make_sampler(None)

    def one(params, cache, tokens, keys):
        logits, cache = model_decode(params, cache, tokens, cfg, opts,
                                     inplace=linkage.donate)
        return (cache,) + sample(logits, keys)
    fn = _serving_decode_fn(one, linkage)

    def decode(params, cache, tokens):
        return fn(params, cache, tokens, None)[:2]
    return decode


def build_decode_step(cfg: ArchConfig, opts: ModelOptions,
                      linkage: LinkageConfig) -> Callable:
    linkage.validate()
    return make_decode_fn(cfg, opts, linkage)


def make_slot_decode_fn(cfg: ArchConfig, opts: ModelOptions,
                        linkage: LinkageConfig,
                        sampling: Optional[SamplingConfig] = None
                        ) -> Callable:
    """Slot-layout decode for the serving engine: every batch row is an
    independent in-flight sequence at its own position, with its own
    sampling-key chain."""
    sample = make_sampler(sampling)

    def one(params, cache, tokens, keys):
        logits, cache = model_decode_slots(params, cache, tokens, cfg, opts,
                                           inplace=linkage.donate)
        return (cache,) + sample(logits, keys)
    return _serving_decode_fn(one, linkage)


def build_slot_decode_step(cfg: ArchConfig, opts: ModelOptions,
                           linkage: LinkageConfig,
                           sampling: Optional[SamplingConfig] = None
                           ) -> Callable:
    """(params, slot_cache, tokens (B,), keys (B,2)) -> (slot_cache,
    tokens (B, K), keys)."""
    linkage.validate()
    check_mesh_linkage(linkage, opts.tp is not None)
    return make_slot_decode_fn(cfg, opts, linkage, sampling)


def make_paged_decode_fn(cfg: ArchConfig, opts: ModelOptions,
                         linkage: LinkageConfig, max_len: int,
                         sampling: Optional[SamplingConfig] = None
                         ) -> Callable:
    """Paged-KV decode (``step.py:369``): the cache is one block pool per
    layer, and each slot's view goes through its block table, passed per
    call — the engine allocates and forks blocks between programs, so the
    table is host state, not program state. Returns ``(params, cache,
    tokens (B,), keys (B,2), tables (B, nb)) -> (cache, tokens (B, K),
    keys)``."""
    sample = make_sampler(sampling)

    def fn(params, cache, tokens, keys, tables):
        def one(params, cache, tokens, keys):
            logits, cache = model_decode_paged(params, cache, tokens, tables,
                                               cfg, opts, max_len,
                                               inplace=linkage.donate)
            return (cache,) + sample(logits, keys)
        return _serving_decode_fn(one, linkage)(params, cache, tokens, keys)
    return fn


def build_paged_decode_step(cfg: ArchConfig, opts: ModelOptions,
                            linkage: LinkageConfig, max_len: int,
                            sampling: Optional[SamplingConfig] = None
                            ) -> Callable:
    """(params, paged_cache, tokens (B,), keys (B,2), tables (B, nb)) ->
    (paged_cache, tokens (B, K), keys)."""
    linkage.validate()
    check_mesh_linkage(linkage, opts.tp is not None)
    return make_paged_decode_fn(cfg, opts, linkage, max_len, sampling)


def _kv_kind(kv_kind: str) -> bool:
    if kv_kind not in ("slotted", "paged"):
        raise ValueError(f"unknown kv_kind {kv_kind!r}")
    return kv_kind == "paged"


def build_serve_step(cfg: ArchConfig, opts: ModelOptions,
                     linkage: LinkageConfig, max_len: int,
                     sampling: Optional[SamplingConfig] = None, *,
                     kv_kind: str = "slotted") -> Callable:
    """The *unified* serve program of chunked prefill (``step.py:555``):
    one program per engine step, [chunk pass] + [K decode microsteps].

      1. Chunk pass: each slot absorbs its own variable-length prompt chunk
         (decode and empty slots carry a zero-length chunk); K/V written,
         then attended with per-row positions. Rows whose chunk completes
         their prompt sample their first token from the chunk's last
         position (``emit0`` gates their key chains; the caller reads
         ``t0`` only there).
      2. Decode scan: the linkage level's K microsteps — the two-phase
         decode body — advance the rows past prefill (``dec_mask`` gates
         their key chains). The other rows keep their state: on the paged
         pools they ride the scan against ``scan_tables``, where their
         whole row is the trash block, so their garbage never lands in a
         live block, and they keep their position, which the engine's
         pure-decode path trusts between programs; on slot rows every
         leaf of theirs is put back bit-exact after each microstep, since
         a garbage write would wrap the circular row (``pos % T``) over
         resident prompt K/V whenever pos + K > T.

    Signature (slotted): (params, cache, chunk_tokens (B,W) i32, clen (B,)
    i32, start (B,) i32, reset (B,) bool, emit0 (B,) bool, dec_tok (B,)
    i32, dec_mask (B,) bool, keys (B,2)) -> (cache, t0 (B,) i32, seq
    (B,K) i32, keys). Paged adds trailing ``tables (B,nb)`` (chunk pass)
    and ``scan_tables`` (decode scan); ``reset`` is the slotted pass's
    only (rows admitted this step drop their stale ``slot_pos`` marks).
    """
    linkage.validate()
    check_mesh_linkage(linkage, opts.tp is not None)
    sample = make_sampler(sampling)
    K = linkage.decode_steps if linkage.level == L3_NSS else 1
    paged = _kv_kind(kv_kind)
    _check_pageable(cfg, "serve_chunk_step_paged" if paged
                    else "serve_chunk_step")

    def fn(params, cache, chunk_toks, clen, start, reset, emit0, dec_tok,
           dec_mask, keys, *tabs):
        if paged:
            tables, scan_tables = tabs
            logits, cache = model_chunk_paged(
                params, cache, chunk_toks, tables, start, clen, cfg, opts,
                max_len, inplace=linkage.donate)
        else:
            logits, cache = model_chunk(params, cache, chunk_toks, start,
                                        clen, reset, cfg, opts,
                                        inplace=linkage.donate)
        t0, keys_c = sample(logits, keys)
        keys = _gate(emit0, keys_c, keys)
        toks, seq = dec_tok, []
        for _ in range(K):
            if paged:
                held = [g["pos"].clone() for g in cache]
                logits, cache = model_decode_paged(params, cache, toks,
                                                   scan_tables, cfg, opts,
                                                   max_len)
                for g, pos in zip(cache, held):
                    g["pos"].copy_(torch.where(dec_mask, g["pos"], pos))
            else:
                held = clone_cache(cache)
                logits, cache = model_decode_slots(params, cache, toks, cfg,
                                                   opts)
                for g, old in zip(cache, held):
                    for name, leaf in g.items():
                        m = dec_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
                        leaf.copy_(torch.where(m, leaf, old[name]))
            toks, ks = sample(logits, keys)
            keys = _gate(dec_mask, ks, keys)
            seq.append(toks)
        return cache, t0, torch.stack(seq, dim=1), keys
    return fn


def build_verify_step(cfg: ArchConfig, opts: ModelOptions,
                      linkage: LinkageConfig, max_len: int,
                      sampling: Optional[SamplingConfig] = None, *,
                      kv_kind: str = "slotted") -> Callable:
    """The speculative *verify* program: one draft-widened decode step
    (``step.py:667-757``).

    Each decode row feeds ``toks[s] = [next_token, d_1 .. d_m]`` (clen =
    m + 1) through the chunk pass at its own position and gets logits at
    every fed position. The accept loop then resolves the longest accepted
    prefix per row, on the device: position j's logits condition on the
    fed prefix, so the token ``t_j`` sampled there is exactly what plain
    decode would produce; a row emits ``t_j`` while it is still accepting,
    and keeps accepting past j iff ``t_j`` equals the draft it fed at
    j + 1. ``n_emit`` = 1 + accepted drafts; ``out[s, n_emit - 1]`` is the
    row's new committed next token. Keys advance once per *emitted* token,
    so sampled verify is key-chain-exact.

    The cache is repaired in the program: per-row ``pos`` returns to
    ``start + n_emit`` (both backends), and slotted ``slot_pos`` marks at
    or beyond it are invalidated (every live entry sits below ``start``,
    so only this program's rejected writes match). Paged block residency
    is host state: its truncation is the backend's ``rollback``.

    Signature (slotted): (params, cache, toks (B,W) i32, clen (B,) i32,
    start (B,) i32, vmask (B,) bool, keys (B,2)) -> (cache, out (B,W) i32,
    n_emit (B,) i32, keys); paged adds trailing ``tables (B,nb)``. Rows
    with vmask False carry clen 0, write nothing and emit nothing.
    """
    linkage.validate()
    check_mesh_linkage(linkage, opts.tp is not None)
    sample = make_sampler(sampling)
    paged = _kv_kind(kv_kind)
    _check_pageable(cfg, "serve_verify_step_paged" if paged
                    else "serve_verify_step")

    def fn(params, cache, toks, clen, start, vmask, keys, *tabs):
        if paged:
            (tables,) = tabs
            logits, cache = model_verify_paged(
                params, cache, toks, tables, start, clen, cfg, opts, max_len,
                inplace=linkage.donate)
        else:
            logits, cache = model_verify(params, cache, toks, start, clen,
                                         cfg, opts, inplace=linkage.donate)
        fed_next = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])],
                             dim=1)
        accepting = torch.ones_like(vmask)
        n_emit = torch.zeros_like(clen)
        out = []
        for j in range(toks.shape[1]):
            t, ks = sample(logits[:, j], keys)
            emit = vmask & accepting & (clen > j)
            keys = _gate(emit, ks, keys)
            n_emit = n_emit + emit.to(n_emit.dtype)
            accepting = emit & (clen > j + 1) & (t == fed_next[:, j])
            out.append(t)
        new_pos = start + n_emit
        for g in cache:
            if not paged:
                sp = g["slot_pos"]
                sp.masked_fill_(vmask[:, None] & (sp >= new_pos[:, None]),
                                -1)
            g["pos"].copy_(torch.where(vmask, new_pos, g["pos"]))
        return cache, torch.stack(out, dim=1), n_emit, keys
    return fn


def build_prefill_fn(cfg: ArchConfig, opts: ModelOptions, max_len: int, *,
                     bucket_fn: Optional[Callable[[int], int]] = None
                     ) -> Callable:
    """Full-prompt admission prefill. Returns ``prefill_prompt(params,
    prompt (P,) np.int32) -> (logits (1,V), cache)``, on the parameters'
    device.

    With ``bucket_fn`` the prompt is right-padded to its bucket and
    prefilled with ``true_len`` (in JAX: one compile per bucket, not per
    length; here the same shapes and the same fix-up). Prompts must be
    non-empty: ``true_len == 0`` would read logits from pure padding.
    """
    def prefill_prompt(params, prompt):
        P_ = int(prompt.shape[0])
        if P_ < 1:
            raise ValueError("cannot prefill an empty prompt")
        device = params["embed"].device
        if bucket_fn is None:
            toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
            return prefill(params, toks.to(device), cfg, opts,
                           max_len=max_len)
        bucket = bucket_fn(P_)
        if bucket < P_:
            raise ValueError(
                f"bucket_fn({P_}) = {bucket} is smaller than the prompt "
                "— buckets must cover the prompt length")
        padded = np.zeros((bucket,), np.int32)
        padded[:P_] = prompt
        return prefill(params, torch.from_numpy(padded)[None].to(device),
                       cfg, opts, max_len=max_len, true_len=P_)
    return prefill_prompt

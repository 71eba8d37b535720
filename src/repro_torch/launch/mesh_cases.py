"""Serving cases run alike over a mesh (in every rank) and on one device,
so a caller can hold the sharded engine against the unsharded one.

``run_cases(mesh, cases)`` is ``spawn``'s entry (``mesh`` a live
``Mesh``) and runs in one process too (``mesh=None``). The model is a
registered config (``smoke`` cut; a case's "overrides" replace fields)
with the port's seeded init, built once per (arch, dtype) in each
process, so every rank and the caller hold the same weights; a case's
"weights" (a full parameter tree on the host, say JAX's converted by
``convert.params_from_jax``) replace the init. A case is a dict:

  {"name", "kind": "serve", "preset", "requests", "engine": {...}}
        a ``ServeEngine`` run (closed load, or "load": "open"); returns
        the token streams and the counters a check reads.
  {"name", "kind": "warm", ...serve's keys, "path"}
        a run that saves its prefix cache at ``path``, then a second engine
        warm-started from it; returns both runs.
  {"name", "kind": "teacher", "preset", "prompt", "feed", "backend"}
        prefill, then one decode step per token of ``feed`` (slotted, or
        paged through a permuted block table, whose last entry is also a
        paged chunk pass over the prompt's tail), the given tokens fed:
        returns every step's logits (float32 numpy). The optional
        "routes": "record" also returns the MoE layers' routing (each
        ``layers._route`` output, in call order) under "routes"; such a
        record in its place has the run route exactly so (the mesh's
        ranks route over the whole router, as one device does). Paged
        only, the
        optional "kv_writes": "record" also returns the run's K/V writes
        (the prefill's rows the pools start from, then each layer's write
        in call order) under "kv_writes"; such a record in its place has
        the run write exactly those values, this rank's KV heads of them,
        so a quantized pool holds the recording run's codes and scales and
        only the arithmetic differs (a code moves a whole step on an ulp).
  {"name", "kind": "raises", "preset", "engine": {...}}
        building the engine; returns the exception's type and message.
  {"name", "kind": "fleet", "preset", "requests", "engine": {...}}
        a ``FleetEngine`` run (its keyword arguments in "engine": replicas,
        prefill_replicas, n_slots, max_len, kv, ...) over the mesh;
        returns the streams, the handoffs and the utilization.

Each result also holds the rank's kernel launches over the case
(``ops.launch_counts``) and its KV bytes per shard; a serve case also the
bytes of its recurrent state leaves and of its expert weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_MODELS: Dict[tuple, Any] = {}


def model(arch: str, *, smoke: bool = True, dtype=torch.float32,
          device="cpu", overrides=()):
    """(cfg, params) of a registered config, seeded init (seed 0), cached
    per process; ``overrides`` ((field, value) pairs) replace config
    fields (say, one KV head) before the init."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    key = (arch, smoke, dtype, str(device), tuple(overrides))
    if key not in _MODELS:
        cfg = get_config(arch)
        cfg = cfg.smoke() if smoke else cfg
        cfg = dataclasses.replace(cfg, **dict(overrides))
        gen = torch.Generator(device=device).manual_seed(0)
        _MODELS[key] = (cfg, init_params(cfg, gen, device, dtype))
    return _MODELS[key]


def options(preset_name: str, dtype=torch.float32, decode_steps: int = 0):
    """(linkage, ModelOptions) of a preset over plain attention in
    ``dtype`` (the shortcut presets take the kernel wrappers)."""
    from repro_torch.core import L3_NSS, preset
    from repro_torch.models import ModelOptions
    lk = preset(preset_name)
    if decode_steps and lk.level == L3_NSS:
        lk = dataclasses.replace(lk, decode_steps=decode_steps)
    return lk, lk.model_options(ModelOptions(attn_impl="ref", dtype=dtype))


def _kv_leaf_bytes(eng) -> Optional[int]:
    """Bytes of the first attention layer's K (or K pool) leaf on this
    rank (None without one)."""
    for g in eng.kv.cache:
        for name in ("kp", "k"):
            if name in g:
                return g[name].numel() * g[name].element_size()
    return None


_STATE_LEAVES = ("conv", "ssm", "state")


def _state_bytes(eng) -> dict:
    """Bytes of the Mamba and RWKV state leaves on this rank, by name."""
    out = {}
    for g in eng.kv.cache:
        for name in _STATE_LEAVES:
            if name in g:
                out[name] = out.get(name, 0) + g[name].numel() * g[
                    name].element_size()
    return out


def _expert_bytes(params) -> int:
    """Bytes of the MoE expert weights this rank holds."""
    return sum(layer["mlp"][k].numel() * layer["mlp"][k].element_size()
               for layer in params["layers"] if "router" in layer["mlp"]
               for k in ("wi", "wg", "wo"))


def _serve(cfg, params, case, mesh, **extra) -> dict:
    from repro_torch.core import SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    lk, opts = options(case["preset"], params["embed"].dtype,
                       case.get("decode_steps", 0))
    kw = dict(case.get("engine", {}), **extra)
    if "sampling" in kw:
        kw["sampling"] = SamplingConfig(**kw["sampling"])
    ops.reset_launch_counts()
    eng = ServeEngine(cfg, params, opts, lk, mesh=mesh, **kw)
    comps, _ = eng.run(case["requests"], load=case.get("load", "closed"))
    u = eng.utilization()
    return {"streams": {c.rid: c.tokens.tolist() for c in comps},
            "util": u, "preemptions": eng.preemptions,
            "swap_preemptions": eng.swap_preemptions,
            "swap_resumes": eng.swap_resumes,
            "pool_hwm": getattr(getattr(eng.kv, "pool", None), "hwm", None),
            "kv_leaf_bytes": _kv_leaf_bytes(eng),
            "kv_bytes_per_shard": u["kv_bytes_per_shard"],
            "state_bytes": _state_bytes(eng),
            "expert_bytes": _expert_bytes(eng.params),
            "launches": ops.launch_counts(), "_engine": eng}


def _fleet(cfg, params, case, mesh) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.serve import FleetEngine
    lk, opts = options(case["preset"], params["embed"].dtype,
                       case.get("decode_steps", 0))
    ops.reset_launch_counts()
    fleet = FleetEngine(cfg, params, opts, lk, mesh=mesh, **case["engine"])
    comps, _ = fleet.run(case["requests"], load=case.get("load", "closed"))
    return {"streams": {c.rid: c.tokens.tolist() for c in comps},
            "handoffs": fleet.handoffs, "util": fleet.utilization(),
            "launches": ops.launch_counts()}


@contextlib.contextmanager
def routing(log: list, replay: bool):
    """The MoE layers' routing steps (``layers._route``), in call order:
    recorded into ``log`` (host tensors), or (``replay``) replaced by its
    entries, so a second run routes exactly as the first one did."""
    from repro_torch.models import layers
    orig, recorded = layers._route, iter(log)

    def route(router, xt, K, opts):
        if replay:
            return tuple(t.to(xt.device) for t in next(recorded))
        out = orig(router, xt, K, opts)
        log.append(tuple(t.cpu() for t in out))
        return out

    layers._route = route
    try:
        yield
    finally:
        layers._route = orig


@contextlib.contextmanager
def paged_writes(log: list, replay: bool, heads: slice = slice(None)):
    """The paged attention layers' K/V writes, in call order: recorded into
    ``log``, or (``replay``) replaced by its entries' ``heads`` (the head
    axis is second to last), so a second run writes what the first one
    wrote."""
    from repro_torch.models import layers
    orig, recorded = layers._paged_write, iter(log)

    def write(cache, blk, off, k, v):
        if replay:
            rk, rv = next(recorded)
            k = torch.as_tensor(rk)[..., heads, :].to(k.device, k.dtype)
            v = torch.as_tensor(rv)[..., heads, :].to(v.device, v.dtype)
        else:
            log.append((k, v))
        return orig(cache, blk, off, k, v)

    layers._paged_write = write
    try:
        yield
    finally:
        layers._paged_write = orig


def _host(tensors) -> tuple:
    return tuple(t.float().cpu().numpy() for t in tensors)


def _teacher(cfg, params, case, mesh) -> dict:
    """Teacher-forced logits (see the module docstring)."""
    _, opts = options(case["preset"], params["embed"].dtype)
    dev = params["embed"].device
    heads = slice(None)                   # this rank's KV heads
    if mesh is not None:
        from repro_torch.sharding.placement import serve_shard
        sh = serve_shard(cfg, params, mesh, 1)
        hkv = sh.local_cfg.n_kv_heads
        if hkv < cfg.n_kv_heads:
            heads = slice(sh.tp.comm.index * hkv,
                          (sh.tp.comm.index + 1) * hkv)
        cfg, params = sh.local_cfg, sh.params
        opts = dataclasses.replace(opts, tp=sh.tp)
    prompt = torch.as_tensor(np.asarray(case["prompt"], np.int32))[None]
    prompt = prompt.to(dev)
    feed = [torch.tensor([t], dtype=torch.int32, device=dev)
            for t in case["feed"]]
    routes = case.get("routes")
    log = routes if isinstance(routes, list) else []
    with (routing(log, replay=routes != "record") if routes is not None
          else contextlib.nullcontext()):
        out = _teacher_run(cfg, params, case, opts, prompt, feed, heads)
    if routes == "record":
        out["routes"] = log
    return out


def _teacher_run(cfg, params, case, opts, prompt, feed, heads) -> dict:
    from repro_torch.models import (decode_step_paged, decode_step_slots,
                                    prefill, serve_chunk_step_paged)
    from repro_torch.serve import slotify
    from repro_torch.serve.paging import init_paged_cache, scatter_kv
    dev = prompt.device
    P, max_len = prompt.shape[1], case["max_len"]
    logits, cache = prefill(params, prompt, cfg, opts, max_len)
    out = [logits]
    if case["backend"] == "slotted":
        cache = slotify(cache)
        for t in feed:
            logits, cache = decode_step_slots(params, cache, t, cfg, opts)
            out.append(logits)
    else:
        bs = case.get("block_size", 8)
        nb = -(-max_len // bs)
        gen = torch.Generator().manual_seed(1)
        table = torch.randperm(3 * nb, generator=gen)[:nb].to(
            torch.int32)[None].to(dev)
        kv_dtype = case.get("kv_dtype", "bf16")
        record = case.get("kv_writes")
        rows = [(g["k"][:, :P], g["v"][:, :P]) for g in cache]
        writes, replay = [], isinstance(record, dict)
        if replay:                        # the recording run's rows
            rows = [tuple(torch.as_tensor(t)[..., heads, :].to(dev, k.dtype)
                          for t in rec)
                    for rec, (k, _) in zip(record["prefill"], rows)]
            writes = record["writes"]

        def pool(n):
            pc = init_paged_cache(cfg, 3 * nb, bs, 1, opts.dtype, dev,
                                  kv_dtype=kv_dtype)
            p = torch.arange(n, device=dev)
            scatter_kv(pc, [{"k": k[:, :n], "v": v[:, :n]} for k, v in rows],
                       table[0, p // bs].long(), p % bs, 0, n)
            return pc
        with (paged_writes(writes, replay, heads) if record
              else contextlib.nullcontext()):
            pc = pool(P)
            for t in feed:
                logits, pc = decode_step_paged(params, pc, t, table, cfg,
                                               opts, max_len)
                out.append(logits)
            # the chunk pass: positions [0, half) resident, the rest one
            # chunk
            half = P // 2
            start = torch.tensor([half], dtype=torch.int32, device=dev)
            clen = torch.tensor([P - half], dtype=torch.int32, device=dev)
            logits, _ = serve_chunk_step_paged(params, pool(half),
                                               prompt[:, half:], table,
                                               start, clen, cfg, opts,
                                               max_len)
        out.append(logits)
        if record == "record":
            return {"logits": torch.cat(out).float().cpu().numpy(),
                    "kv_writes": {"prefill": [_host(kv) for kv in rows],
                                  "writes": [_host(kv) for kv in writes]}}
    return {"logits": torch.cat(out).float().cpu().numpy()}


def run_case(case: dict, mesh=None, *, smoke: bool = True,
             dtype=torch.float32, device="cpu") -> dict:
    """One case (see the module docstring) on this rank of ``mesh`` (None:
    one device)."""
    from repro_torch.kernels import ops
    dev = mesh.device if mesh is not None else torch.device(device)
    if "weights" in case:
        from repro_torch import tree
        from repro_torch.configs import get_config
        cfg = get_config(case.get("arch", "tinyllama-1.1b"))
        cfg = dataclasses.replace(cfg.smoke() if smoke else cfg,
                                  **dict(case.get("overrides", ())))
        params = tree.tree_map(lambda t: torch.as_tensor(t).to(dev),
                               case["weights"])
    else:
        cfg, params = model(case.get("arch", "tinyllama-1.1b"), smoke=smoke,
                            dtype=dtype, device=dev,
                            overrides=case.get("overrides", ()))
    kind = case["kind"]
    if kind == "fleet":
        out = _fleet(cfg, params, case, mesh)
    elif kind == "serve":
        out = _serve(cfg, params, case, mesh)
    elif kind == "warm":
        first = _serve(cfg, params, case, mesh)
        saved = first["_engine"].save_prefix_cache(case["path"])
        out = {"first": first, "saved": saved,
               "second": _serve(cfg, params, case, mesh,
                                warm_start=case["path"])}
    elif kind == "teacher":
        ops.reset_launch_counts()
        out = dict(_teacher(cfg, params, case, mesh),
                   launches=ops.launch_counts())
    elif kind == "raises":
        try:
            _serve(cfg, params, dict(case, requests=[]), mesh)
            out = {"error": None}
        except (ValueError, NotImplementedError) as e:
            out = {"error": type(e).__name__, "message": str(e)}
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    return _strip(out)


def _strip(out):
    """The result without live engines (they do not leave the rank)."""
    if isinstance(out, dict):
        return {k: _strip(v) for k, v in out.items() if k != "_engine"}
    return out


def run_cases(mesh, cases: List[dict], *, smoke: bool = True,
              dtype=torch.float32, device="cpu") -> dict:
    """Every case in order on this rank (``spawn``'s entry, or one device
    with ``mesh=None``): {name: result}."""
    return {c["name"]: run_case(c, mesh, smoke=smoke, dtype=dtype,
                                device=device) for c in cases}

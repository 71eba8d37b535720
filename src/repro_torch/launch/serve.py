"""Serving launcher of the port — the paper's Redis evaluation for the
decode boundary (``src/repro/launch/serve.py``), on the GPU.

Two paths share one model/linkage setup:

  engine (default)  continuous-batching ``repro_torch.serve.ServeEngine``: a
                    slot pool served under open-loop (Poisson arrivals) or
                    closed-loop load, reporting tokens/s and p50/p99 latency.
                    ``--kv paged`` swaps the dense slot rows for the paged
                    block-table subsystem (demand allocation, CoW prefix
                    sharing, recompute or ``--preempt swap`` preemption
                    against a host block tier of ``--host-blocks``, async
                    unless ``--sync-swap``), ``--prefix-cache PATH``
                    warm-starts from a saved prefix cache and saves it
                    back, and ``--kv-dtype int8|fp8`` stores its blocks
                    quantized (per-block scales, read by the fused-dequant
                    kernels). ``--ttft-slo MS`` tunes the chunked budget
                    to a TTFT target.
                    ``--chunked`` serves chunked prefill on either
                    backend; ``--spec-decode ngram`` drafts from each
                    slot's history and verifies the drafts in one program
                    a step; ``--temperature`` / ``--top-k`` sample with
                    per-request threefry key chains.

      python -m repro_torch.launch.serve --preset nss_shortcut --load open
      python -m repro_torch.launch.serve --preset ret_byp --load closed \\
          --slots 8 --requests 32
      python -m repro_torch.launch.serve --kv paged --block-size 16 \\
          --shared-prefix-len 16
      python -m repro_torch.launch.serve --kv paged --chunked --budget 48 \\
          --chunk-width 24
      python -m repro_torch.launch.serve --kv paged --kv-dtype int8 \\
          [--chunked]
      python -m repro_torch.launch.serve --kv paged --num-blocks 12 \\
          --preempt swap [--sync-swap] [--host-blocks N]
      python -m repro_torch.launch.serve --kv paged --prefix-cache p.npz
      python -m repro_torch.launch.serve --kv paged --chunked --budget 48 \\
          --ttft-slo 200                       # the TTFT budget tuner
      python -m repro_torch.launch.serve --chunked --budget 48 \\
          --chunk-width 24                     # slotted chunked prefill
      python -m repro_torch.launch.serve --kv paged --spec-decode ngram \\
          --spec-width 4 --decode-steps 4      # n-gram speculation
      python -m repro_torch.launch.serve --temperature 0.8 --top-k 40
      python -m repro_torch.launch.serve --device cpu     # off the card
      python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \\
          --dtype bf16                   # the MoE model, bf16 parameters
      python -m repro_torch.launch.serve --arch rwkv6-7b  # RWKV, slotted
      python -m repro_torch.launch.serve --arch jamba-v0.1-52b  # Mamba
      python -m repro_torch.launch.serve --arch qwen2-7b --kv paged
      python -m repro_torch.launch.serve --arch h2o-danube-1.8b  # SWA
      python -m repro_torch.launch.serve --mesh 1,2    # 2 ranks, Megatron
                                                       # tensor parallel
      python -m repro_torch.launch.serve --mesh 2,1 --device cpu

  sequential        one request batch at a time (``--load seq``, also
                    ``run_server``): the baseline the engine's continuous
                    batching is held token-identical against.

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU, ``cuda``
raises. The CLI serves the smoke model, as the JAX launcher does;
``run_engine(..., smoke=False)`` serves the published widths.
``--dtype bf16`` (``dtype="bf16"``) sets both the activation and the
parameter dtype (JAX's ``ModelOptions.dtype`` and ``init_params(...,
param_dtype)``); the default, fp32, keeps both in float32. At published
widths moonshot-v1-16b-a3b's 28.06 B parameters take 56.1 GB in bf16 and
do not fit one 80 GB card in fp32; rwkv6-7b's 8.05 B take 32.2 GB in
fp32; jamba-v0.1-52b's 51.57 B fit one card at no dtype, and
``run_engine`` takes an ``ArchConfig`` in place of the name, so a caller
can serve it cut in depth (one of its four blocks: 13.3 B, 53.2 GB in
fp32); the CLI has no depth option, as the JAX launcher has none. RWKV and
Mamba layers carry a recurrent state, so rwkv6-7b and jamba-v0.1-52b run
on the slotted backend only: ``--kv paged``, ``--bucket-prompts``,
``--chunked`` and ``--spec-decode`` raise ``ValueError``, as in JAX.
So does h2o-danube-1.8b: a sliding-window layer's circular buffer has no
block chain. musicgen-medium (embedding inputs) and llama-3.2-vision-11b
(cross-attention over a context no request carries) run at model level
only: both ``run_engine`` and ``run_server`` raise ``ValueError`` for
them, as JAX's engine does.
``--kv-dtype int8|fp8`` or ``--prefix-cache`` without ``--kv paged``
raise ``ValueError``, as in JAX. ``--load seq`` decodes greedily, as
JAX's does. ``--scale S`` widens the smoke model as JAX's launcher does
(``d_model``, ``d_ff`` and the head dim times S).

``--mesh data,model`` serves over a mesh of ``data x model`` ranks
(``repro_torch.launch.mesh.spawn``), each a process on ``--device``:
Megatron tensor parallelism over "model" (every rank holds a slice of
every weight and its KV heads), slots over "data" on the slotted backend.
The ranks take gloo when they share a card (with a single card every
rank runs on ``cuda:0``) or run on the CPU, NCCL when each owns a card.
Rank 0 prints the report (its ``ranks`` list holds every rank's KV bytes,
peak device memory and kernel launches) and writes the trace, metrics and
prefix cache. Two ranks sharing one card measure correctness, not
tensor-parallel speed. MoE, Mamba and RWKV models split their experts,
inner channels and heads over "model" (``repro_torch.sharding.
placement``); L0 (``--preset linux``) with a mesh raises ``ValueError``
before any rank starts, as in JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {list(DTYPES)}")
    return DTYPES[name]


def scaled_config(cfg, scale: float):
    """The smoke config widened by ``scale`` (JAX ``launch/serve.py:57-62``):
    ``d_model`` and ``d_ff`` times ``scale``, the head dim following
    ``d_model`` over the heads."""
    if scale == 1.0:
        return cfg
    return dataclasses.replace(
        cfg, d_model=int(cfg.d_model * scale), d_ff=int(cfg.d_ff * scale),
        d_head=cfg.d_head if cfg.n_heads == 0
        else int(cfg.d_model * scale) // cfg.n_heads)


def _setup(arch, preset_name: str, *, smoke: bool = True, scale: float = 1.0,
           seed: int = 0, gen_len: int = 64, decode_steps: int = 0,
           device="cuda", dtype="fp32"):
    """Shared model/linkage construction for both serving paths: ``arch``
    a registered name or an ``ArchConfig`` (``smoke`` cuts either to its
    smoke variant, widened by ``scale``), weights from the port's own
    seeded init on ``device``, activations and parameters in ``dtype``."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import L3_NSS, preset
    from repro_torch.models import ModelOptions, init_params

    dev = resolve_device(device)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if smoke:
        cfg = scaled_config(cfg.smoke(), scale)
    lk = preset(preset_name)
    if lk.level == L3_NSS:
        k = decode_steps or min(lk.decode_steps, gen_len)
        lk = dataclasses.replace(lk, decode_steps=k)
    dt = _dtype(dtype)
    opts = lk.model_options(ModelOptions(attn_impl="ref", dtype=dt))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dev, param_dtype=dt)
    return cfg, lk, opts, params


def run_engine(arch, preset_name: str, *, n_slots: int = 4,
               prompt_len: int = 32, gen_len: int = 32, requests: int = 8,
               load: str = "open", rate: float = 25.0,
               concurrency: int = 0, decode_steps: int = 0,
               smoke: bool = True, scale: float = 1.0, seed: int = 0,
               device="cuda", mesh="",
               kv: str = "slotted", block_size: int = 16,
               num_blocks: int = 0, bucket_prompts: bool = False,
               temperature: float = 0.0, top_k: int = 0, eos_id: int = -1,
               shared_prefix_len: int = 0, chunked: bool = False,
               budget: int = 256, chunk_width: int = 0,
               preempt: str = "recompute", victim: str = "youngest",
               host_blocks: int = 0, async_swap: bool = True,
               prefix_cache: str = "", ttft_slo: float = 0.0,
               kv_dtype: str = "bf16", spec_decode: str = "none",
               spec_width: int = 0, trace: str = "", metrics: str = "",
               log_interval: float = 0.0, profile_dir: str = "",
               dtype="fp32"):
    """Continuous-batching serving run; returns the engine report dict.
    ``arch`` is a registered name or an ``ArchConfig`` (a config cut in
    depth, say); ``dtype`` ("fp32" or "bf16") is the activation and
    parameter dtype.

    ``prefix_cache`` persists the host tier across runs: the engine warm
    starts from the file when it exists and saves back to it after the
    timed run (``prefix_cache_restored`` / ``prefix_cache_saved`` in the
    report). ``ttft_slo`` (ms, 0 = off) tunes the chunked budget.

    ``trace`` writes the run's Chrome-trace JSON (``.jsonl`` suffix: raw
    JSONL), ``metrics`` the Prometheus text exposition, ``log_interval``
    prints a one-line stats log every S seconds, ``profile_dir`` captures a
    ``torch.profiler`` trace around the first post-warmup steps. All empty
    by default: the engine then runs with the zero-cost NULL_TELEMETRY.

    ``mesh`` ("data,model") serves over that many rank processes
    (``serve_rank`` in each) and returns rank 0's report with every rank's
    summary under ``ranks``; a ``Mesh`` (inside a rank) serves this rank's
    shard.
    """
    kw = dict(locals())
    import os

    from repro_torch.core import MetricWriter, SamplingConfig
    from repro_torch.serve import (PreemptionPolicy, ServeEngine, Telemetry,
                                   serve_report, synthetic_requests)

    if requests < 1:
        raise ValueError("need --requests >= 1")
    if prefix_cache and kv != "paged":
        # fail before the (possibly long) run, not at the save afterwards
        raise ValueError("--prefix-cache needs --kv paged (dense slot rows "
                         "have no prompt-keyed blocks to persist)")
    if isinstance(mesh, str) or mesh is None:
        from repro_torch.launch.mesh import parse_mesh_spec
        if parse_mesh_spec(mesh) is not None:
            return _spawn_engine(kw)
        mesh = None                           # "" or "1,1": one device
    lead = mesh is None or mesh.rank == 0     # the rank that reports
    sampling = SamplingConfig(temperature=temperature, top_k=top_k,
                              seed=seed)
    max_len = prompt_len + gen_len + 8

    tel = None
    if lead and (trace or metrics or log_interval > 0 or profile_dir):
        sink = None
        if metrics and log_interval > 0:
            # periodic registry snapshots through the MetricWriter
            # co-process into <metrics>.jsonl while the run is live
            stream_path = metrics + ".jsonl"
            open(stream_path, "w").close()

            def _append(step, m):
                with open(stream_path, "a") as f:
                    f.write(json.dumps({"step": step, **m}) + "\n")

            sink = MetricWriter(_append)
        tel = Telemetry(trace=bool(trace), log_interval=log_interval,
                        sink=sink,
                        const_labels={"backend": kv, "preset": preset_name})
    warm_start = (prefix_cache if prefix_cache
                  and os.path.exists(prefix_cache) else None)

    def build():
        cfg, lk, opts, params = _setup(arch, preset_name, smoke=smoke,
                                       scale=scale, seed=seed,
                                       gen_len=gen_len,
                                       decode_steps=decode_steps,
                                       device=mesh.device if mesh else device,
                                       dtype=dtype)
        eng = ServeEngine(
            cfg, params, opts, lk, n_slots=n_slots, max_len=max_len, kv=kv,
            block_size=block_size, num_blocks=num_blocks or None,
            sampling=sampling, bucket_prompts=bucket_prompts,
            chunked=chunked, chunk_budget=budget, chunk_width=chunk_width,
            preempt=PreemptionPolicy(mode=preempt, victim=victim),
            host_blocks=host_blocks, async_swap=async_swap,
            warm_start=warm_start,
            ttft_slo_s=ttft_slo / 1e3 if ttft_slo > 0 else None,
            kv_dtype=kv_dtype, spec_decode=spec_decode,
            spec_width=spec_width, telemetry=tel, mesh=mesh)
        del params            # a mesh rank keeps its shard only
        _free(eng.device)
        return cfg, eng
    # a mesh's ranks build in turn: one full copy of the weights at once
    cfg, eng = build() if mesh is None else mesh.in_turn(build)

    # warmup: one request through prefill and one decode program, outside
    # the timed region (first launches load the kernel library and warm
    # the allocator). With a shared prefix a second warmup request hits the
    # radix index and runs the suffix-prefill path too.
    warm = synthetic_requests(2 if shared_prefix_len else 1, prompt_len,
                              eng.tokens_per_program + 1, cfg.vocab_size,
                              seed=seed + 1,
                              shared_prefix_len=shared_prefix_len)
    eng.run(warm, load="closed")
    if hasattr(eng.kv, "drop_prefix_cache"):
        eng.kv.drop_prefix_cache()  # shed warmup residue from the pool
    eng.reset_counters()          # also clears the warmup trace/metrics
    if tel is not None and profile_dir:
        tel.profile_dir = profile_dir

    reqs = synthetic_requests(requests, prompt_len, gen_len, cfg.vocab_size,
                              seed=seed,
                              rate=rate if load == "open" else None,
                              shared_prefix_len=shared_prefix_len,
                              eos_id=eos_id if eos_id >= 0 else None)
    completions, wall = eng.run(reqs, load=load,
                                concurrency=concurrency or None)
    rep = serve_report(completions, wall, utilization=eng.utilization())
    if tel is not None:
        tel.close()               # stop any profiler capture, flush the sink
        if trace:
            n = (tel.trace.export_jsonl(trace) if trace.endswith(".jsonl")
                 else tel.trace.export_chrome(trace))
            rep["trace_path"], rep["trace_events"] = trace, n
        if metrics:
            with open(metrics, "w") as f:
                f.write(tel.metrics.render())
            rep["metrics_path"] = metrics
        if profile_dir:
            rep["profile_dir"] = profile_dir
    rep.update({
        "arch": cfg.name, "preset": preset_name, "load": load,
        "n_slots": n_slots, "prompt_len": prompt_len, "gen_len": gen_len,
        "decode_steps_per_program": eng.tokens_per_program,
        "dtype": str(eng.opts.dtype).removeprefix("torch."),
        "device": _device_name(eng.device),
    })
    if load == "open":
        rep["offered_rate_req_s"] = rate
    if warm_start:
        rep["prefix_cache_restored"] = eng.kv.restored_entries
    if prefix_cache:
        rep["prefix_cache_saved"] = eng.save_prefix_cache(prefix_cache)
    return rep


def serve_rank(mesh, kw: dict) -> dict:
    """One rank of a mesh run (``spawn``'s entry): ``run_engine`` with the
    keyword arguments ``kw`` ("arch" and "preset_name" among them) over
    this rank's ``mesh``. Returns its report, its kernel launches over the
    run (warmup included) and, on CUDA, its peak device memory."""
    from repro_torch.kernels import ops
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    rep = run_engine(**{**kw, "mesh": mesh})
    return {"rank": mesh.rank, "coords": mesh.coords, "report": rep,
            "launches": ops.launch_counts(),
            "kv_bytes_per_shard": rep["kv_bytes_per_shard"],
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}


def _spawn_engine(kw: dict) -> dict:
    """A mesh run from outside the ranks: check what the ranks would
    refuse, spawn them, and return rank 0's report with every rank's
    summary under ``ranks``."""
    from repro_torch.configs import get_config
    from repro_torch.core import preset
    from repro_torch.core.step import check_mesh_linkage
    from repro_torch.launch.mesh import mesh_shape, parse_mesh_spec, spawn
    from repro_torch.sharding.placement import check_mesh
    cfg = (get_config(kw["arch"]) if isinstance(kw["arch"], str)
           else kw["arch"])
    if kw["smoke"]:
        cfg = scaled_config(cfg.smoke(), kw["scale"])
    check_mesh(cfg, mesh_shape(*parse_mesh_spec(kw["mesh"])))
    check_mesh_linkage(preset(kw["preset_name"]), True)
    out = spawn(serve_rank, kw["mesh"], kw["device"], (kw,))
    rep = dict(out[0]["report"])
    rep["ranks"] = [{k: o[k] for k in ("rank", "coords", "launches",
                                       "kv_bytes_per_shard",
                                       "peak_memory_bytes")} for o in out]
    return rep


def _free(dev: torch.device) -> None:
    """Hand the caching allocator's free blocks back to the card (a mesh
    rank that shares it, after freeing its full weights)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_server(arch: str, preset_name: str, *, batch: int = 8,
               prompt_len: int = 64, gen_len: int = 64, requests: int = 4,
               smoke: bool = True, scale: float = 1.0, seed: int = 0,
               device="cuda", dtype="fp32"):
    """Sequential baseline: whole-batch prefill + decode, one request batch
    at a time (no admission between programs), in ``dtype``."""
    from repro_torch.core import L3_NSS, build_decode_step
    from repro_torch.models import prefill
    from repro_torch.serve.engine import check_servable

    cfg, lk, opts, params = _setup(arch, preset_name, smoke=smoke,
                                   scale=scale, seed=seed, gen_len=gen_len,
                                   decode_steps=gen_len, device=device,
                                   dtype=dtype)
    check_servable(cfg)
    dev = params["embed"].device
    dec = build_decode_step(cfg, opts, lk)
    rng = np.random.default_rng(seed)
    max_len = prompt_len + gen_len + 8

    def one_request(toks):
        """prefill + decode gen_len tokens; returns #tokens produced."""
        logits, cache = prefill(params, toks, cfg, opts, max_len=max_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if lk.level == L3_NSS:
            cache, seq = dec(params, cache, nxt)
            _sync(dev)
            return seq.shape[0] * seq.shape[1]
        n = 0
        for _ in range(gen_len):
            cache, out = dec(params, cache, nxt)
            nxt = out[:, 0]
            n += batch
        _sync(dev)
        return n

    def draw():
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(batch, prompt_len),
            dtype=np.int32)).to(dev)

    one_request(draw())       # warmup, outside the timed region
    lat = []
    tokens_out = 0
    t_all = time.time()
    for _ in range(requests):
        toks = draw()
        t0 = time.time()
        tokens_out += one_request(toks)
        lat.append(time.time() - t0)
    wall = time.time() - t_all
    return {
        "arch": cfg.name, "preset": preset_name, "load": "seq",
        "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
        "requests": requests, "wall_s": wall,
        "total_tokens": tokens_out,
        "tokens_per_s": tokens_out / wall,
        "mean_latency_s": float(np.mean(lat)),
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p99_latency_s": float(np.percentile(lat, 99)),
        "dtype": str(opts.dtype).removeprefix("torch."),
        "device": _device_name(dev),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default="tinyllama-1.1b",
                   help="a registered config: tinyllama-1.1b, qwen2-7b, "
                        "mistral-large-123b and the MoE models "
                        "moonshot-v1-16b-a3b, kimi-k2-1t-a32b and "
                        "mixtral-8x7b on either backend; h2o-danube-1.8b "
                        "(sliding window), rwkv6-7b and jamba-v0.1-52b "
                        "slotted only; musicgen-medium (embedding inputs) "
                        "and llama-3.2-vision-11b (cross-attention) run at "
                        "model level only and raise ValueError here")
    p.add_argument("--dtype", default="fp32", choices=list(DTYPES),
                   help="activation and parameter dtype")
    p.add_argument("--preset", default="nss_shortcut")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--load", default="open",
                   choices=["open", "closed", "seq"],
                   help="open: Poisson arrivals at --rate; closed: "
                        "--concurrency outstanding; seq: sequential baseline")
    p.add_argument("--slots", type=int, default=4,
                   help="engine cache slots (continuous-batching batch)")
    p.add_argument("--kv", default="slotted", choices=["slotted", "paged"],
                   help="KV backend: dense slot rows, or the paged "
                        "block-table subsystem (demand allocation + CoW "
                        "prefix sharing)")
    p.add_argument("--block-size", type=int, default=16,
                   help="paged: tokens per physical KV block")
    p.add_argument("--num-blocks", type=int, default=0,
                   help="paged: physical pool size (0 = slots*max_len/bs, "
                        "the slotted-equivalent footprint)")
    p.add_argument("--preempt", default="recompute",
                   choices=["recompute", "swap"],
                   help="paged pool-pressure policy: recompute replays the "
                        "victim from scratch; swap copies its blocks to the "
                        "host tier and resumes without re-prefill")
    p.add_argument("--victim", default="youngest",
                   choices=["youngest", "lru"],
                   help="preemption victim: youngest admission, or the "
                        "least-recently-emitting slot")
    p.add_argument("--host-blocks", type=int, default=0,
                   help="paged: host-tier pool size in blocks (0 = auto: "
                        "mirror the device pool when --preempt swap or a "
                        "prefix cache is in play, else disabled)")
    p.add_argument("--sync-swap", action="store_true",
                   help="paged: blocking tier transfers instead of the "
                        "async swap stream (side CUDA stream, resume-head "
                        "prefetch); token streams are identical either way")
    p.add_argument("--prefix-cache", default="",
                   help="paged: persist the prefix cache at this path — "
                        "warm-start from it when it exists, save back after "
                        "the run (prompt-token-keyed, config-fingerprinted)")
    p.add_argument("--ttft-slo", type=float, default=0.0,
                   help="chunked: target TTFT in ms — AIMD-adjusts the "
                        "token budget after each completion (0 = off)")
    p.add_argument("--chunked", action="store_true",
                   help="chunked prefill — one unified program per engine "
                        "step (decode tokens first, budget-packed prompt "
                        "chunks after), on either KV backend")
    p.add_argument("--budget", type=int, default=256,
                   help="chunked: target tokens per serve step")
    p.add_argument("--chunk-width", type=int, default=0,
                   help="chunked: per-row chunk width W "
                        "(0 = min(budget, max_len))")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="prepend a common prefix of this many tokens to "
                        "every prompt (exercises paged CoW prefix sharing)")
    p.add_argument("--bucket-prompts", action="store_true",
                   help="pad admitted prompts to power-of-two buckets")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy argmax)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k truncation when sampling (0 = full vocab)")
    p.add_argument("--spec-decode", default="none",
                   choices=["none", "ngram"],
                   help="speculative decoding: ngram drafts W-1 tokens per "
                        "decode row by prompt lookup over the slot's own "
                        "history, verified in one chunk-shaped program "
                        "(greedy streams stay identical)")
    p.add_argument("--spec-width", type=int, default=0,
                   help="verify window W per row: 1 next token + up to W-1 "
                        "drafts (0 = default 4)")
    p.add_argument("--eos-id", type=int, default=-1,
                   help="stop token id (-1 = length-based completion only)")
    p.add_argument("--rate", type=float, default=25.0,
                   help="open-loop offered load, requests/s")
    p.add_argument("--concurrency", type=int, default=0,
                   help="closed-loop outstanding requests (0 = slots)")
    p.add_argument("--decode-steps", type=int, default=0,
                   help="L3 tokens per decode program (0 = preset default, "
                        "clipped to gen-len)")
    p.add_argument("--batch", type=int, default=8,
                   help="batch size for --load seq")
    p.add_argument("--trace", default="",
                   help="write the run's trace here: Chrome-trace JSON, or "
                        "raw JSONL if the path ends in .jsonl")
    p.add_argument("--metrics", default="",
                   help="write the Prometheus text exposition here")
    p.add_argument("--log-interval", type=float, default=0.0,
                   help="print a one-line engine stats log every S seconds")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace around the first "
                        "post-warmup engine steps into this dir")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report-json", default=None)
    p.add_argument("--kv-dtype", default="bf16",
                   choices=["bf16", "int8", "fp8"],
                   help="paged: block storage — bf16 keeps the activation "
                        "dtype (the uncompressed control), int8/fp8 store "
                        "per-block scaled codes")
    p.add_argument("--mesh", default="",
                   help="serving mesh as 'data,model' (e.g. 1,2): one rank "
                        "process a position, weights tensor-parallel over "
                        "'model', KV heads per-rank resident, slots over "
                        "'data'. Empty or 1,1 = single device")
    p.add_argument("--scale", type=float, default=1.0,
                   help="width multiplier on the smoke config")
    args = p.parse_args(argv)

    from repro_torch.serve import check_slice
    check_slice(kv=args.kv, spec_decode=args.spec_decode,
                kv_dtype=args.kv_dtype)
    if args.load == "seq":
        rep = run_server(args.arch, args.preset, batch=args.batch,
                         prompt_len=args.prompt_len, gen_len=args.gen_len,
                         requests=args.requests, scale=args.scale,
                         seed=args.seed, device=args.device,
                         dtype=args.dtype)
    else:
        rep = run_engine(args.arch, args.preset, n_slots=args.slots,
                         prompt_len=args.prompt_len, gen_len=args.gen_len,
                         requests=args.requests, load=args.load,
                         rate=args.rate, concurrency=args.concurrency,
                         decode_steps=args.decode_steps,
                         scale=args.scale, seed=args.seed,
                         device=args.device, mesh=args.mesh, kv=args.kv,
                         block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         bucket_prompts=args.bucket_prompts,
                         temperature=args.temperature, top_k=args.top_k,
                         eos_id=args.eos_id,
                         shared_prefix_len=args.shared_prefix_len,
                         chunked=args.chunked, budget=args.budget,
                         chunk_width=args.chunk_width,
                         preempt=args.preempt, victim=args.victim,
                         host_blocks=args.host_blocks,
                         async_swap=not args.sync_swap,
                         prefix_cache=args.prefix_cache,
                         ttft_slo=args.ttft_slo,
                         kv_dtype=args.kv_dtype,
                         spec_decode=args.spec_decode,
                         spec_width=args.spec_width,
                         trace=args.trace, metrics=args.metrics,
                         log_interval=args.log_interval,
                         profile_dir=args.profile_dir, dtype=args.dtype)
    print(json.dumps(rep, indent=1))
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(rep, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

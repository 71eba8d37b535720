"""Fleet serving launcher of the port — N engine replicas behind the
prefix-affinity router, with optional prefill/decode disaggregation
(``src/repro/launch/fleet.py``), on the GPU.

  python -m repro_torch.launch.fleet --replicas 2                # colocated
  python -m repro_torch.launch.fleet --replicas 2 --disaggregate 1
      # one prefill cell streams chunked prefill, one decode cell takes
      # the finished KV chains over the shared host tier
  python -m repro_torch.launch.fleet --replicas 2 --shared-prefix-len 16
      # a prefix prefilled by either replica warms both through the
      # shared host-tier prefix store
  python -m repro_torch.launch.fleet --device cpu                # off the card
  python -m repro_torch.launch.fleet --mesh 1,2 --replicas 2
      # every replica over one data x model mesh of spawned ranks

Every replica serves from one copy of the weights on the device. The
report is ``fleet_report``: percentiles over the pooled completions,
counters summed across replicas, the handoff and shared-store totals, and
the per-replica breakdown under ``per_replica``. Runs on ``cuda`` unless
``--device cpu`` is given; the CLI serves the smoke model, as the JAX
launcher does (``run_fleet_engine(..., smoke=False)`` serves the published
widths); ``--scale S`` widens it as the serve launcher does.

``--mesh data,model`` runs every replica over one mesh of ``data x
model`` rank processes (``repro_torch.launch.mesh.spawn``, as the serve
launcher's ``--mesh``): each rank holds its shard of the weights and its
own shared host tier over its KV heads, and rank 0 reports (the mesh under
"mesh", every rank's launches and peak memory under ``ranks``).
"""
from __future__ import annotations

import argparse
import json
import sys


def run_fleet_engine(arch, preset_name: str, *, replicas: int = 2,
                     disaggregate: int = 0, n_slots: int = 4,
                     prompt_len: int = 32, gen_len: int = 32,
                     requests: int = 8, load: str = "open",
                     rate: float = 25.0, concurrency: int = 0,
                     decode_steps: int = 0, smoke: bool = True,
                     scale: float = 1.0, seed: int = 0, kv: str = "paged",
                     block_size: int = 16, num_blocks: int = 0,
                     admit_cap: int = 0, shared_host_blocks: int = 0,
                     temperature: float = 0.0, top_k: int = 0,
                     shared_prefix_len: int = 0, mesh: str = "",
                     chunked: bool = False, budget: int = 256,
                     preempt: str = "recompute", victim: str = "youngest",
                     kv_dtype: str = "bf16", trace: str = "",
                     metrics: str = "", async_swap: bool = True,
                     device="cuda", dtype="fp32"):
    """Run a request workload through a ``FleetEngine``; returns the fleet
    report dict. ``arch`` is a registered name or an ``ArchConfig``;
    ``dtype`` ("fp32" or "bf16") is the activation and parameter dtype.
    ``mesh`` ("data,model") runs the fleet in that many rank processes
    (``fleet_rank`` in each) and returns rank 0's report with every
    rank's summary under ``ranks``; a ``Mesh`` (inside a rank) serves
    this rank's shard."""
    kw = dict(locals())
    from repro_torch.core import SamplingConfig
    from repro_torch.launch.serve import _free, _setup
    from repro_torch.serve import (FleetEngine, PreemptionPolicy, Telemetry,
                                   check_slice, fleet_report,
                                   synthetic_requests)

    check_slice(kv=kv, kv_dtype=kv_dtype)
    if requests < 1:
        raise ValueError("need --requests >= 1")
    if isinstance(mesh, str) or mesh is None:
        from repro_torch.launch.mesh import parse_mesh_spec
        if parse_mesh_spec(mesh) is not None:
            return _spawn_fleet(kw)
        mesh = None                           # "" or "1,1": one device
    lead = mesh is None or mesh.rank == 0     # the rank that reports
    max_len = prompt_len + gen_len + 8
    sampling = SamplingConfig(temperature=temperature, top_k=top_k,
                              seed=seed)
    tel = None
    if lead and (trace or metrics):
        tel = Telemetry(trace=bool(trace),
                        const_labels={"backend": kv, "preset": preset_name,
                                      "replicas": str(replicas)})

    def build():
        cfg, lk, opts, params = _setup(arch, preset_name, smoke=smoke,
                                       scale=scale, seed=seed,
                                       gen_len=gen_len,
                                       decode_steps=decode_steps,
                                       device=mesh.device if mesh else device,
                                       dtype=dtype)
        fleet = FleetEngine(
            cfg, params, opts, lk, replicas=replicas,
            prefill_replicas=disaggregate, n_slots=n_slots, max_len=max_len,
            admit_cap=admit_cap or None,
            shared_host_blocks=shared_host_blocks or None,
            telemetry=tel, kv=kv, block_size=block_size,
            num_blocks=num_blocks or None, sampling=sampling,
            chunked=chunked, chunk_budget=budget,
            preempt=PreemptionPolicy(mode=preempt, victim=victim),
            kv_dtype=kv_dtype, async_swap=async_swap, mesh=mesh)
        del params            # a mesh rank keeps its shard only
        _free(fleet.engines[0].device)
        return cfg, fleet
    # a mesh's ranks build in turn: one full copy of the weights at once
    cfg, fleet = build() if mesh is None else mesh.in_turn(build)

    # warmup: one pass through every replica's programs (prefill cells the
    # serve step, decode cells the handoff import and decode), its prefix
    # residue shed and the counters zeroed before the timed run
    warm = synthetic_requests(
        max(2, replicas) if shared_prefix_len else max(1, replicas),
        prompt_len, fleet.engines[0].tokens_per_program + 1,
        cfg.vocab_size, seed=seed + 1, shared_prefix_len=shared_prefix_len)
    fleet.run(warm, load="closed")
    fleet.drop_prefix_cache()
    fleet.reset_counters()

    reqs = synthetic_requests(requests, prompt_len, gen_len, cfg.vocab_size,
                              seed=seed,
                              rate=rate if load == "open" else None,
                              shared_prefix_len=shared_prefix_len)
    completions, wall = fleet.run(reqs, load=load,
                                  concurrency=concurrency or None)
    rep = fleet_report(completions, wall, fleet)
    if tel is not None:
        tel.close()
        if trace:
            n = (tel.trace.export_jsonl(trace) if trace.endswith(".jsonl")
                 else tel.trace.export_chrome(trace))
            rep["trace_path"], rep["trace_events"] = trace, n
        if metrics:
            with open(metrics, "w") as f:
                f.write(tel.metrics.render())
            rep["metrics_path"] = metrics
    rep.update({
        "arch": cfg.name, "preset": preset_name, "load": load,
        "n_slots": n_slots, "prompt_len": prompt_len, "gen_len": gen_len,
        "decode_steps_per_program": fleet.engines[0].tokens_per_program,
    })
    if load == "open":
        rep["offered_rate_req_s"] = rate
    return rep


def fleet_rank(mesh, kw: dict) -> dict:
    """One rank of a mesh fleet (``spawn``'s entry): ``run_fleet_engine``
    with the keyword arguments ``kw`` over this rank's ``mesh``. Returns
    its report, its kernel launches over the run (warmup included) and,
    on CUDA, its peak device memory."""
    import torch
    from repro_torch.kernels import ops
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    rep = run_fleet_engine(**{**kw, "mesh": mesh})
    return {"rank": mesh.rank, "coords": mesh.coords, "report": rep,
            "launches": ops.launch_counts(),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}


def _spawn_fleet(kw: dict) -> dict:
    """A mesh fleet from outside the ranks: check what the ranks would
    refuse, spawn them, and return rank 0's report with every rank's
    summary under ``ranks``."""
    from repro_torch.configs import get_config
    from repro_torch.core import preset
    from repro_torch.core.step import check_mesh_linkage
    from repro_torch.launch.mesh import mesh_shape, parse_mesh_spec, spawn
    from repro_torch.launch.serve import scaled_config
    from repro_torch.sharding.placement import check_mesh
    cfg = (get_config(kw["arch"]) if isinstance(kw["arch"], str)
           else kw["arch"])
    if kw["smoke"]:
        cfg = scaled_config(cfg.smoke(), kw["scale"])
    check_mesh(cfg, mesh_shape(*parse_mesh_spec(kw["mesh"])))
    check_mesh_linkage(preset(kw["preset_name"]), True)
    out = spawn(fleet_rank, kw["mesh"], kw["device"], (kw,))
    rep = dict(out[0]["report"])
    rep["ranks"] = [{k: o[k] for k in ("rank", "coords", "launches",
                                       "peak_memory_bytes")} for o in out]
    return rep


def main(argv=None) -> int:
    from repro_torch.launch.serve import DTYPES
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default="tinyllama-1.1b")
    p.add_argument("--preset", default="nss_shortcut")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--dtype", default="fp32", choices=list(DTYPES),
                   help="activation and parameter dtype")
    p.add_argument("--replicas", type=int, default=2,
                   help="engine replicas behind the router")
    p.add_argument("--disaggregate", type=int, default=0,
                   help="of the replicas, how many are prefill cells (0 = "
                        "colocated: every replica prefills and decodes its "
                        "own requests); the rest are decode cells taking "
                        "KV-chain handoffs")
    p.add_argument("--load", default="open", choices=["open", "closed"])
    p.add_argument("--slots", type=int, default=4,
                   help="cache slots per replica")
    p.add_argument("--kv", default="paged", choices=["slotted", "paged"],
                   help="KV backend per replica (the shared prefix store "
                        "and disaggregation need paged)")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=0,
                   help="paged: per-replica device pool size (0 = auto)")
    p.add_argument("--admit-cap", type=int, default=0,
                   help="router backpressure: max queued requests per "
                        "replica (0 = 2x slots)")
    p.add_argument("--shared-host-blocks", type=int, default=0,
                   help="shared prefix store size in blocks (0 = auto: "
                        "replicas x device pool)")
    p.add_argument("--kv-dtype", default="bf16",
                   choices=["bf16", "int8", "fp8"])
    p.add_argument("--preempt", default="recompute",
                   choices=["recompute", "swap"])
    p.add_argument("--victim", default="youngest",
                   choices=["youngest", "lru"])
    p.add_argument("--sync-swap", action="store_true",
                   help="paged: blocking tier transfers instead of the "
                        "async swap stream (handoffs included); token "
                        "streams are identical either way")
    p.add_argument("--chunked", action="store_true",
                   help="chunked prefill on every replica (prefill cells "
                        "are always chunked)")
    p.add_argument("--budget", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="common prompt prefix (exercises the shared "
                        "cross-replica prefix store)")
    p.add_argument("--mesh", default="",
                   help="per-replica serving mesh 'data,model': every "
                        "replica over one mesh of spawned ranks")
    p.add_argument("--rate", type=float, default=25.0)
    p.add_argument("--concurrency", type=int, default=0,
                   help="closed-loop outstanding requests "
                        "(0 = admitting replicas x slots)")
    p.add_argument("--decode-steps", type=int, default=0)
    p.add_argument("--trace", default="",
                   help="write the fleet's Chrome trace here: replicas on "
                        "their own process tracks (engine/0, engine/1, "
                        "...) with handoff events between them")
    p.add_argument("--metrics", default="")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--scale", type=float, default=1.0,
                   help="width multiplier on the smoke config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report-json", default=None)
    args = p.parse_args(argv)

    rep = run_fleet_engine(
        args.arch, args.preset, replicas=args.replicas,
        disaggregate=args.disaggregate, n_slots=args.slots,
        prompt_len=args.prompt_len, gen_len=args.gen_len,
        requests=args.requests, load=args.load, rate=args.rate,
        concurrency=args.concurrency, decode_steps=args.decode_steps,
        scale=args.scale, seed=args.seed, kv=args.kv,
        block_size=args.block_size, num_blocks=args.num_blocks,
        admit_cap=args.admit_cap,
        shared_host_blocks=args.shared_host_blocks,
        temperature=args.temperature, top_k=args.top_k,
        shared_prefix_len=args.shared_prefix_len, mesh=args.mesh,
        chunked=args.chunked, budget=args.budget, preempt=args.preempt,
        victim=args.victim, kv_dtype=args.kv_dtype, trace=args.trace,
        metrics=args.metrics, async_swap=not args.sync_swap,
        device=args.device, dtype=args.dtype)
    print(json.dumps(rep, indent=1))
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(rep, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

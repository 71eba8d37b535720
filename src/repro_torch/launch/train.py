"""Training launcher of the port (``src/repro/launch/train.py``):

    python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --preset nss_shortcut                  # published widths, on cuda
    python -m repro_torch.launch.train --smoke --device cpu --steps 5
    python -m repro_torch.launch.train --data-mesh 2     # 2 ranks, FSDP

Runs the fault-tolerant driver (``repro_torch.runtime.train``) on
``cuda`` unless ``--device cpu`` is given (without a GPU, ``cuda``
raises). ``--smoke`` trains the reduced same-family config, widened by
``--scale`` as JAX's launcher widens it; without it, the published
widths. ``--data-mesh N`` (N > 1) trains over an N x 1 mesh of rank
processes (``repro_torch.launch.mesh.spawn`` on ``--device``: gloo when
the ranks share one card or run on the CPU, NCCL with a card a rank)
through ``build_sharded_train_step``: the parameters and both moments
FSDP-cut over "data", the batch split over it (replicated when
``--global-batch`` does not divide, as JAX's ``batch_spec`` falls back).
Rank 0's report is printed and written, with the ``mesh`` and every
rank's peak memory, launches and collective bytes under ``ranks``.
``--sync-every`` sets the ret_async read cadence (the preset's, 16, by
default).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time


def _setup(kw: dict):
    """(cfg, linkage, ModelOptions, AdamWConfig) of a launch. ``kw["arch"]``
    is a registered name or an ``ArchConfig`` (a caller's depth cut)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions
    from repro_torch.optim import AdamWConfig

    cfg = kw["arch"]
    if not isinstance(cfg, ArchConfig):
        cfg = get_config(cfg)
        if kw["smoke"]:
            cfg = cfg.smoke()
            if kw["scale"] != 1.0:
                s = kw["scale"]
                cfg = dataclasses.replace(
                    cfg,
                    name=cfg.name + f"-x{s:g}",
                    d_model=int(cfg.d_model * s),
                    d_ff=int(cfg.d_ff * s),
                    d_head=(cfg.d_head if cfg.n_heads == 0
                            else int(cfg.d_model * s) // cfg.n_heads),
                    vocab_size=max(cfg.vocab_size, 8192),
                    num_blocks=min(get_config(kw["arch"]).num_blocks, 8),
                )
    lk = preset(kw["preset"])
    lk = dataclasses.replace(lk, nss_steps=kw["nss_steps"],
                             sync_every=kw["sync_every"] or lk.sync_every)
    # fp32 and the plain attention and scans, as JAX's launcher (:65); the
    # shortcut then routes attention and the norms through the flash and
    # rmsnorm kernels' autograd Functions. The scans and the MoE router
    # stay plain ("ref"): their kernels have no backward, as JAX's Pallas
    # scans and router have no VJP (JAX's CPU shortcut trains their plain
    # blockwise forms, core/linkage.py:104-117).
    opts = ModelOptions(attn_impl="ref", scan_impl="ref", dtype=torch.float32)
    if lk.shortcut:
        opts = dataclasses.replace(lk.model_options(opts), scan_impl="ref")
    ocfg = AdamWConfig(lr=kw["lr"], warmup_steps=max(kw["steps"] // 20, 1),
                       total_steps=kw["steps"])
    return cfg, lk, opts, ocfg


def _digest(state) -> str:
    """sha256 of the state's leaves' bytes, in tree order."""
    import torch
    from repro_torch import tree
    h = hashlib.sha256()
    for x in tree.leaves(state):
        h.update(x.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _train(kw: dict, device, mesh=None) -> dict:
    """One process's training run (``mesh``: this rank's, the state and
    the step sharded over it). Returns its report."""
    import torch
    from repro_torch.core import (build_sharded_train_step, build_train_step,
                                  init_train_state)
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.runtime import DriverConfig, FailureInjector, train
    from repro_torch.sharding import comm
    from repro_torch.sharding.placement import train_shard

    cfg, lk, opts, ocfg = _setup(kw)
    lead = mesh is None or mesh.rank == 0
    if lead:
        print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
              f"linkage={kw['preset']} steps={kw['steps']} device={device}"
              + (f" mesh={mesh.describe()}" if mesh is not None else ""),
              flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, ocfg, gen, device)
    extra = {}
    if mesh is None:
        step_fn = build_train_step(cfg, opts, ocfg, lk).fn
    else:
        step_fn, sspecs, bspecs = build_sharded_train_step(
            cfg, opts, ocfg, lk, mesh, state, kw["global_batch"])
        # this rank's pieces; the full state is freed
        state = train_shard(cfg, state, mesh, kw["global_batch"]).state
        extra = dict(batch_specs=bspecs, state_specs=sspecs, mesh=mesh)
        ops.reset_launch_counts()
        comm.reset_traffic()
    pipe = Pipeline(cfg, DataConfig(global_batch=kw["global_batch"],
                                    seq_len=kw["seq_len"]))
    dcfg = DriverConfig(total_steps=kw["steps"], ckpt_every=kw["ckpt_every"],
                        ckpt_dir=kw["ckpt_dir"])
    fail_at = kw.get("fail_at") or ()
    injector = FailureInjector(fail_at=fail_at) if fail_at else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    rep = train(step_fn, state, pipe, lk, dcfg, injector, **extra)
    dt = time.time() - t0
    tok_s = rep.steps_run * kw["global_batch"] * kw["seq_len"] / dt
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    out = {"arch": cfg.name, "preset": kw["preset"], "device": str(device),
           "steps": rep.steps_run, "wall_s": dt, "tokens_per_s": tok_s,
           "losses": rep.losses, "step_losses": rep.step_losses,
           "restarts": rep.restarts, "peak_mem_gb": peak}
    if mesh is not None:
        out.update(rank=mesh.rank, coords=mesh.coords,
                   launches=ops.launch_counts(), traffic=comm.traffic())
    if kw.get("digest"):
        out["state_sha256"] = _digest(rep.state)
    return out


def train_rank(mesh, kw: dict) -> dict:
    """One rank of ``--data-mesh`` (``spawn``'s entry)."""
    return _train(kw, mesh.device, mesh)


#: the per-rank keys of a mesh run's report, listed under "ranks"
RANK_KEYS = ("rank", "coords", "peak_mem_gb", "launches", "traffic",
             "wall_s", "state_sha256")


def run(kw: dict) -> dict:
    """A launch from the parsed flags (``main``'s namespace as a dict;
    also ``fail_at``, steps at which every rank's ``FailureInjector``
    fires, and ``digest``, the final state's sha256 a rank): one device,
    or ``--data-mesh`` > 1 ranks, whose rank 0's report it returns with
    the ``mesh`` and every rank's ``RANK_KEYS`` under ``ranks``."""
    from repro_torch import resolve_device
    n = kw["data_mesh"]
    if n <= 1:
        return _train(kw, resolve_device(kw["device"]))
    from repro_torch.launch.mesh import spawn
    ranks = spawn(train_rank, f"{n},1", kw["device"], (kw,))
    out = dict(ranks[0], mesh=f"{n}x1")
    out["ranks"] = [{k: r.get(k) for k in RANK_KEYS} for r in ranks]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tinyllama-1.1b")
    p.add_argument("--preset", default="byp",
                   help="linkage preset: linux|base|byp|ret_byp|nss|"
                        "ret_byp_shortcut|nss_shortcut")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-sized)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="width multiplier on the smoke config")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--nss-steps", type=int, default=4)
    p.add_argument("--sync-every", type=int, default=0,
                   help="ret_async: read the metrics every N calls "
                        "(0 = the preset's)")
    p.add_argument("--data-mesh", type=int, default=0,
                   help="shard the state and the batch over this many "
                        "ranks (0 or 1 = one device)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--report-json", default=None)
    args = p.parse_args(argv)
    rep = run(vars(args))
    print(f"done: steps={rep['steps']} wall={rep['wall_s']:.1f}s "
          f"tokens/s={rep['tokens_per_s']:.0f} "
          f"first_loss={rep['losses'][0]:.4f} "
          f"last_loss={rep['losses'][-1]:.4f} restarts={rep['restarts']}"
          + (f" mesh={rep['mesh']}" if "mesh" in rep else ""), flush=True)
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(rep, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

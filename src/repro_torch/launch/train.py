"""Training launcher of the port (``src/repro/launch/train.py``):

    python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --preset nss_shortcut                  # published widths, on cuda
    python -m repro_torch.launch.train --smoke --device cpu --steps 5

Runs the fault-tolerant driver (``repro_torch.runtime.train``) on one
device: ``cuda`` unless ``--device cpu`` is given (without a GPU, ``cuda``
raises). ``--smoke`` trains the reduced same-family config, widened by
``--scale`` as JAX's launcher widens it; without it, the published
widths. ``--data-mesh`` > 0 (a data-parallel mesh) raises
``NotImplementedError``: ROADMAP entry 9b. ``--sync-every`` sets the
ret_async read cadence (the preset's, 16, by default).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time


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
                   help="shard the batch over this many devices "
                        "(0 = single; needs ROADMAP entry 9b)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--report-json", default=None)
    args = p.parse_args(argv)
    if args.data_mesh > 0:
        raise NotImplementedError("--data-mesh is not ported yet: ROADMAP "
                                  "entry 9b (training over a mesh)")

    import torch
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import (build_train_step, init_train_state,
                                  preset)
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.models import ModelOptions
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import DriverConfig, train

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        if args.scale != 1.0:
            s = args.scale
            cfg = dataclasses.replace(
                cfg,
                name=cfg.name + f"-x{s:g}",
                d_model=int(cfg.d_model * s),
                d_ff=int(cfg.d_ff * s),
                d_head=(cfg.d_head if cfg.n_heads == 0
                        else int(cfg.d_model * s) // cfg.n_heads),
                vocab_size=max(cfg.vocab_size, 8192),
                num_blocks=min(get_config(args.arch).num_blocks, 8),
            )
    lk = preset(args.preset)
    lk = dataclasses.replace(lk, nss_steps=args.nss_steps,
                             sync_every=args.sync_every or lk.sync_every)
    # fp32 and the plain attention and scans, as JAX's launcher (:65); the
    # shortcut then routes attention and the norms through the flash and
    # rmsnorm kernels' autograd Functions. The scans and the MoE router
    # stay plain ("ref"): their kernels have no backward, as JAX's Pallas
    # scans and router have no VJP (JAX's CPU shortcut trains their plain
    # blockwise forms, core/linkage.py:104-117).
    opts = ModelOptions(attn_impl="ref", scan_impl="ref", dtype=torch.float32)
    if lk.shortcut:
        opts = dataclasses.replace(lk.model_options(opts), scan_impl="ref")
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)

    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"linkage={args.preset} steps={args.steps} device={device}",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, ocfg, gen, device)
    step = build_train_step(cfg, opts, ocfg, lk)
    pipe = Pipeline(cfg, DataConfig(global_batch=args.global_batch,
                                    seq_len=args.seq_len))
    dcfg = DriverConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    rep = train(step.fn, state, pipe, lk, dcfg)
    dt = time.time() - t0
    tok_s = rep.steps_run * args.global_batch * args.seq_len / dt
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    print(f"done: steps={rep.steps_run} wall={dt:.1f}s tokens/s={tok_s:.0f} "
          f"first_loss={rep.losses[0]:.4f} last_loss={rep.losses[-1]:.4f} "
          f"restarts={rep.restarts}", flush=True)
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump({"arch": cfg.name, "preset": args.preset,
                       "device": str(device), "steps": rep.steps_run,
                       "wall_s": dt, "tokens_per_s": tok_s,
                       "losses": rep.losses,
                       "step_losses": rep.step_losses,
                       "restarts": rep.restarts,
                       "peak_mem_gb": peak}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

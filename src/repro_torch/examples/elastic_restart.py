"""Elastic restart (JAX ``examples/elastic_restart.py``): train on one
mesh, checkpoint, resume on another; the checkpoint holds the full
logical arrays and each rank of the new mesh restores its own pieces.

    python -m repro_torch.examples.elastic_restart          # on the card
    python -m repro_torch.examples.elastic_restart --device cpu

The smoke tinyllama-1.1b trains 20 steps at 2x1 (FSDP over "data"),
rank 0 writes the step-20 checkpoint, then a 1x2 mesh (tensor parallel)
restores it and trains to step 40; the loss must still fall.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

STEPS = 20


def _rank(mesh, ckpt_dir: str, resume: bool) -> float:
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import (L2_BYP, LinkageConfig,
                                  build_sharded_train_step, init_train_state)
    from repro_torch.data import DataConfig, Pipeline, stage
    from repro_torch.models import ModelOptions
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.placement import train_shard

    cfg = get_config("tinyllama-1.1b").smoke()
    opts = ModelOptions(attn_impl="ref", scan_impl="ref", dtype=torch.float32)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=3 * STEPS)
    lk = LinkageConfig(level=L2_BYP)
    pipe = Pipeline(cfg, DataConfig(global_batch=4, seq_len=32))
    gen = torch.Generator(device=mesh.device).manual_seed(int(resume))
    state = init_train_state(cfg, ocfg, gen, mesh.device)
    fn, sspecs, bspecs = build_sharded_train_step(cfg, opts, ocfg, lk, mesh,
                                                  state, 4)
    state = train_shard(cfg, state, mesh, 4).state
    first = 0
    if resume:
        state = ckpt.restore(ckpt_dir, STEPS, state, sspecs, mesh)
        first = int(state.step)
    for s in range(first, first + STEPS):
        state, m = fn(state, stage(pipe.batch_at(s), mesh.device, bspecs,
                                   mesh))
    if not resume:
        ckpt.save(ckpt_dir, STEPS, state, specs=sspecs, mesh=mesh)
    return float(m["loss"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from repro_torch.launch.mesh import spawn
    d = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        loss_a = spawn(_rank, "2,1", args.device, (d, False))[0]
        print(f"mesh 2x1: trained to step {STEPS}, loss={loss_a:.4f}, "
              "checkpointed", flush=True)
        loss_b = spawn(_rank, "1,2", args.device, (d, True))[0]
        print(f"mesh 1x2: resumed at step {STEPS} from the 2x1 checkpoint, "
              f"trained to {2 * STEPS}, loss={loss_b:.4f}", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert loss_b < loss_a, "the loss should keep falling after the restart"
    print("elastic restart OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

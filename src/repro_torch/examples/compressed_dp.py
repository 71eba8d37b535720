"""The int8-compressed data-parallel gradient reduce (JAX
``examples/compressed_dp.py``) over a 2-rank data mesh:

    python -m repro_torch.examples.compressed_dp            # on the card
    python -m repro_torch.examples.compressed_dp --device cpu

Each rank takes the smoke tinyllama-1.1b's gradient on its half of a
batch of 4 x 32 tokens, then means it over "data" twice: the fp32
all-reduce (``compress.psum_mean``) and the int8 one
(``compress.compressed_psum_mean``). It asserts JAX's bound, every leaf
within 1/254 + 1e-3 of its largest |entry| over the ranks (the entry the
int8 scale is taken from), and prints the bytes each handed to the
collectives.
"""
from __future__ import annotations

import argparse
import sys


def _rank(mesh) -> dict:
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline, stage
    from repro_torch.models import ModelOptions, init_params, loss_fn
    from repro_torch.optim import compress
    from repro_torch.sharding import ArchSharding, comm

    cfg = get_config("tinyllama-1.1b").smoke()
    opts = ModelOptions(attn_impl="ref", scan_impl="ref", dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=mesh.device)
                         .manual_seed(0), mesh.device)
    pipe = Pipeline(cfg, DataConfig(global_batch=4, seq_len=32))
    specs = ArchSharding(cfg, mesh).train_batch_specs(4)
    batch = stage(pipe.batch_at(0), mesh.device, specs, mesh)
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = loss_fn(tree.unflatten(params, live), batch, cfg, opts)
    grads = tree.unflatten(params, torch.autograd.grad(loss, live))
    data = mesh.comm("data")
    comm.reset_traffic()
    g_fp32 = compress.psum_mean(grads, data)
    fp32 = comm.traffic()
    comm.reset_traffic()
    g_int8 = compress.compressed_psum_mean(grads, data)
    int8 = comm.traffic()
    # the quantization step is the ranks' largest |entry| / 127 a leaf, so
    # the error is bounded against that max (with one rank, as in JAX's
    # one-device example, it is the mean's own max)
    errs = [float((a - b).abs().max())
            / (float(data.max_(g.abs().max().reshape(1))) or 1.0)
            for a, b, g in zip(tree.leaves(g_fp32), tree.leaves(g_int8),
                               tree.leaves(grads))]
    return {"leaves": len(errs), "max_rel_err": max(errs),
            "bytes_fp32": fp32, "bytes_int8": int8}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from repro_torch.launch.mesh import spawn
    ranks = spawn(_rank, "2,1", args.device)
    bound = 1 / 254 + 1e-3
    for r, got in enumerate(ranks):
        print(f"rank {r}: leaves={got['leaves']} max relative error="
              f"{got['max_rel_err']:.4%} (bound {bound:.4%}); bytes to the "
              f"collectives fp32 {got['bytes_fp32']}, int8 "
              f"{got['bytes_int8']}", flush=True)
        assert got["max_rel_err"] <= bound, got
    print("compressed data-parallel reduce OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

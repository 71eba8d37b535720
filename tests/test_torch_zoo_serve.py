"""The serving engine over the model zoo's remainder, inside the port, at
smoke size on the CPU.

Identity, as in tests/test_torch_serve.py and test_torch_paging.py: on
h2o-danube-1.8b-smoke (window 16) with prompts longer than the window, the
slotted engine's greedy streams equal each request run alone through
prefill + one-token decode, token for token; on the qwen2-7b,
mistral-large-123b, mixtral-8x7b and kimi-k2-1t-a32b smokes the paged
engine's streams equal the slotted engine's. The MoE smokes are made
dropless (capacity factor 8), as test_torch_paging.py's: capacity is per
routing group and the backends group an admission differently. The two
models whose requests are not token ids alone, musicgen-medium (frame
embeddings) and llama-3.2-vision-11b (a cross-attention context), are
refused with ``ValueError``, as JAX's engine refuses them.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import L3_NSS, LinkageConfig, preset  # noqa: E402
from repro_torch.models import (ModelOptions, decode_step,  # noqa: E402
                                init_params, prefill)
from repro_torch.serve import ServeEngine, synthetic_requests  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48


def _smoke(name):
    cfg = get_config(name).smoke()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _streams(cfg, params, linkage, reqs, opts=OPTS, **kw):
    eng = ServeEngine(cfg, params, opts, linkage, n_slots=2, max_len=MAX_LEN,
                      **kw)
    comps, _ = eng.run(reqs, load="closed")
    assert len(comps) == len(reqs)
    assert all(len(c.tokens) == r.max_new_tokens
               for c, r in zip(sorted(comps, key=lambda c: c.rid), reqs))
    return {c.rid: c.tokens.tolist() for c in comps}


def _sequential(cfg, params, req):
    logits, cache = prefill(params, torch.from_numpy(req.prompt)[None], cfg,
                            OPTS, max_len=MAX_LEN)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out = [int(nxt[0])]
    for _ in range(req.max_new_tokens - 1):
        logits, cache = decode_step(params, cache, nxt, cfg, OPTS)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        out.append(int(nxt[0]))
    return out


def test_sliding_window_slotted_matches_sequential():
    """danube's smoke, window 16: 5 requests of 20-token prompts (past the
    window: admission rolls the circular buffer) and 7 new tokens over 2
    slots, L3 programs of 3 microsteps; every slot is re-admitted."""
    cfg, params = _smoke("h2o-danube-1.8b")
    assert cfg.sliding_window == 16
    lk = LinkageConfig(level=L3_NSS, ret_async=True, decode_steps=3)
    reqs = synthetic_requests(5, prompt_len=20, max_new_tokens=7,
                              vocab_size=cfg.vocab_size, seed=3)
    got = _streams(cfg, params, lk, reqs)
    for req in reqs:
        assert got[req.rid] == _sequential(cfg, params, req), req.rid


@pytest.mark.parametrize("name", ["qwen2-7b", "mistral-large-123b",
                                  "mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_paged_matches_slotted(name):
    """4 requests sharing an 8-token prefix over blocks of 8, the shortcut
    preset (the kernels' plain versions on the CPU), L3 programs of 4:
    paged == slotted, token for token."""
    cfg, params = _smoke(name)
    lk = dataclasses.replace(preset("nss_shortcut"), decode_steps=4)
    opts = lk.model_options(OPTS)
    reqs = synthetic_requests(4, prompt_len=14, max_new_tokens=6,
                              vocab_size=cfg.vocab_size, seed=4,
                              shared_prefix_len=8)
    slotted = _streams(cfg, params, lk, reqs, opts)
    paged = _streams(cfg, params, lk, reqs, opts, kv="paged", block_size=8)
    assert paged == slotted


@pytest.mark.parametrize("name,match", [("musicgen-medium", "embeddings"),
                                        ("llama-3.2-vision-11b", "xctx")])
def test_engine_refuses_models_without_token_requests(name, match):
    """Both backends refuse them, and so do the launcher's engine run, its
    sequential baseline (``--load seq``) and the fleet's launcher."""
    from repro_torch.launch.fleet import run_fleet_engine
    from repro_torch.launch.serve import run_engine, run_server
    cfg = get_config(name).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for kv in ("slotted", "paged"):
        with pytest.raises(ValueError, match=match):
            ServeEngine(cfg, params, OPTS, preset("byp"), n_slots=2,
                        max_len=MAX_LEN, kv=kv)
    for run in (run_engine, run_server, run_fleet_engine):
        with pytest.raises(ValueError, match=match):
            run(name, "byp", requests=1, prompt_len=4, gen_len=2,
                device="cpu")

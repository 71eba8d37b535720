"""Swap preemption inside the port, on the CPU at smoke size: token streams
bit for bit (ROADMAP's parity bar), as tests/test_paging.py and
tests/test_serve.py hold the JAX engine.

Under a pool far smaller than the worst case: swap == recompute ==
sequential, two-phase paged, greedy over three presets and sampled
(temperature 0.8, top-k 40); the synchronous tier path == the async one;
``--victim lru``; swapped victims resume in admission order (against
JAX's scheduler on the same sequence); chunked swap with a victim
mid-prefill; speculative decoding with a swap mid-generation; int8 and
fp8 swap == the unpressured run (== recompute where no radix hit changes
the re-admission's prefill), moving ``_block_bytes`` a block at JAX's
compressed / raw ratio.

Where JAX's twin of a case is flaky or failing (ROADMAP §3: R3
``test_swap_vs_recompute_identity[nss_shortcut]``, R6
``test_spec_swap_preemption_mid_generation``, R7
``test_quantized_swap_moves_compressed_bytes``) the port is held to its
own invariant: its swap and recompute streams equal each other (and the
sequential reference where the JAX test asks for it) and, over quantized
blocks, the swapped stream equals the unpressured one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import L3_NSS, SamplingConfig, preset  # noqa: E402
from repro_torch.models import (ModelOptions, decode_step,  # noqa: E402
                                init_params, prefill)
from repro_torch.serve import (PreemptionPolicy, Request,  # noqa: E402
                               ServeEngine, SlotScheduler, synthetic_requests)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48
PRESSURE = dict(n_slots=3, block_size=4, num_blocks=9)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def sequential_tokens(params, req, opts=OPTS):
    """Reference: the request alone, prefill + one-token decode loop."""
    logits, cache = prefill(params, torch.from_numpy(req.prompt)[None], CFG,
                            opts, max_len=MAX_LEN)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out = [int(nxt[0])]
    for _ in range(req.max_new_tokens - 1):
        logits, cache = decode_step(params, cache, nxt, CFG, opts)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        out.append(int(nxt[0]))
    return out


def linkage(preset_name):
    lk = preset(preset_name)
    if lk.level == L3_NSS:
        # short fused programs so three decoding slots overlap under the
        # pressure geometry
        lk = dataclasses.replace(lk, decode_steps=4)
    return lk, (lk.model_options(OPTS) if lk.shortcut else OPTS)


def streams(params, reqs, lk, opts, **kw):
    eng = ServeEngine(CFG, params, opts, lk, max_len=MAX_LEN, kv="paged",
                      **kw)
    comps, _ = eng.run(reqs, load="closed")
    assert len(comps) == len(reqs)
    return {c.rid: c.tokens.tolist() for c in comps}, eng


def pressure_reqs(n=4, prompt_len=8, max_new=12, seed=3):
    return synthetic_requests(n, prompt_len=prompt_len,
                              max_new_tokens=max_new,
                              vocab_size=CFG.vocab_size, seed=seed)


def _swapped_and_back(eng):
    assert eng.swap_preemptions > 0
    assert eng.swap_resumes == eng.swap_preemptions
    u = eng.utilization()
    assert u["kv_swap_out_blocks"] > 0 and u["kv_swap_in_blocks"] > 0
    assert u["kv_host_bytes_moved"] == (
        u["kv_swap_out_blocks"] + u["kv_swap_in_blocks"]
        + u["kv_prefix_demotions"] + u["kv_prefix_promotions"]
    ) * u["kv_bytes_per_block"]
    # nothing is left held by a handle: only demoted prefixes stay
    assert eng.kv.host.n_resident == len(eng.kv.host_map)


@pytest.mark.parametrize("preset_name",
                         ["base", "nss_shortcut", "ret_byp_shortcut"])
def test_swap_vs_recompute_identity(params, preset_name):
    """Greedy streams under swap preemption equal recompute's and the
    sequential reference; blocks went out and came back."""
    lk, opts = linkage(preset_name)
    reqs = pressure_reqs()
    rec, eng_r = streams(params, reqs, lk, opts, preempt="recompute",
                         **PRESSURE)
    swp, eng_s = streams(params, reqs, lk, opts, preempt="swap", **PRESSURE)
    assert swp == rec
    assert eng_r.preemptions > 0 and eng_s.preemptions == 0
    _swapped_and_back(eng_s)
    for req in reqs:
        assert swp[req.rid] == sequential_tokens(params, req, opts), req.rid


def test_sampled_swap_vs_recompute_identity(params):
    """Sampled at temperature 0.8, top-k 40: a swapped slot resumes with its
    own key chain (a copy taken at swap-out; the live rows move on), so its
    stream equals the recompute engine's, whose re-admission replays the
    chain from the request key."""
    lk, opts = linkage("nss_shortcut")
    sc = SamplingConfig(temperature=0.8, top_k=40, seed=7)
    reqs = pressure_reqs(n=5, max_new=14, seed=11)
    rec, _ = streams(params, reqs, lk, opts, preempt="recompute",
                     sampling=sc, **PRESSURE)
    swp, eng = streams(params, reqs, lk, opts, preempt="swap", sampling=sc,
                       **PRESSURE)
    greedy, _ = streams(params, reqs, lk, opts, preempt="swap", **PRESSURE)
    assert swp == rec and swp != greedy
    _swapped_and_back(eng)


def test_sync_swap_equals_async(params):
    """The synchronous tier path (``--sync-swap``) and the async stream
    with prefetch give the same streams and move the same blocks; only
    the async one drains transfers and prefetches."""
    lk, opts = linkage("nss_shortcut")
    reqs = pressure_reqs()
    a, ea = streams(params, reqs, lk, opts, preempt="swap", **PRESSURE)
    s, es = streams(params, reqs, lk, opts, preempt="swap",
                    async_swap=False, **PRESSURE)
    assert a == s
    ua, us = ea.utilization(), es.utilization()
    for k in ("kv_swap_out_blocks", "kv_swap_in_blocks",
              "kv_host_bytes_moved", "kv_prefix_demotions"):
        assert ua[k] == us[k], k
    assert ua["kv_async_swap"] == 1 and us["kv_async_swap"] == 0
    assert ua["kv_stream_transfers"] > 0 and us["kv_stream_transfers"] == 0
    assert ua["kv_prefetch_hits"] > 0 and us["kv_prefetch_issued"] == 0


def test_swap_lru_victim_identity(params):
    """The LRU victim policy preempts other slots; every stream still
    matches the sequential reference."""
    lk, opts = linkage("base")
    reqs = pressure_reqs()
    got, eng = streams(params, reqs, lk, opts,
                       preempt=PreemptionPolicy(mode="swap", victim="lru"),
                       **PRESSURE)
    assert eng.swap_preemptions > 0
    for req in reqs:
        assert got[req.rid] == sequential_tokens(params, req), req.rid


def test_swapped_victims_resume_in_admission_order():
    """Under LRU, parking order inverts admission order; ``resume_next``
    pops by original ``admit_seq`` (tests/test_paging.py:639), as JAX's
    scheduler does on the same sequence."""
    from repro.serve import SlotScheduler as JSched
    logs = []
    for Sched in (SlotScheduler, JSched):
        sched, log = Sched(3), []
        for rid in range(3):
            sched.enqueue(Request(rid=rid, prompt=np.zeros(4, np.int32),
                                  max_new_tokens=4))
        slots = {}
        for rid in range(3):
            slot, _ = sched.admit_next(float(rid))
            slots[rid] = slot
        for rid in range(3):
            sched.active[slots[rid]].note_emit(10.0 + rid)
        for tag in ("handle-0", "handle-1"):
            v = sched.choose_victim("lru")
            log.append(sched.active[v].req.rid)
            sched.suspend_front(sched.release(v), tag)
        log.append([st.req.rid for st, _ in sched.swapped])
        log.append(sched.peek_swapped()[0].req.rid)
        while sched.can_resume():
            slot, st, handle = sched.resume_next()
            log.append((slot, st.req.rid, handle, st.admit_seq))
        log.append((sorted(sched.active), len(sched.swapped)))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][:4] == [0, 1, [1, 0], 0]


def test_chunked_swap_mid_prefill(params):
    """Chunked engine under pool pressure: a victim is mid-prefill (its
    partly landed chunks swap out with the chain, its prompt rides the
    handle); streams equal the chunked recompute engine's and the
    sequential reference (tests/test_paging.py:601)."""
    reqs = pressure_reqs(prompt_len=12, max_new=10)
    kw = dict(n_slots=3, block_size=4, num_blocks=11, chunked=True,
              chunk_budget=5)
    lk, opts = linkage("byp")
    rec, _ = streams(params, reqs, lk, opts, **kw)
    eng = ServeEngine(CFG, params, opts, lk, max_len=MAX_LEN, kv="paged",
                      preempt="swap", **kw)
    mid, orig = [], eng._preempt

    def spy(slot):
        mid.append(eng.sched.active[slot].prefilling)
        orig(slot)
    eng._preempt = spy
    swp = {c.rid: c.tokens.tolist() for c in eng.run(reqs, load="closed")[0]}
    assert swp == rec and any(mid)
    _swapped_and_back(eng)
    for req in reqs:
        assert swp[req.rid] == sequential_tokens(params, req), req.rid


def test_spec_swap_mid_generation(params):
    """Speculative decoding with swap preemption: a victim's drafts die
    with it, the resumed slot re-drafts from its restored history, and the
    streams equal the plain swap engine's (tests/test_serve.py:813, R6
    in JAX)."""
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=np.tile(
                rng.integers(0, CFG.vocab_size, 4, dtype=np.int32), 2),
                    max_new_tokens=12) for i in range(4)]
    lk, opts = linkage("nss_shortcut")
    want, _ = streams(params, reqs, lk, opts, preempt="swap", **PRESSURE)
    got, eng = streams(params, reqs, lk, opts, preempt="swap",
                       spec_decode="ngram", spec_width=4, **PRESSURE)
    assert got == want
    _swapped_and_back(eng)
    assert eng.utilization()["spec_steps"] > 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_swap_vs_recompute(params, kv_dtype):
    """Quantized blocks cross the tiers as raw codes with their scales, so a
    swapped stream is the one the request gets with no pressure at all;
    with prompts shorter than a block (no radix hit on re-admission)
    recompute replays the same writes and swap == recompute == sync ==
    async. Every block moved costs ``_block_bytes`` and the raw counter
    sits at the compressed / raw ratio (>= 1.9x; R7 in JAX). With
    block-aligned prompts a recompute victim re-admits through a suffix
    prefill over the *dequantized* prefix, which differs from the exact
    prefill by design (tests/test_paging.py:1157), while swap still equals
    the unpressured run."""
    lk, opts = linkage("nss_shortcut")
    kw = dict(n_slots=2, block_size=8, kv_dtype=kv_dtype)
    press = dict(kw, num_blocks=5, host_blocks=12)
    for prompt_len in (6, 8):
        reqs = pressure_reqs(prompt_len=prompt_len)
        free, _ = streams(params, reqs, lk, opts, **kw)
        got, eng = streams(params, reqs, lk, opts, preempt="swap", **press)
        sync, _ = streams(params, reqs, lk, opts, preempt="swap",
                          async_swap=False, **press)
        assert got == sync == free
        _swapped_and_back(eng)
        if prompt_len == 6:
            rec, eng_r = streams(params, reqs, lk, opts,
                                 preempt="recompute", **press)
            assert rec == got and eng_r.preemptions > 0
        u = eng.utilization()
        blocks = u["kv_host_bytes_moved"] // u["kv_bytes_per_block"]
        assert u["kv_host_bytes_moved_raw"] == (blocks
                                                * eng.kv._raw_block_bytes)
        assert u["kv_host_bytes_moved_raw"] >= 1.9 * u["kv_host_bytes_moved"]

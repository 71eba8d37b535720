"""Slotted chunked prefill and n-gram speculative decoding in the port on
the CPU, against the JAX package, and their engine invariants.

Model (teacher-forced, the weights carried over by ``params_from_jax``):
``serve_chunk_step`` (slotted), ``serve_verify_step`` and
``serve_verify_step_paged`` against JAX's — logits at atol 1e-4, the
caches (``k``, ``v``, ``slot_pos``, ``pos``; the pools) at 1e-4 and the
positions exactly — the paged pass also through the shortcut options (the
paged prefill kernel's plain version) against JAX's Pallas
``paged_prefill`` in interpret mode. ``build_verify_step`` against JAX's
on greedy: the emitted tokens, ``n_emit``, the keys and the repaired
positions equal. ``DraftProposer`` against JAX's over random histories:
identical drafts and counters.

Engine invariants (tests/test_serve.py:365-435 and :690-891, held to the
port's own streams, bit for bit on the CPU): chunked slotted == two-phase
slotted == sequential at L2 and at L3 + RET, the circular-wrap regression,
admission never stalling decode; speculative == plain on both backends
under ``base`` and ``nss_shortcut`` with drafts accepted, width 1 == plain,
speculation over the chunked engine, CoW-shared prefixes, sampled key
chains independent of the schedule, and an EOS inside an accepted window
(on a workload whose windows put the EOS there; the reference's own
version of that test does not hold on its model).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import (L3_NSS, LinkageConfig,  # noqa: E402
                              SamplingConfig, build_verify_step, preset)
from repro_torch.models import (ModelOptions, decode_step,  # noqa: E402
                                init_params, prefill, serve_chunk_step,
                                serve_verify_step, serve_verify_step_paged)
from repro_torch.serve import (DraftProposer, Request,  # noqa: E402
                               ServeEngine, SlotState, synthetic_requests)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
KERN = preset("nss_shortcut").model_options(OPTS)
MAX_LEN = 48


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def model():
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    jcfg = jget("tinyllama-1.1b").smoke()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _jopts(impl="ref"):
    from repro.models import ModelOptions as JOpts
    return JOpts(attn_impl=impl, scan_impl="ref", dtype=jnp.float32)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the chunk and verify passes against JAX's
# ---------------------------------------------------------------------------

def _prefilled(jcfg, jp, toks):
    """JAX prefill of ``toks`` (B, S): per-layer K/V (L, B, T, HKV, dh)."""
    from repro.models import prefill as jprefill
    _, cj = jprefill(jp, jnp.asarray(toks), jcfg, _jopts(), max_len=MAX_LEN)
    return np.asarray(cj[0]["k"]), np.asarray(cj[0]["v"])


def _slot_caches(k, v, n_res):
    """Slot caches holding the first ``n_res[b]`` positions of row b as
    live entries; the K/V past them stays in place, marked stale
    (slot_pos -1). Returns (JAX's stacked group, the port's per-layer)."""
    L, B, T = k.shape[:3]
    sp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(n_res):
        sp[b, :n] = np.arange(n)
    pos = np.asarray(n_res, np.int32)
    jc = ({"k": jnp.asarray(k), "v": jnp.asarray(v),
           "slot_pos": jnp.asarray(np.tile(sp, (L, 1, 1))),
           "pos": jnp.asarray(np.tile(pos, (L, 1)))},)
    tc = [{"k": torch.from_numpy(k[l].copy()),
           "v": torch.from_numpy(v[l].copy()),
           "slot_pos": torch.from_numpy(sp.copy()),
           "pos": torch.from_numpy(pos.copy())} for l in range(L)]
    return jc, tc


def _assert_slot_caches(tc, jc):
    for l, g in enumerate(tc):
        _close(g["k"], jc[0]["k"][l])
        _close(g["v"], jc[0]["v"][l])
        np.testing.assert_array_equal(g["slot_pos"].numpy(),
                                      jc[0]["slot_pos"][l])
        np.testing.assert_array_equal(g["pos"].numpy(), jc[0]["pos"][l])


def test_serve_chunk_step_matches_jax(model):
    """Three rows: a fresh 7-token chunk over a reset row (a previous
    tenant's 10 entries), 5 tokens at position 8 over 8 live entries, and
    a row with no chunk. Logits at each row's last chunk position and the
    whole slot cache agree with JAX's."""
    from repro.models import serve_chunk_step as jchunk
    jcfg, jp, tp = model
    rng = np.random.default_rng(1)
    full = rng.integers(0, CFG.vocab_size, (3, 13), dtype=np.int32)
    k, v = _prefilled(jcfg, jp, full)
    start = np.array([0, 8, 10], np.int32)
    clen = np.array([7, 5, 0], np.int32)
    reset = np.array([True, False, False])
    chunk = np.zeros((3, 7), np.int32)
    chunk[0], chunk[1, :5] = full[0, :7], full[1, 8:13]
    jc, tc = _slot_caches(k, v, (10, 8, 10))
    lj, jc = jchunk(jp, jc, *map(jnp.asarray, (chunk, start, clen, reset)),
                    jcfg, _jopts())
    for opts in (OPTS, KERN):
        caches = [{n: t.clone() for n, t in g.items()} for g in tc]
        lt, caches = serve_chunk_step(tp, caches, *map(torch.from_numpy, (
            chunk, start, clen, reset)), CFG, opts)
        _close(lt[:2], np.asarray(lj)[:2])
        _assert_slot_caches(caches, jc)
        assert caches[0]["pos"].tolist() == [7, 13, 10]


W = 4


def _verify_rows(rng):
    """Four verify rows over resident lengths 9, 13, 6, 11: clen 4, 2 and 1
    (a width-1 row is a decode step) and an inactive row (clen 0)."""
    full = rng.integers(0, CFG.vocab_size, (4, 13), dtype=np.int32)
    n_res = (9, 13, 6, 11)
    toks = rng.integers(0, CFG.vocab_size, (4, W)).astype(np.int32)
    clen = np.array([4, 2, 1, 0], np.int32)
    toks[np.arange(W)[None] >= clen[:, None]] = 0
    return full, n_res, toks, np.asarray(n_res, np.int32), clen


def test_serve_verify_step_matches_jax(model):
    """Logits at every fed position (B, W, V) and the slot cache after the
    write-then-attend pass agree with JAX's."""
    from repro.models import serve_verify_step as jverify
    jcfg, jp, tp = model
    full, n_res, toks, start, clen = _verify_rows(np.random.default_rng(2))
    k, v = _prefilled(jcfg, jp, full)
    jc, tc = _slot_caches(k, v, n_res)
    lj, jc = jverify(jp, jc, *map(jnp.asarray, (toks, start, clen)), jcfg,
                     _jopts())
    assert lj.shape == (4, W, CFG.vocab_size)
    for opts in (OPTS, KERN):
        caches = [{n: t.clone() for n, t in g.items()} for g in tc]
        lt, caches = serve_verify_step(tp, caches, *map(torch.from_numpy, (
            toks, start, clen)), CFG, opts)
        _close(lt, lj)
        _assert_slot_caches(caches, jc)


def _paged_caches(k, v, n_res, bs, tables):
    """The first ``n_res[b]`` positions of row b in pools (L, P+1, bs,
    HKV, dh) through ``tables``."""
    L, P = k.shape[0], tables.size
    kp = np.zeros((L, P + 1, bs) + k.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    for b, n in enumerate(n_res):
        for p in range(n):
            kp[:, tables[b, p // bs], p % bs] = k[:, b, p]
            vp[:, tables[b, p // bs], p % bs] = v[:, b, p]
    pos = np.asarray(n_res, np.int32)
    jc = ({"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
           "pos": jnp.asarray(np.tile(pos, (L, 1)))},)
    tc = [{"kp": torch.from_numpy(kp[l].copy()),
           "vp": torch.from_numpy(vp[l].copy()),
           "pos": torch.from_numpy(pos.copy())} for l in range(L)]
    return jc, tc


def test_serve_verify_step_paged_matches_jax(model):
    """The paged verify pass through permuted tables: the port's plain path
    and its shortcut (the paged prefill kernel's plain version) against
    JAX's ref path and its Pallas ``paged_prefill`` in interpret mode."""
    from repro.models import serve_verify_step_paged as jverify
    jcfg, jp, tp = model
    rng = np.random.default_rng(3)
    full, n_res, toks, start, clen = _verify_rows(rng)
    bs, nb = 8, MAX_LEN // 8
    tables = rng.permutation(4 * nb)[:4 * nb].reshape(4, nb).astype(np.int32)
    k, v = _prefilled(jcfg, jp, full)
    jc0, tc = _paged_caches(k, v, n_res, bs, tables)
    args = (toks, tables, start, clen)
    for jimpl in ("ref", "pallas"):
        lj, jc = jverify(jp, jc0, *map(jnp.asarray, args), jcfg,
                         _jopts(jimpl), MAX_LEN)
        for opts in (OPTS, KERN):
            caches = [{n: t.clone() for n, t in g.items()} for g in tc]
            lt, caches = serve_verify_step_paged(
                tp, caches, *map(torch.from_numpy, args), CFG, opts, MAX_LEN)
            _close(lt, lj)
            for l, g in enumerate(caches):
                _close(g["kp"][:-1], jc[0]["kp"][l][:-1])  # trash row aside
                np.testing.assert_array_equal(g["pos"].numpy(),
                                              jc[0]["pos"][l])


@pytest.mark.parametrize("kv_kind", ["slotted", "paged"])
def test_build_verify_step_matches_jax(model, kv_kind):
    """Greedy verify with drafts taken from the model's own continuation:
    row 0 accepts all three, row 1 none, row 2 one of two, row 3 is
    inactive. The emitted tokens, n_emit, the keys (unchanged on greedy)
    and the repaired positions equal JAX's."""
    from repro.core import build_verify_step as jbuild
    from repro.core import preset as jpreset
    from repro.models import serve_verify_step as jv
    from repro.models import serve_verify_step_paged as jvp
    jcfg, jp, tp = model
    rng = np.random.default_rng(4)
    full = rng.integers(0, CFG.vocab_size, (4, 13), dtype=np.int32)
    n_res = (9, 13, 6, 11)
    start = np.asarray(n_res, np.int32)
    k, v = _prefilled(jcfg, jp, full)
    bs, nb = 8, MAX_LEN // 8
    tables = rng.permutation(4 * nb)[:4 * nb].reshape(4, nb).astype(np.int32)
    if kv_kind == "paged":
        jc, tc = _paged_caches(k, v, n_res, bs, tables)
        jpass = lambda t, c: jvp(jp, jc, jnp.asarray(t),  # noqa: E731
                                 jnp.asarray(tables), jnp.asarray(start),
                                 jnp.asarray(c), jcfg, _jopts(), MAX_LEN)[0]
        extra = (tables,)
    else:
        jc, tc = _slot_caches(k, v, n_res)
        jpass = lambda t, c: jv(jp, jc, jnp.asarray(t),  # noqa: E731
                                jnp.asarray(start), jnp.asarray(c), jcfg,
                                _jopts())[0]
        extra = ()
    # the model's greedy continuation after each row's committed token
    cont = np.zeros((4, W), np.int32)
    cont[:, 0] = rng.integers(0, CFG.vocab_size, 4)
    for j in range(1, W):
        lg = jpass(cont, np.full(4, W, np.int32))
        cont[:, j] = np.asarray(jnp.argmax(lg[:, j - 1], -1))
    toks = cont.copy()
    toks[1, 1] = (cont[1, 1] + 1) % CFG.vocab_size     # row 1 rejects d1
    toks[2, 2] = (cont[2, 2] + 1) % CFG.vocab_size     # row 2 rejects d2
    clen = np.array([4, 2, 3, 0], np.int32)
    vmask = clen > 0
    toks[np.arange(W)[None] >= clen[:, None]] = 0
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(1), r))
                     for r in range(4)])
    jfn = jbuild(jcfg, _jopts(), jpreset("base"), MAX_LEN, kv_kind=kv_kind)
    jout = jfn(jp, jc, *map(jnp.asarray, (toks, clen, start, vmask, keys)),
               *map(jnp.asarray, extra))
    tfn = build_verify_step(CFG, OPTS, preset("base"), MAX_LEN,
                            kv_kind=kv_kind)
    cache, out, n_emit, tkeys = tfn(
        tp, tc, *map(torch.from_numpy, (toks, clen, start, vmask)),
        torch.from_numpy(keys.astype(np.int64)),
        *map(torch.from_numpy, extra))
    jcache, jo, jn, jk = jout
    assert n_emit.tolist() == [4, 1, 2, 0] == np.asarray(jn).tolist()
    valid = np.arange(W)[None] < np.asarray(jn)[:, None]
    np.testing.assert_array_equal(out.numpy()[valid], np.asarray(jo)[valid])
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jk))
    for l, g in enumerate(cache):
        np.testing.assert_array_equal(g["pos"].numpy(), jcache[0]["pos"][l])
        if kv_kind == "slotted":
            np.testing.assert_array_equal(g["slot_pos"].numpy(),
                                          jcache[0]["slot_pos"][l])
    assert cache[0]["pos"].tolist() == [13, 14, 8, 11]
    assert tc[0]["pos"].tolist() == list(n_res)     # L1: functional


# ---------------------------------------------------------------------------
# DraftProposer against JAX's
# ---------------------------------------------------------------------------

def _slot(mod, prompt, chunks, max_new, eos_id, eos_seen):
    st = mod.SlotState(req=mod.Request(rid=0, prompt=prompt,
                                       max_new_tokens=max_new,
                                       eos_id=eos_id), admit_s=0.0)
    st.chunks = [np.asarray(c, np.int32) for c in chunks]
    st.produced = sum(len(c) for c in chunks)
    st.eos_seen = eos_seen
    return st


def test_draft_proposer_matches_jax():
    """Random histories over small vocabularies (so n-grams recur), EOS ids
    that land inside drafts, widths 1-6, n-gram orders 1-4 and budgets down
    to one token: the same drafts, and the same counters after."""
    from repro.serve import scheduler as jsched
    from repro_torch.serve import scheduler as tsched
    rng = np.random.default_rng(0)
    props = {m: {} for m in (tsched, jsched)}
    hits = eos_cut = 0
    for case in range(400):
        vocab = int(rng.integers(2, 9))
        prompt = rng.integers(0, vocab, int(rng.integers(1, 14)),
                              dtype=np.int32)
        chunks = [rng.integers(0, vocab, int(rng.integers(1, 4)),
                               dtype=np.int32)
                  for _ in range(int(rng.integers(0, 4)))]
        produced = sum(len(c) for c in chunks)
        max_new = produced + int(rng.integers(1, 6))
        eos = int(rng.integers(0, vocab)) if rng.random() < 0.5 else None
        width, ngram = int(rng.integers(1, 7)), int(rng.integers(1, 5))
        eos_seen = bool(rng.random() < 0.05)
        got = []
        for mod in (tsched, jsched):
            p = props[mod].setdefault((width, ngram),
                                      mod.DraftProposer(width, ngram))
            got.append(p.propose(_slot(mod, prompt, chunks, max_new, eos,
                                       eos_seen)))
        np.testing.assert_array_equal(got[0], got[1])
        assert got[0].dtype == np.int32
        hits += got[0].size > 0
        eos_cut += eos is not None and eos in got[0][:-1].tolist()
    for key, p in props[tsched].items():
        q = props[jsched][key]
        assert (p.proposed_tokens, p.lookups, p.hits) == (
            q.proposed_tokens, q.lookups, q.hits)
    assert hits > 100 and eos_cut == 0
    for mod in (tsched, jsched):
        with pytest.raises(ValueError):
            mod.DraftProposer(0)
        with pytest.raises(ValueError):
            mod.DraftProposer(4, ngram=0)


def test_draft_proposer_reads_device_chunks():
    """Under RET a slot's chunks stay tensors; the proposer reads them."""
    st = SlotState(req=Request(rid=0, prompt=np.array([1, 2, 3, 1, 2],
                                                      np.int32),
                               max_new_tokens=8), admit_s=0.0)
    st.chunks = [torch.tensor([3], dtype=torch.int32)]
    st.produced = 1
    assert DraftProposer(4).propose(st).tolist() == [1, 2, 3]


# ---------------------------------------------------------------------------
# engine invariants: chunked slotted prefill
# ---------------------------------------------------------------------------

def sequential_tokens(params, req, max_len=MAX_LEN):
    """Reference: the request alone, prefill + one-token decode loop."""
    logits, cache = prefill(params, torch.from_numpy(req.prompt)[None], CFG,
                            OPTS, max_len=max_len)
    out = [int(logits.argmax(-1))]
    for _ in range(req.max_new_tokens - 1):
        logits, cache = decode_step(
            params, cache, torch.tensor(out[-1:], dtype=torch.int32), CFG,
            OPTS)
        out.append(int(logits.argmax(-1)))
    return out


def streams(params, reqs, linkage=None, *, n_slots=2, max_len=MAX_LEN,
            opts=OPTS, **kw):
    eng = ServeEngine(CFG, params, opts, linkage or preset("byp"),
                      n_slots=n_slots, max_len=max_len, **kw)
    comps, _ = eng.run(reqs, load="closed")
    assert len(comps) == len(reqs)
    return {c.rid: c.tokens.tolist() for c in comps}, eng


def test_chunked_slotted_matches_two_phase_and_sequential(params):
    """A budget smaller than every prompt (admission over several steps)
    with slot reuse, at L2 and at L3 + RET with chunks narrower than K:
    chunked slotted == two-phase slotted == sequential."""
    reqs = synthetic_requests(5, prompt_len=11, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=0)
    two_phase, _ = streams(params, reqs)
    got, eng = streams(params, reqs, chunked=True, chunk_budget=5)
    assert got == two_phase
    for req in reqs:
        assert got[req.rid] == sequential_tokens(params, req), req.rid
    assert eng.prefill_tokens == sum(int(r.prompt.shape[0]) for r in reqs)
    assert eng.utilization()["step_mode"] == "chunked"
    lk = LinkageConfig(level=L3_NSS, ret_async=True, decode_steps=3)
    for budget in (2, 6):       # chunks of 2 are narrower than K
        got, _ = streams(params, reqs, lk, chunked=True, chunk_budget=budget)
        assert got == two_phase, budget


def test_chunked_slotted_circular_wrap_regression(params):
    """K = 20 microsteps on rows of 24: rows outside the decode mask keep
    their cache bit-exact through the scan, or a garbage write at pos % T
    would wrap over resident prompt K/V (pos + K > T)."""
    lk = LinkageConfig(level=L3_NSS, ret_async=True, decode_steps=20)
    reqs = synthetic_requests(3, prompt_len=12, max_new_tokens=8,
                              vocab_size=CFG.vocab_size, seed=0,
                              shared_prefix_len=6)
    got, _ = streams(params, reqs, lk, max_len=24, chunked=True,
                     chunk_budget=6)
    for req in reqs:
        assert got[req.rid] == sequential_tokens(params, req, 24), req.rid


def test_chunked_slotted_admission_never_stalls_decode(params):
    """While a long prompt enters chunk by chunk, the admitted slot keeps
    producing tokens in the same programs."""
    long_p = synthetic_requests(1, prompt_len=32, max_new_tokens=2,
                                vocab_size=CFG.vocab_size, seed=5)[0]
    short = dataclasses.replace(synthetic_requests(
        1, prompt_len=4, max_new_tokens=12, vocab_size=CFG.vocab_size,
        seed=6)[0], rid=1)
    got, eng = streams(params, [short, long_p], chunked=True, chunk_budget=8)
    for req in (short, long_p):
        assert got[req.rid] == sequential_tokens(params, req)
    u = eng.utilization()
    assert u["prefill_tokens"] == 36 and u["decode_tokens"] >= 12
    assert eng.programs_run < 32 + 12


# ---------------------------------------------------------------------------
# engine invariants: speculative decoding
# ---------------------------------------------------------------------------

def spec_reqs(n=4, core_len=6, reps=3, max_new=14, seed=5, eos_id=None):
    """Prompts tiling a random core n-gram (tests/test_serve.py:690), so
    prompt lookup drafts hit and greedy continuations repeat the period."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=np.tile(rng.integers(
        0, CFG.vocab_size, core_len, dtype=np.int32), reps),
        max_new_tokens=max_new, eos_id=eos_id) for i in range(n)]


def spec_linkage(preset_name):
    """At the preset's K = 32 these budgets finish in one plain program
    before any draft history exists: programs of 3 let speculation
    engage."""
    lk = preset(preset_name)
    if lk.level == L3_NSS:
        lk = dataclasses.replace(lk, decode_steps=3)
    return lk, lk.model_options(OPTS)


def spec_vs_plain(params, reqs, preset_name, kv, *, spec_width=6, **kw):
    lk, opts = spec_linkage(preset_name)
    if kv == "paged":
        kw.setdefault("block_size", 8)
    want, _ = streams(params, reqs, lk, opts=opts, kv=kv, **kw)
    got, eng = streams(params, reqs, lk, opts=opts, kv=kv,
                       spec_decode="ngram", spec_width=spec_width, **kw)
    return got, want, eng


@pytest.mark.parametrize("preset_name", ["base", "nss_shortcut"])
@pytest.mark.parametrize("kv", ["slotted", "paged"])
def test_spec_matches_plain(params, preset_name, kv):
    """Greedy speculative streams equal plain decode's, with speculation
    engaged and drafts accepted; under ``nss_shortcut`` the paged verify
    pass runs the paged prefill kernel's plain version."""
    reqs = spec_reqs()
    got, want, eng = spec_vs_plain(params, reqs, preset_name, kv)
    assert got == want
    u = eng.utilization()
    assert u["spec_steps"] > 0 and u["spec_accepted_tokens"] > 0
    assert u["spec_acceptance_rate"] > 0.3
    assert u["spec_draft_tokens"] == (u["spec_accepted_tokens"]
                                      + u["spec_wasted_tokens"])
    if preset_name == "base":
        for req in reqs:
            assert got[req.rid] == sequential_tokens(params, req), req.rid


def test_spec_width_one_is_plain_decode(params):
    """Width 1 leaves no room to draft: every step is plain decode."""
    got, want, eng = spec_vs_plain(params, spec_reqs(n=2), "base", "slotted",
                                   spec_width=1)
    assert got == want
    u = eng.utilization()
    assert u["spec_steps"] == 0 and u["spec_draft_tokens"] == 0


def test_spec_over_the_chunked_engine(params):
    """The chunked engine's pure-decode steps defer to the verify step, on
    both backends: one engine serves chunked prefill and speculation."""
    reqs = spec_reqs()
    lk, opts = spec_linkage("byp")
    for kv, kw in (("paged", dict(block_size=8)), ("slotted", {})):
        want, _ = streams(params, reqs, lk, kv=kv, chunked=True,
                          chunk_budget=8, **kw)
        got, eng = streams(params, reqs, lk, kv=kv, chunked=True,
                           chunk_budget=8, spec_decode="ngram",
                           spec_width=6, **kw)
        assert got == want, kv
        assert eng.utilization()["spec_steps"] > 0, kv


def test_spec_cow_shared_prefix(params):
    """Requests sharing a radix-indexed prefix verify and roll back without
    freeing a block the other sharers hold."""
    rng = np.random.default_rng(9)
    shared = np.tile(rng.integers(0, CFG.vocab_size, 4, dtype=np.int32), 4)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, CFG.vocab_size, 2, np.int32)]),
        max_new_tokens=12) for i in range(4)]
    got, want, eng = spec_vs_plain(params, reqs, "base", "paged")
    assert got == want
    u = eng.utilization()
    assert u["spec_steps"] > 0 and u["kv_prefix_shared_tokens"] > 0
    kv = eng.kv
    assert kv.pool.n_resident == len(kv.index)   # every chain returned


def test_spec_trace_records_verify_windows(params):
    """The trace holds one schema-valid ``verify_window`` event per verify
    row, its accepted counts summing to the engine's counter, and the
    metrics count the speculative tokens."""
    from repro_torch.serve import Telemetry
    from repro_torch.serve.telemetry import validate_events, validate_spans
    tel = Telemetry(trace=True)
    lk, _ = spec_linkage("byp")
    _, eng = streams(params, spec_reqs(n=2), lk, spec_decode="ngram",
                     spec_width=6, telemetry=tel)
    events = tel.trace.events
    validate_events(events)
    validate_spans(events)
    windows = [e for e in events if e["type"] == "verify_window"]
    u = eng.utilization()
    assert windows and sum(e["args"]["accepted"] for e in windows) == u[
        "spec_accepted_tokens"]
    assert any(e["type"] == "engine_step" and e["args"]["kind"] == "verify"
               for e in events)
    assert 'spec_tokens_total{kind="accepted"}' in tel.metrics.render()


def test_spec_sampled_key_chains_schedule_independent(params):
    """Sampled verify advances a chain once per emitted token: the streams
    equal plain sampled decode's on both backends."""
    sc = SamplingConfig(temperature=0.7, top_k=16, seed=42)
    reqs = spec_reqs(n=3, max_new=8)
    lk, _ = spec_linkage("byp")
    want, _ = streams(params, reqs, lk, sampling=sc)
    for kv, kw in (("slotted", {}), ("paged", dict(block_size=8))):
        got, eng = streams(params, reqs, lk, kv=kv, sampling=sc,
                           spec_decode="ngram", spec_width=6, **kw)
        assert got == want, kv
        assert eng.utilization()["spec_steps"] > 0, kv
    greedy, _ = streams(params, reqs, lk)
    assert want != greedy                        # it actually sampled


def _windows(eng, rid):
    """Record ``rid``'s verify windows: (the stream index of the window's
    first token, the tokens the verify step emitted), in order."""
    seen, verify = [], eng.kv.verify_step

    def spy(tokens, clen, start, vmask):
        out, n = verify(tokens, clen, start, vmask)
        for s, st in eng.sched.active.items():
            if st.req.rid == rid:
                seen.append((st.produced, out[s, :int(n[s])].tolist()))
        return out, n
    eng.kv.verify_step = spy
    return seen


def test_spec_eos_inside_accepted_window(params):
    """An EOS that a verify step accepts as a draft, with more accepted
    tokens after it in the same window, finishes the request at the EOS:
    the stream is the plain stream cut after it, the window's tail
    dropped. The workload makes that happen: rid 0's prompt is a random
    head plus the first 8 tokens of the model's own greedy stream after
    it, so it decodes the rest of that stream, and prompt lookup drafts
    the stream's next tokens from its first verify step on. The EOS is the
    first occurrence of a token the no-EOS run accepted so."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, CFG.vocab_size, 6, dtype=np.int32)
    own = sequential_tokens(params, Request(rid=0, prompt=head,
                                            max_new_tokens=8))
    reqs = [Request(rid=0, prompt=np.concatenate(
        [head, np.asarray(own, np.int32)]), max_new_tokens=12)]
    reqs += spec_reqs(n=2, max_new=12)[1:]
    lk, opts = spec_linkage("base")
    eng = ServeEngine(CFG, params, opts, lk, n_slots=2, max_len=MAX_LEN,
                      kv="paged", block_size=8, spec_decode="ngram",
                      spec_width=6)
    windows = _windows(eng, 0)
    plain = {c.rid: c.tokens.tolist()
             for c in eng.run(reqs, load="closed")[0]}[0]
    inside = [(at + j, t) for at, win in windows for j, t in enumerate(win)
              if 1 <= j < len(win) - 1 and plain.index(t) == at + j]
    assert inside, f"no accepted first occurrence in {windows}"
    stop_at, eos = inside[0]
    reqs_eos = [dataclasses.replace(reqs[0], eos_id=eos)] + reqs[1:]
    got, want, eng = spec_vs_plain(params, reqs_eos, "base", "paged")
    assert got == want
    assert got[0] == plain[:stop_at + 1] and len(got[0]) < len(plain)
    u = eng.utilization()
    assert u["spec_steps"] > 0 and u["spec_accepted_tokens"] > 0
    assert u["tokens_wasted"] > 0                # the window's tail dropped

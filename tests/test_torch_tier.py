"""The port's host KV tier on the CPU, at smoke size, against the JAX
package.

Allocator and stream: ``HostBlockStore`` (ids, refcounts, LRU ticks, hwm)
against JAX's on one seeded operation sequence; block and chain write /
read roundtrips in fp32, bf16, int8 and fp8 with scales, bit for bit
against JAX's store; the deterministic ``SwapStream`` differential of
tests/test_paging.py:929 inside the port, and its write order equal to
JAX's ``SwapStream`` on the same sequence.

Block programs: ``export_chain`` / ``import_chain`` against JAX's
``build_chain_export_fn`` / ``build_chain_import_fn`` on the same pools
(a two-position ``block_pattern``: port layer ``i`` is group ``i % 2``,
row ``i // 2``), plain and quantized, bit for bit; ``_block_bytes``,
``_raw_block_bytes`` and ``_fingerprint`` equal JAX's.

Tier behaviour inside the port: demotion and promotion, a warm-start
restart serving the same streams, fingerprint and ``kv_dtype`` mismatches,
``drop_swap``, the tier counters of one swap workload equal to JAX's, the
``BudgetTuner`` against JAX's, the tuned engine, and the trace of a swap
run (schema, ``swapped`` transitions, ``swap_fail``).

Interchange: a prefix file saved by the JAX engine restores into the port
(entries, tokens and block contents bit for bit) and one the port saves
restores into JAX, fp32 / int8 / fp8 blocks; a port engine warm-started
from JAX's file gives teacher-forced logits within 1e-4 (the engine
tolerance of test_torch_paging.py) of JAX's engine warm-started from the
same file.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN, DENSE, LayerSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import SamplingConfig, preset  # noqa: E402
from repro_torch.kernels.kv_quant import raw  # noqa: E402
from repro_torch.models import (ModelOptions, decode_step_paged,  # noqa: E402
                                init_params)
from repro_torch.serve import (BlockPool, Request, ServeEngine,  # noqa: E402
                               Telemetry, synthetic_requests)
from repro_torch.serve.paging import (HostBlockStore, SwapStream,  # noqa: E402
                                      export_chain, import_chain)
from repro_torch.serve.scheduler import BudgetTuner  # noqa: E402
from repro_torch.serve.telemetry import (validate_events,  # noqa: E402
                                         validate_spans)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
# two pattern positions, two blocks of them: four layers, L = 2 a group
CFG2 = dataclasses.replace(CFG, block_pattern=(LayerSpec(ATTN, DENSE),) * 2)
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48
KINDS = ("fp32", "bf16", "int8", "fp8")


def _jnp():
    import jax.numpy as jnp
    return jnp


def _jopts(dtype="float32"):
    from repro.models import ModelOptions as JOpts
    return JOpts(attn_impl="ref", scan_impl="ref",
                 dtype=getattr(_jnp(), dtype))


def _jcfg2():
    from repro.configs import get_config as jget
    from repro.configs.base import LayerSpec as JSpec
    return dataclasses.replace(jget("tinyllama-1.1b").smoke(),
                               block_pattern=(JSpec(),) * 2)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def model2():
    """JAX parameters of the two-position config and the port's copy."""
    import jax
    from repro.models import init_params as jinit
    jcfg = _jcfg2()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _bits(a) -> np.ndarray:
    """The raw bytes of a torch tensor or numpy array, for exact
    comparison (NaN payloads and fp8 codes included)."""
    if isinstance(a, torch.Tensor):
        return raw(a.contiguous()).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def _codes(kind, shape, rng):
    """A torch tensor and a numpy array (JAX's dtype) of the same bits."""
    jnp = _jnp()
    if kind == "int8":
        a = rng.integers(-127, 128, shape).astype(np.int8)
        return torch.from_numpy(a.copy()), a
    if kind == "fp8":
        u = rng.integers(0, 256, shape).astype(np.uint8)
        return (torch.from_numpy(u.copy()).view(torch.float8_e4m3fn),
                u.view(np.dtype(jnp.float8_e4m3fn)))
    a = rng.standard_normal(shape).astype(np.float32)
    if kind == "fp32":
        return torch.from_numpy(a.copy()), a
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, t.view(torch.int16).numpy().view(np.dtype(jnp.bfloat16))


TDT = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
       "fp8": torch.float8_e4m3fn}


def _jdt(kind):
    return np.dtype({"fp32": np.float32, "bf16": _jnp().bfloat16,
                     "int8": np.int8, "fp8": _jnp().float8_e4m3fn}[kind])


# ---------------------------------------------------------------------------
# HostBlockStore and SwapStream against the JAX package's
# ---------------------------------------------------------------------------

def test_host_block_store_matches_jax():
    """A seeded mix of alloc / retain / free / touch on both packages'
    allocator-only stores: the same ids, results, refcounts, LRU ticks and
    high-watermark after every operation."""
    from repro.serve.paging import HostBlockStore as JStore
    logs = []
    for Store in (HostBlockStore, JStore):
        rng = np.random.default_rng(11)
        st, held, log = Store(6, block_size=4), [], []
        for op in rng.integers(0, 4, size=400):
            if op == 0:
                b = st.alloc()
                log.append(("alloc", b))
                if b is not None:
                    held.append(b)
            elif op == 1 and held:
                b = held[int(rng.integers(len(held)))]
                st.retain(b)
                held.append(b)
            elif op == 2 and held:
                b = held.pop(int(rng.integers(len(held))))
                log.append(("free", b, st.free(b)))
            elif op == 3 and held:
                st.touch(held[int(rng.integers(len(held)))])
            log.append((st.n_free, st.hwm, st.refs.tolist(),
                        st.tick.tolist()))
        logs.append(log)
    assert logs[0] == logs[1]
    st = HostBlockStore(2, block_size=4)
    b = st.alloc()
    st.free(b)
    with pytest.raises(ValueError, match="double free"):
        st.free(b)


@pytest.mark.parametrize("kind", KINDS)
def test_host_block_store_roundtrip_matches_jax(kind):
    """Block and chain writes and reads in the store's storage dtype (fp8
    codes and their f32 scales included) against JAX's store fed the same
    bits: every read equal bit for bit, reads are copies, and a chain read
    into pinnable staging equals the fancy-indexed JAX read."""
    from repro.serve.paging import HostBlockStore as JStore
    L, bs, HKV, dh, H = 2, 4, 3, 8, 5
    quant = kind in ("int8", "fp8")
    rng = np.random.default_rng(KINDS.index(kind))
    shapes = [(L, bs, HKV, dh)] * 2
    sshapes = [(L, HKV)] * 2 if quant else None
    tst = HostBlockStore(H, bs, group_shapes=shapes, dtype=TDT[kind],
                         scale_shapes=sshapes)
    jst = JStore(H, bs, group_shapes=shapes, dtype=_jdt(kind),
                 scale_shapes=sshapes)

    def kvs(n):
        shape = (L,) if n is None else (L, n)
        tk, jk = [], []
        for _ in range(2):
            t, j = {}, {}
            for name in ("k", "v"):
                t[name], j[name] = _codes(kind, shape + (bs, HKV, dh), rng)
            if quant:
                for name in ("ks", "vs"):
                    s = rng.random(shape + (HKV,)).astype(np.float32)
                    t[name], j[name] = torch.from_numpy(s.copy()), s
            tk.append(t)
            jk.append(j)
        return tuple(tk), tuple(jk)

    hs = [tst.alloc() for _ in range(3)]
    assert hs == [jst.alloc() for _ in range(3)]
    one_t, one_j = kvs(None)
    tst.write(hs[0], one_t)
    jst.write(hs[0], one_j)
    chain_t, chain_j = kvs(2)
    tst.write_chain([hs[2], hs[1]], chain_t)
    jst.write_chain([hs[2], hs[1]], chain_j)
    for got, want in ((tst.read(hs[0]), jst.read(hs[0])),
                      (tst.read_chain([hs[1], hs[0], hs[2]]),
                       jst.read_chain([hs[1], hs[0], hs[2]]))):
        for g in range(2):
            assert set(got[g]) == set(want[g])
            for name in want[g]:
                assert got[g][name].dtype == TDT[kind] or name in ("ks",
                                                                  "vs")
                np.testing.assert_array_equal(_bits(got[g][name]),
                                              _bits(want[g][name]))
    back = tst.read(hs[0])
    raw(back[0]["k"]).zero_()                       # reads are copies
    np.testing.assert_array_equal(_bits(tst.read(hs[0])[0]["k"]),
                                  _bits(one_j[0]["k"]))


def _stream_log(BlockPool_, HostBlockStore_, SwapStream_, leaf):
    """tests/test_paging.py:929's seeded admit / async swap-out / prefetch
    / drop / swap-in / finish / drain sequence through one package's
    classes, asserting the drain discipline (every deferred write lands
    exactly once, on a still-referenced host block; draining moves no
    refcount; both pools exact). Returns the order of the writes."""
    rng = np.random.default_rng(13)
    N, H = 8, 5
    pool = BlockPool_(N, block_size=4)
    host = HostBlockStore_(H, block_size=4)
    refs, hrefs = {}, {}
    chains, swapped = {}, {}
    prefetched, pending, landed = set(), set(), set()
    nid = [0]
    writes = []

    def write(hblks, kvs):
        writes.append(list(hblks))
        for h in hblks:
            assert h in pending, "write landed twice or unissued"
            pending.discard(h)
            assert hrefs.get(h, 0) == 1, "write landed on a freed block"
            landed.add(h)

    stream = SwapStream_(write, depth=2)

    def drain():
        before = (dict(refs), dict(hrefs))
        stream.drain()
        assert not pending and before == (refs, hrefs)

    def alloc():
        blk = pool.alloc()
        if blk is not None:
            refs[blk] = 1
        return blk

    def drop(blk):
        pool.free(blk)
        refs[blk] -= 1
        if refs[blk] == 0:
            del refs[blk]

    for op in rng.integers(0, 6, size=500):
        if op == 0:                                    # admit
            chain = []
            for _ in range(int(rng.integers(1, 4))):
                blk = alloc()
                if blk is None:
                    break
                chain.append(blk)
            if chain:
                chains[nid[0]] = chain
                nid[0] += 1
        elif op == 1 and chains:                       # async swap-out
            slot = sorted(chains)[int(rng.integers(len(chains)))]
            hblks, ok = [], True
            for _ in chains[slot]:
                h = host.alloc()
                if h is None:
                    for hb in hblks:
                        host.free(hb)
                        del hrefs[hb]
                    ok = False
                    break
                hrefs[h] = 1
                hblks.append(h)
            if ok:
                pending.update(hblks)
                stream.issue(hblks, ({"k": leaf(), "v": leaf()},),
                             len(hblks) * 16)
                for b in chains.pop(slot):
                    drop(b)
                swapped[nid[0]] = hblks
                nid[0] += 1
        elif op == 2 and swapped:                      # prefetch resume head
            tag = min(swapped)
            drain()
            assert all(h in landed for h in swapped[tag])
            prefetched.add(tag)
        elif op == 3 and swapped:                      # drop (2nd preemption)
            tag = sorted(swapped)[int(rng.integers(len(swapped)))]
            drain()
            prefetched.discard(tag)
            for h in swapped.pop(tag):
                host.free(h)
                del hrefs[h]
                landed.discard(h)
        elif op == 4 and swapped:                      # swap-in (resume)
            tag = sorted(swapped)[int(rng.integers(len(swapped)))]
            dblks, ok = [], True
            for _ in swapped[tag]:
                b = alloc()
                if b is None:
                    for db in dblks:
                        drop(db)
                    ok = False
                    break
                dblks.append(b)
            if ok:
                drain()
                prefetched.discard(tag)
                for h in swapped.pop(tag):
                    assert h in landed
                    host.free(h)
                    del hrefs[h]
                    landed.discard(h)
                chains[nid[0]] = dblks
                nid[0] += 1
        elif op == 5 and chains:                       # finish
            slot = sorted(chains)[int(rng.integers(len(chains)))]
            for b in chains.pop(slot):
                drop(b)
        assert len(stream) <= 2
        for h in pending:
            assert hrefs.get(h, 0) == 1
        assert prefetched <= set(swapped)
        for blk in range(N):
            assert pool.refs[blk] == refs.get(blk, 0), blk
        assert pool.n_free == N - len(refs)
        for blk in range(H):
            assert host.refs[blk] == hrefs.get(blk, 0), blk
        assert host.n_free == H - len(hrefs)
    drain()
    for slot in sorted(chains):
        for b in chains[slot]:
            drop(b)
    assert pool.n_free == N and (pool.refs == 0).all()
    return writes


def test_swap_stream_differential_matches_jax():
    """The deterministic SwapStream differential inside the port (a CPU
    stream completes at the drain or past depth 2), and the same sequence
    on JAX's SwapStream writes the same host blocks in the same order."""
    from repro.serve import paging as jp
    got = _stream_log(BlockPool, HostBlockStore, SwapStream,
                      lambda: torch.zeros(1))
    want = _stream_log(jp.BlockPool, jp.HostBlockStore, jp.SwapStream,
                       lambda: np.zeros(1, np.float32))
    assert got == want and len(got) > 20


# ---------------------------------------------------------------------------
# chain export / import against JAX's programs
# ---------------------------------------------------------------------------

def _pools(kind, rng, L, P1, bs, HKV, dh):
    """Per-group pools in both layouts: JAX (L, P+1, ...) stacked, the port
    one dict per layer (layer i = group i % 2, row i // 2)."""
    quant = kind in ("int8", "fp8")
    jc, groups = [], []
    for _ in range(2):
        g, gj = {}, {}
        for name in ("kp", "vp"):
            g[name], gj[name] = _codes(kind, (L, P1, bs, HKV, dh), rng)
        if quant:
            for name in ("ks", "vs"):
                s = rng.random((L, P1, HKV)).astype(np.float32)
                g[name], gj[name] = torch.from_numpy(s.copy()), s
        groups.append(g)
        jc.append(gj)
    tc = []
    for row in range(L):
        for g in groups:
            tc.append({n: t[row].clone() for n, t in g.items()})
    return tc, jc


@pytest.mark.parametrize("kind", KINDS)
def test_chain_export_import_match_jax(kind):
    """``export_chain`` equals JAX's ``build_chain_export_fn`` on the same
    pools (a permuted chain), bit for bit, and ``import_chain`` of that
    export into other blocks leaves the pools equal to JAX's
    ``build_chain_import_fn``'s, codes and scales whole; the trash row and
    blocks outside the chain keep their bytes."""
    jnp = _jnp()
    from repro.core.step import build_chain_export_fn, build_chain_import_fn
    L, P1, bs, HKV, dh = 2, 7, 4, 3, 8
    rng = np.random.default_rng(40 + KINDS.index(kind))
    tc, jc = _pools(kind, rng, L, P1, bs, HKV, dh)
    jcache = tuple({n: jnp.asarray(a) for n, a in g.items()} for g in jc)
    src, dst = [4, 0, 2], [5, 1, 3]
    got = export_chain(tc, torch.tensor(src), 2)
    want = build_chain_export_fn()(jcache, jnp.asarray(src, jnp.int32))
    for g in range(2):
        assert set(got[g]) == set(want[g])
        for name in want[g]:
            assert got[g][name].shape == tuple(want[g][name].shape)
            np.testing.assert_array_equal(_bits(got[g][name]),
                                          _bits(np.asarray(want[g][name])))
    import_chain(tc, got, torch.tensor(dst))
    jout = build_chain_import_fn()(jcache, want, jnp.asarray(dst, jnp.int32))
    for i, layer in enumerate(tc):
        g, row = i % 2, i // 2
        for name in layer:
            np.testing.assert_array_equal(
                _bits(layer[name]), _bits(np.asarray(jout[g][name][row])))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_bytes_and_fingerprint_match_jax(model2, kv_dtype, dtype):
    """``_block_bytes``, ``_raw_block_bytes`` and the ``_fingerprint``
    string (``"dtype"``: float32 or bfloat16) equal JAX's for fp32 and
    bf16 engines over bf16, int8 and fp8 blocks."""
    from repro.core import preset as jpreset
    from repro.serve.paging import PagedKV as JPaged
    from repro_torch.serve.paging import PagedKV
    jcfg, jp, tp = model2
    kw = dict(block_size=8, kv_dtype=kv_dtype, host_blocks=None)
    jkv = JPaged(jcfg, jp, _jopts(dtype), jpreset("byp"), 2, MAX_LEN, **kw)
    tkv = PagedKV(CFG2, tp, ModelOptions(attn_impl="ref",
                                         dtype=getattr(torch, dtype)),
                  preset("byp"), 2, MAX_LEN, **kw)
    assert tkv._block_bytes == jkv._block_bytes
    assert tkv._raw_block_bytes == jkv._raw_block_bytes
    assert tkv._fingerprint() == jkv._fingerprint()
    assert f'"dtype": "{dtype}"' in tkv._fingerprint()
    assert tkv.host.num_blocks == jkv.host.num_blocks


# ---------------------------------------------------------------------------
# tier behaviour inside the port
# ---------------------------------------------------------------------------

def test_prefix_demote_promote_roundtrip(params):
    """Index eviction under pool pressure demotes a block to the host tier
    instead of dropping it; a later admission of the same prompt promotes
    it back and shares it (tests/test_paging.py:699)."""
    vocab = CFG.vocab_size
    pa = (np.arange(16, dtype=np.int32) * 7 + 1) % vocab
    pb = (np.arange(16, dtype=np.int32) * 11 + 3) % vocab
    reqs = [Request(rid=0, prompt=pa, max_new_tokens=4),
            Request(rid=1, prompt=pb, max_new_tokens=4),
            Request(rid=2, prompt=pa.copy(), max_new_tokens=4)]
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=1,
                      max_len=MAX_LEN, kv="paged", block_size=8,
                      num_blocks=4, host_blocks=8)
    comps, _ = eng.run(reqs, load="closed")
    got = {c.rid: c.tokens.tolist() for c in comps}
    assert got[2] == got[0]
    u = eng.utilization()
    assert u["kv_prefix_demotions"] > 0
    assert u["kv_prefix_promotions"] > 0
    assert u["kv_prefix_shared_tokens"] == 15


def _warm_reqs():
    return synthetic_requests(4, prompt_len=24, max_new_tokens=5,
                              vocab_size=CFG.vocab_size, seed=7,
                              shared_prefix_len=16)


def test_prefix_cache_warm_start_restart(params, tmp_path):
    """A restarted engine warm-started from the saved cache serves the same
    streams, sharing P-1 tokens of every persisted prompt, with promotions
    (tests/test_paging.py:721)."""
    reqs = _warm_reqs()
    kw = dict(n_slots=2, max_len=MAX_LEN, kv="paged", block_size=8)
    eng1 = ServeEngine(CFG, params, OPTS, preset("byp"), **kw)
    got1 = {c.rid: c.tokens.tolist()
            for c in eng1.run(reqs, load="closed")[0]}
    path = str(tmp_path / "prefix.npz")
    assert eng1.save_prefix_cache(path) > 0
    eng2 = ServeEngine(CFG, params, OPTS, preset("byp"), warm_start=path,
                       **kw)
    assert eng2.kv.restored_entries > 0
    got2 = {c.rid: c.tokens.tolist()
            for c in eng2.run(reqs, load="closed")[0]}
    assert got2 == got1
    u = eng2.utilization()
    assert u["kv_prefix_shared_tokens"] == 23 * 4
    assert u["kv_prefix_promotions"] > 0


def test_warm_start_mismatches_raise(params, tmp_path):
    """A file saved under another geometry (block size) or another
    ``kv_dtype`` raises ``ValueError``, and the slotted backend refuses a
    warm start, as in JAX."""
    reqs = synthetic_requests(2, prompt_len=16, max_new_tokens=3,
                              vocab_size=CFG.vocab_size, seed=1)
    kw = dict(n_slots=2, max_len=MAX_LEN, kv="paged", block_size=8)
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), **kw)
    eng.run(reqs, load="closed")
    path = str(tmp_path / "prefix.npz")
    assert eng.save_prefix_cache(path) > 0
    for bad in (dict(kw, block_size=4), dict(kw, kv_dtype="int8")):
        with pytest.raises(ValueError, match="different config"):
            ServeEngine(CFG, params, OPTS, preset("byp"), warm_start=path,
                        **bad)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=2,
                    max_len=MAX_LEN, warm_start=path)


def test_drop_swap_makes_handle_unresumable(params):
    """``drop_swap`` returns every host block once, is idempotent, and a
    later ``swap_in`` on the handle raises (tests/test_paging.py:676)."""
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=2,
                      max_len=MAX_LEN, kv="paged", block_size=8,
                      num_blocks=6, preempt="swap", host_blocks=6)
    prompt = (np.arange(16, dtype=np.int32) * 5 + 2) % CFG.vocab_size
    eng.sched.enqueue(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng._admit(lambda: 0.0)
    handle = eng.kv.swap_out(0)
    assert handle is not None and len(handle.hblks) == 2
    assert eng.kv.prefetch_swap_in(handle)
    free_before = eng.kv.host.n_free
    eng.kv.drop_swap(handle)
    assert handle.dropped and handle.hblks == [] and handle.prefetch is None
    assert eng.kv.host.n_free == free_before + 2
    assert eng.kv.prefetch_cancels == 1
    with pytest.raises(RuntimeError, match="drop_swap"):
        eng.kv.swap_in(1, handle)
    eng.kv.drop_swap(handle)
    assert eng.kv.host.n_free == free_before + 2


PRESSURE = dict(n_slots=3, block_size=4, num_blocks=9)


def test_tier_counters_match_jax(model2):
    """One swap workload under pool pressure (with shared prefixes, so
    demotions and promotions happen too) through both engines: the
    schedule is host logic, so every tier counter of the reports agrees,
    and the report's keys are JAX's."""
    from repro.core import preset as jpreset
    from repro.serve import ServeEngine as JEngine, serve_report as jreport
    from repro_torch.serve import serve_report
    jcfg, jp, tp = model2
    reqs = synthetic_requests(5, prompt_len=12, max_new_tokens=10,
                              vocab_size=CFG.vocab_size, seed=3,
                              shared_prefix_len=8)
    kw = dict(max_len=MAX_LEN, kv="paged", preempt="swap", **PRESSURE)
    jeng = JEngine(jcfg, jp, _jopts(), jpreset("byp"), **kw)
    teng = ServeEngine(CFG2, tp, OPTS, preset("byp"), **kw)
    jrep = jreport(*jeng.run(reqs, load="closed"), jeng.utilization())
    trep = serve_report(*teng.run(reqs, load="closed"), teng.utilization())
    assert set(trep) == set(jrep)
    keys = ["swap_preemptions", "swap_resumes", "preemptions",
            "programs_run"] + [k for k in jrep if k.startswith("kv_")
                               and k != "kv_bytes_per_shard"
                               and k != "kv_hwm_bytes_per_shard"]
    assert {k: trep[k] for k in keys} == {k: jrep[k] for k in keys}
    assert trep["swap_preemptions"] > 0 and trep["kv_prefix_demotions"] > 0


def test_budget_tuner_matches_jax():
    """The AIMD tuner against JAX's on one seeded TTFT sequence: the same
    budget after every observation and the same adjustment count."""
    from repro.serve.scheduler import BudgetTuner as JTuner
    rng = np.random.default_rng(9)
    ttfts = rng.exponential(0.1, size=200)
    kw = dict(slo_s=0.1, budget=48, floor=4, cap=224)
    a, b = BudgetTuner(**kw), JTuner(**kw)
    assert [a.observe(t) for t in ttfts] == [b.observe(t) for t in ttfts]
    assert a.adjustments == b.adjustments > 10


def test_engine_ttft_slo_tunes_budget(params):
    """An SLO no run meets drives the budget up; the knob is scheduling
    only, so the streams equal the untuned engine's; without chunked it
    raises (tests/test_serve.py:664)."""
    reqs = synthetic_requests(4, prompt_len=12, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=7)
    kw = dict(n_slots=2, max_len=MAX_LEN, kv="paged", block_size=8,
              chunked=True, chunk_budget=4)
    base = ServeEngine(CFG, params, OPTS, preset("byp"), **kw)
    want = {c.rid: c.tokens.tolist()
            for c in base.run(reqs, load="closed")[0]}
    tel = Telemetry()
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), ttft_slo_s=1e-9,
                      telemetry=tel, **kw)
    got = {c.rid: c.tokens.tolist() for c in eng.run(reqs, load="closed")[0]}
    assert got == want
    assert eng.chunk_budget > 4 and eng.tuner.adjustments > 0
    u = eng.utilization()
    assert u["budget_adjustments"] == eng.tuner.adjustments
    assert u["ttft_slo_s"] == 1e-9
    assert any(e["type"] == "budget" for e in tel.trace.events)
    with pytest.raises(ValueError, match="chunked"):
        ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=2,
                    max_len=MAX_LEN, ttft_slo_s=0.1)


def test_trace_of_a_swap_run(params):
    """A chunked swap run's trace validates against the schema, its spans
    pass through ``swapped`` and back, tier moves carry real sizes, every
    deferred transfer is completed by a drain, and prefetches are staged
    (tests/test_telemetry.py:246)."""
    import dataclasses as dc
    lk = dc.replace(preset("nss_shortcut"), decode_steps=4)
    opts = lk.model_options(OPTS)
    reqs = synthetic_requests(4, prompt_len=8, max_new_tokens=12,
                              vocab_size=CFG.vocab_size, seed=0)
    tel = Telemetry()
    eng = ServeEngine(CFG, params, opts, lk, n_slots=2, max_len=32,
                      kv="paged", block_size=8, num_blocks=4,
                      preempt="swap", chunked=True, chunk_budget=6,
                      telemetry=tel)
    eng.run(reqs, load="closed")
    assert eng.swap_preemptions > 0
    evs = tel.trace.events
    validate_events(evs)
    paths = validate_spans(evs)
    assert any("swapped" in p for p in paths.values())
    outs = [e for e in evs if e["type"] == "swap_out"]
    ins = [e for e in evs if e["type"] == "swap_in"]
    assert outs and ins
    assert all(e["args"]["blocks"] > 0 and e["args"]["bytes"] > 0
               for e in outs + ins)
    snap = tel.metrics.snapshot()
    assert snap['kv_tier_blocks_total{op="swap_out"}'] \
        == eng.kv.swap_out_blocks
    streams = [e for e in evs if e["type"] == "swap_stream"]
    assert sum(e["args"]["transfers"] for e in streams) \
        == eng.kv.stream_transfers > 0
    pf = [e for e in evs if e["type"] == "prefetch"]
    assert any(e["args"]["status"] == "issued" for e in pf)
    assert eng.kv.prefetch_hits + eng.kv.prefetch_cancels \
        <= eng.kv.prefetch_issued


def test_swap_fail_event_and_counter(params):
    """A host tier too small for a victim's chain fails the swap-out
    mid-chain: ``swap_fail`` fires for each, its counter counts them, the
    engine falls back to recompute, and the spans stay legal
    (tests/test_telemetry.py:286)."""
    import dataclasses as dc
    lk = dc.replace(preset("nss_shortcut"), decode_steps=4)
    opts = lk.model_options(OPTS)
    reqs = synthetic_requests(4, prompt_len=16, max_new_tokens=12,
                              vocab_size=CFG.vocab_size, seed=0)
    tel = Telemetry()
    eng = ServeEngine(CFG, params, opts, lk, n_slots=2, max_len=32,
                      kv="paged", block_size=8, num_blocks=5,
                      preempt="swap", host_blocks=1, chunked=True,
                      chunk_budget=24, telemetry=tel)
    comps, _ = eng.run(reqs, load="closed")
    assert len(comps) == 4
    fails = [e for e in tel.trace.events if e["type"] == "swap_fail"]
    assert fails
    assert all(e["args"]["op"] == "swap_out" and e["args"]["blocks"] > 0
               for e in fails)
    assert eng.kv.swap_fails == len(fails) and eng.preemptions > 0
    assert tel.metrics.snapshot()['kv_swap_failures_total{op="swap_out"}'] \
        == len(fails)
    validate_spans(tel.trace.events)


# ---------------------------------------------------------------------------
# prefix files between the packages
# ---------------------------------------------------------------------------

def _entries(path):
    """{token bytes: {(field, group): array}} of a prefix file."""
    with np.load(path) as d:
        out = {}
        for i in range(int(d["n"])):
            out[d[f"tok_{i}"].astype(np.int32).tobytes()] = {
                (f, g): d[f"{f}_{i}_{g}"] for g in range(2)
                for f in ("k", "v", "ks", "vs") if f"{f}_{i}_{g}" in d}
        return str(d["fingerprint"]), out


def _assert_store_holds(read, host_map, entries, kv_dtype):
    assert set(host_map) == set(entries)
    for key, arrays in entries.items():
        got = read(host_map[key])
        for (f, g), a in arrays.items():
            t = got[g][f]
            if kv_dtype == "bf16" and f in ("k", "v"):
                np.testing.assert_array_equal(
                    np.asarray(t, np.float32) if not isinstance(
                        t, torch.Tensor) else t.float().numpy(), a)
            else:
                np.testing.assert_array_equal(_bits(t), _bits(a))


def _prefix_reqs():
    return synthetic_requests(3, prompt_len=20, max_new_tokens=3,
                              vocab_size=CFG.vocab_size, seed=4,
                              shared_prefix_len=8)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_prefix_files_pass_between_packages(model2, kv_dtype, tmp_path):
    """The JAX engine's saved prefix cache restores into the port (the same
    fingerprint, entries and tokens, block contents bit for bit), and the
    port's saved cache restores into JAX, over fp32 / int8 / fp8 blocks on
    the two-position config (groups 0 and 1 in the file)."""
    from repro.core import preset as jpreset
    from repro.serve import ServeEngine as JEngine
    jcfg, jp, tp = model2
    kw = dict(n_slots=2, max_len=MAX_LEN, kv="paged", block_size=8,
              kv_dtype=kv_dtype)
    reqs = _prefix_reqs()
    jeng = JEngine(jcfg, jp, _jopts(), jpreset("byp"), **kw)
    jeng.run(reqs, load="closed")
    jpath = str(tmp_path / "jax.npz")
    n = jeng.save_prefix_cache(jpath)
    assert n > 0
    fp, entries = _entries(jpath)
    assert set(k for k, _ in next(iter(entries.values()))) >= {"k", "v"}
    teng = ServeEngine(CFG2, tp, OPTS, preset("byp"), warm_start=jpath,
                       **kw)
    assert teng.kv._fingerprint() == fp
    assert teng.kv.restored_entries == n
    _assert_store_holds(teng.kv.host.read, teng.kv.host_map, entries,
                        kv_dtype)

    teng2 = ServeEngine(CFG2, tp, OPTS, preset("byp"), **kw)
    teng2.run(reqs, load="closed")
    tpath = str(tmp_path / "port.npz")
    n2 = teng2.save_prefix_cache(tpath)
    assert n2 > 0
    _, tentries = _entries(tpath)
    for key, arrays in tentries.items():      # the layout JAX writes
        for (f, g), a in arrays.items():
            want = entries.get(key, {}).get((f, g))
            if want is not None:
                assert a.dtype == want.dtype and a.shape == want.shape
    jeng2 = JEngine(jcfg, jp, _jopts(), jpreset("byp"), warm_start=tpath,
                    **kw)
    assert jeng2.kv.restored_entries == n2
    _assert_store_holds(jeng2.kv.host.read, jeng2.kv.host_map, tentries,
                        kv_dtype)


def test_warm_start_from_jax_file_teacher_forced(model2, tmp_path):
    """JAX's engine and the port's, each warm-started from the file JAX's
    engine saved, admit a persisted prompt: both promote the same blocks
    (tables equal), the admission logits (a suffix prefill over the
    promoted prefix) agree within 1e-4, and so do 4 decode steps fed the
    same tokens over the engines' pools."""
    jnp = _jnp()
    from repro.core import SamplingConfig as JSampling, preset as jpreset
    from repro.models import decode_step_paged as jdecode
    from repro.serve import ServeEngine as JEngine
    jcfg, jp, tp = model2
    kw = dict(n_slots=1, max_len=MAX_LEN, kv="paged", block_size=8)
    reqs = _prefix_reqs()
    jeng = JEngine(jcfg, jp, _jopts(), jpreset("byp"), **kw)
    jeng.run(reqs, load="closed")
    path = str(tmp_path / "jax.npz")
    assert jeng.save_prefix_cache(path) > 0
    jkv = JEngine(jcfg, jp, _jopts(), jpreset("byp"), warm_start=path,
                  **kw).kv
    tkv = ServeEngine(CFG2, tp, OPTS, preset("byp"), warm_start=path,
                      **kw).kv
    caught = {}
    for name, kv in (("jax", jkv), ("port", tkv)):
        orig = kv._sample

        def sample(logits, key, name=name, orig=orig):
            caught[name] = np.asarray(logits, np.float32) \
                if name == "jax" else logits.numpy()
            return orig(logits, key)
        kv._sample = sample
    prompt = reqs[1].prompt
    jkv.admit(0, prompt, JSampling().request_key(1))
    tkv.admit(0, prompt, SamplingConfig().request_key(1, "cpu"))
    assert tkv.prefix_promotions == jkv.prefix_promotions > 0
    assert tkv.prefix_shared_tokens == jkv.prefix_shared_tokens > 0
    np.testing.assert_allclose(caught["port"], caught["jax"], atol=1e-4,
                               rtol=0)
    assert jkv.reserve(0, 4) and tkv.reserve(0, 4)
    np.testing.assert_array_equal(tkv.tables_host, jkv.tables_host)
    tables = jkv.tables_host
    jc, tc = jkv.cache, tkv.cache
    nxt = np.argmax(caught["jax"], -1).astype(np.int32)
    for _ in range(4):
        lj, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.asarray(tables),
                         jcfg, _jopts(), MAX_LEN)
        lt, tc = decode_step_paged(tp, tc, torch.from_numpy(nxt),
                                   torch.from_numpy(tables), CFG2, OPTS,
                                   MAX_LEN)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=0)
        nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)

"""The port's engine fleet on the CPU, at smoke size, against the JAX
package and inside the port.

Router: ``route_request`` against JAX's on 200 seeded view lists (ties and
caps), JAX's deterministic twins (tests/test_fleet.py) and its hypothesis
properties (tests/test_properties.py) over the port's router;
``_resident_match`` against JAX's after the same inserts, touching no LRU
tick.

Fleet identity inside the port (ROADMAP's parity bar): a 1-replica fleet
serves the bare engine's streams; prefill/decode disaggregation serves the
streams of the colocated engine that prefills as the prefill cells do
(chunked; in fp32 also the two-phase engine's) over fp32, int8 and fp8
blocks, with the async swap stream and without it, and the prefill cell
runs no decode program; a decode cell of one slot makes handoffs wait in
the fleet's FIFO (each carried next token a copy: the prefill cell's
``_next`` is overwritten under them) with the streams unchanged.

The shared store: cross-replica warm hits leave the streams unchanged,
also when the hit's publish is still in flight on the other replica's
stream (as a handoff's swap-out is when the decode cell imports it); a
chunked colocated fleet's published host blocks equal their device blocks
bit for bit (the publish is issued after the serve program that writes
them); ``drop_prefix_cache`` clears the shared map; ``save_prefix_cache``
writes a file a JAX engine restores.

Against JAX: the fleet counters of one workload (disaggregated and
colocated, fp32; no EOS, so the schedule does not depend on tokens); the
Chrome trace of a stamped multi-replica event list; ``load_trace`` reading
``eng`` back; the bad-geometry ``ValueError``s; the launcher's report keys
and its ``--mesh 1,2`` run over two ranks.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import preset  # noqa: E402
from repro_torch.kernels.kv_quant import raw  # noqa: E402
from repro_torch.models import ModelOptions, init_params  # noqa: E402
from repro_torch.serve import (BlockPool, FleetEngine,  # noqa: E402
                               PrefixIndex, ReplicaView, ServeEngine,
                               SharedHostTier, Telemetry, fleet_report,
                               route_request, synthetic_requests)
from repro_torch.serve.fleet import _resident_match  # noqa: E402
from repro_torch.serve.paging import export_chain  # noqa: E402
from repro_torch.serve.telemetry import (chrome_trace,  # noqa: E402
                                         load_trace, validate_events,
                                         validate_spans)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 32
BS = 8


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def model():
    """JAX's smoke parameters and the port's copy of them."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    jcfg = jget("tinyllama-1.1b").smoke()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _jopts():
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    return JOpts(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)


def linkage(decode_steps=0):
    lk = preset("nss_shortcut")
    if decode_steps:
        lk = dataclasses.replace(lk, decode_steps=decode_steps)
    return lk, lk.model_options(OPTS)


def _reqs():
    return synthetic_requests(4, prompt_len=16, max_new_tokens=8,
                              vocab_size=CFG.vocab_size, seed=0,
                              shared_prefix_len=8)


def _streams(comps):
    return {c.rid: c.tokens.tolist() for c in comps}


def _bare(params, lk, opts, reqs, **kw):
    eng = ServeEngine(CFG, params, opts, lk, 2, MAX_LEN, kv="paged",
                      block_size=BS, **kw)
    return _streams(eng.run(reqs, load="closed")[0]), eng


def _fleet(params, lk, opts, **kw):
    return FleetEngine(CFG, params, opts, lk, n_slots=2, max_len=MAX_LEN,
                       kv="paged", block_size=BS, **kw)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def _view(i, q=0, a=0, w=0, cap=4, m=0):
    return ReplicaView(idx=i, queue_depth=q, active=a, swapped=w, cap=cap,
                       match_tokens=m)


def test_route_request_matches_jax():
    """200 seeded view lists, drawn from small ranges so that loads and
    matches tie and caps bind: the port's choice is JAX's every time."""
    from repro.serve import ReplicaView as JView, route_request as jroute
    rng = np.random.default_rng(24)
    nones = 0
    for _ in range(200):
        n = int(rng.integers(1, 7))
        rows = [dict(idx=i, queue_depth=int(rng.integers(0, 5)),
                     active=int(rng.integers(0, 3)),
                     swapped=int(rng.integers(0, 2)),
                     cap=int(rng.integers(1, 5)),
                     match_tokens=int(rng.choice([0, 0, 8, 16])))
                for i in range(n)]
        got = route_request([ReplicaView(**r) for r in rows])
        assert got == jroute([JView(**r) for r in rows]), rows
        nones += got is None
    assert 0 < nones < 200          # the caps bound some lists, not all


def test_router_backpressure_cap():
    assert route_request([_view(0, q=4), _view(1, q=4)]) is None
    assert route_request([_view(0, q=4), _view(1, q=3, a=2)]) == 1
    for q0 in range(6):
        views = [_view(0, q=q0), _view(1, q=2)]
        idx = route_request(views)
        if idx is not None:
            assert views[idx].queue_depth < views[idx].cap


def test_router_prefix_affinity_wins_over_load():
    views = [_view(0, a=2, q=2, m=16), _view(1)]
    assert route_request(views) == 0
    assert route_request(views) == route_request(views)
    views = [_view(0, m=8), _view(1, m=24), _view(2, m=16)]
    assert route_request(views) == 1
    views = [_view(0, q=4, m=32), _view(1)]
    assert route_request(views) == 1


def test_router_least_loaded_then_lowest_index():
    views = [_view(0, a=2), _view(1, a=1), _view(2, a=1)]
    assert route_request(views) == 1
    assert route_request([_view(0), _view(1)]) == 0
    views = [_view(0, q=1, a=1), _view(1, w=1)]
    assert route_request(views) == 1


def _router_properties():
    """tests/test_properties.py's router properties over the port's
    router, as one hypothesis test each (None without hypothesis)."""
    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:
        return None
    views = st.lists(
        st.tuples(st.integers(0, 8), st.integers(0, 4), st.integers(0, 3),
                  st.integers(1, 8), st.integers(0, 64)),
        min_size=1, max_size=6).map(
            lambda rows: [ReplicaView(idx=i, queue_depth=q, active=a,
                                      swapped=w, cap=c, match_tokens=m)
                          for i, (q, a, w, c, m) in enumerate(rows)])

    @settings(max_examples=25, deadline=None)
    @given(views, st.integers(0, 5))
    def check(vs, t):
        idx = route_request(vs)
        eligible = [v for v in vs if v.queue_depth < v.cap]
        if not eligible:
            assert idx is None
        else:
            assert idx is not None and vs[idx].queue_depth < vs[idx].cap
        # least loaded, lowest index, with no prefix anywhere
        flat = [dataclasses.replace(v, match_tokens=0) for v in vs]
        if eligible:
            best = min(eligible, key=lambda v: (v.load, v.idx))
            assert route_request(flat) == best.idx
        # affinity: the one eligible holder of a prefix wins
        target = t % len(vs)
        aff = [dataclasses.replace(
            v, match_tokens=32 if v.idx == target else 0,
            queue_depth=0 if v.idx == target else v.queue_depth)
            for v in vs]
        assert route_request(aff) == target
    return check


def test_router_properties():
    check = _router_properties()
    if check is None:
        pytest.skip("hypothesis is not installed")
    check()


def test_resident_match_matches_jax_and_touches_nothing():
    """The same inserts into the port's and JAX's radix indexes: the
    read-only match agrees on every probe (full, partial, diverging,
    shorter than a block), and no LRU tick moves."""
    from repro.serve.fleet import _resident_match as jmatch
    from repro.serve.paging import BlockPool as JPool, PrefixIndex as JIndex
    rng = np.random.default_rng(5)
    base = rng.integers(0, 50, 40).astype(np.int32)
    other = base.copy()
    other[12] += 1                         # diverges in the second block
    ti, tp, ji, jp = PrefixIndex(4), BlockPool(32, 4), JIndex(4), JPool(32, 4)
    for toks, n_full in ((base, 8), (other, 5), (base[:20], 5)):
        blocks = [tp.alloc() for _ in range(n_full)]
        jblocks = [jp.alloc() for _ in range(n_full)]
        assert blocks == jblocks
        ti.insert(toks, blocks, n_full, tp)
        ji.insert(toks, jblocks, n_full, jp)
    ticks = {b: n.tick for b, n in ti._by_block.items()}
    probes = [base, other, base[:13], base[:3], other[:16],
              rng.integers(50, 60, 16).astype(np.int32),
              np.concatenate([base[:8], other[8:30]])]
    for p in probes:
        got = _resident_match(types.SimpleNamespace(index=ti), p)
        assert got == jmatch(types.SimpleNamespace(index=ji), p)
    assert [_resident_match(types.SimpleNamespace(index=ti), p)
            for p in probes[:4]] == [32, 20, 12, 0]
    assert {b: n.tick for b, n in ti._by_block.items()} == ticks
    assert _resident_match(types.SimpleNamespace(), base) == 0   # slotted


# ---------------------------------------------------------------------------
# Fleet identity inside the port
# ---------------------------------------------------------------------------

def test_one_replica_fleet_is_the_bare_engine(params):
    lk, opts = linkage()
    reqs = _reqs()
    base, eng = _bare(params, lk, opts, reqs)
    fleet = _fleet(params, lk, opts, replicas=1)
    comps, wall = fleet.run(reqs, load="closed")
    assert _streams(comps) == base
    rep = fleet_report(comps, wall, fleet)
    assert rep["requests"] == len(reqs) and rep["replicas"] == 1
    assert len(rep["per_replica"]) == 1
    # the same counters (the fleet's store is shared and sized for the
    # fleet: the host keys differ, nothing else)
    u, b = fleet.engines[0].utilization(), eng.utilization()
    skip = {"kv_host_shared", "kv_host_blocks_total", "kv_async_swap",
            "kv_host_blocks_resident", "kv_host_blocks_hwm"}
    shared = (set(u) & set(b)) - skip
    assert {k: u[k] for k in shared} == {k: b[k] for k in shared}


@pytest.mark.parametrize("async_swap", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_disaggregated_matches_colocated(params, kv_dtype, async_swap):
    """Handoffs over the shared tier change placement only: the
    disaggregated streams equal the colocated engine's that prefills as
    the prefill cell does (chunked), over the same block format; every
    request is handed off, and the prefill cell never ran a decode program
    (short programs, so decode spans several on the decode cell). In fp32
    that engine's streams are the two-phase engine's too; over quantized
    blocks a chunk attends its own freshly written codes, so chunked and
    two-phase prefill differ there (fp8 at this size), in JAX as in the
    port."""
    lk, opts = linkage(decode_steps=4)
    reqs = _reqs()
    base, _ = _bare(params, lk, opts, reqs, kv_dtype=kv_dtype,
                    async_swap=async_swap, chunked=True)
    if kv_dtype == "bf16":
        assert _bare(params, lk, opts, reqs, async_swap=async_swap)[0] == base
    fleet = _fleet(params, lk, opts, replicas=2, prefill_replicas=1,
                   kv_dtype=kv_dtype, async_swap=async_swap)
    pre, dec = fleet.engines
    decodes = []
    orig = pre.kv.decode
    pre.kv.decode = lambda nxt: decodes.append(1) or orig(nxt)
    # a handoff's swap-out is still on the prefill cell's stream when the
    # decode cell imports it (the first import of a tick drains them all)
    pending = []
    swap_in = dec.kv.swap_in
    dec.kv.swap_in = lambda slot, h: (
        pending.append(len(pre.kv.stream) if async_swap else 0)
        or swap_in(slot, h))
    comps, _ = fleet.run(reqs, load="closed")
    assert _streams(comps) == base
    assert fleet.handoffs == len(reqs)
    assert len(pending) == len(reqs)
    assert any(pending) if async_swap else pre.kv.stream is None
    u = fleet.utilization()
    assert u["fleet_handoffs"] == len(reqs)
    assert u["handoffs_out"] == u["handoffs_in"] == len(reqs)
    assert u["per_replica"][0]["handoffs_out"] == len(reqs)
    assert u["per_replica"][1]["handoffs_in"] == len(reqs)
    assert pre.decode_tokens == 0 and not decodes
    assert u["kv_async_swap"] == int(async_swap)
    # every host block came back: only published prefixes stay
    assert fleet.shared.store.n_resident == len(fleet.shared.prefix_map)


def test_handoffs_wait_for_a_one_slot_decode_cell(params):
    """A decode cell of one slot takes one chain at a time: the others wait
    in the fleet's FIFO (held in the shared tier) while the prefill cell
    admits into their slots, and the streams are the colocated ones. Each
    extracted slot's ``_next`` entry is overwritten at once, so a handoff
    that carried a view of it would decode from garbage."""
    lk, opts = linkage(decode_steps=4)
    reqs = _reqs()
    base, _ = _bare(params, lk, opts, reqs)
    fleet = _fleet(params, lk, opts, replicas=2, prefill_replicas=1)
    dec = ServeEngine(CFG, params, opts, lk, 1, MAX_LEN, kv="paged",
                      block_size=BS, shared_host=fleet.shared)
    dec.kv.owner = 1
    fleet.engines[1] = dec
    pre = fleet.engines[0]
    orig = pre.extract_handoffs

    def extract():
        out = orig()
        for slot in range(pre.n_slots):
            if slot not in pre.sched.active:
                pre._next[slot] = -1            # a free slot's entry
        return out
    pre.extract_handoffs = extract
    waits = []
    move = fleet._move_handoffs

    def moved():
        move()
        waits.append(len(fleet._pending))
    fleet._move_handoffs = moved
    comps, _ = fleet.run(reqs, load="closed")
    assert _streams(comps) == base
    assert max(waits) >= 1 and waits[-1] == 0
    assert fleet.handoffs == len(reqs)


# ---------------------------------------------------------------------------
# The shared store
# ---------------------------------------------------------------------------

def test_shared_store_warms_other_replicas(params):
    """A prefix one replica prefilled warms the other (a copy promoted from
    the shared store, counted as a cross hit) and no stream changes;
    ``drop_prefix_cache`` clears the shared map."""
    lk, opts = linkage()
    reqs = _reqs()
    base, _ = _bare(params, lk, opts, reqs)
    fleet = _fleet(params, lk, opts, replicas=2)
    comps, _ = fleet.run(reqs, load="closed")
    assert _streams(comps) == base
    u = fleet.utilization()
    assert u["kv_prefix_publishes"] > 0
    assert u["shared_store_cross_hits"] > 0
    assert u["shared_store_entries"] > 0
    assert u["kv_host_shared"] == 1
    # a copy, not a move: the promoted entries stayed in the shared map
    assert u["kv_prefix_promotions"] > 0
    fleet.drop_prefix_cache()
    assert fleet.utilization()["shared_store_entries"] == 0
    assert fleet.shared.store.n_resident == 0 and not fleet.shared.writer


def test_promotion_drains_the_publishing_stream(params):
    """Requests of one token finish at admission, so no step drains the
    publishing replica's stream before the other replica admits a prompt
    of the same prefix: its promotion finds the publish still in flight on
    another replica's stream and must drain it first (streams unchanged,
    the hits counted as cross hits)."""
    lk, opts = linkage()
    reqs = synthetic_requests(4, prompt_len=16, max_new_tokens=1,
                              vocab_size=CFG.vocab_size, seed=2,
                              shared_prefix_len=8)
    base, _ = _bare(params, lk, opts, reqs)
    fleet = _fleet(params, lk, opts, replicas=2)
    writer, reader = fleet.engines
    pending = []
    promote = reader.kv._promote

    def spy(prompt, matched):
        pending.append(len(writer.kv.stream))
        return promote(prompt, matched)
    reader.kv._promote = spy
    comps, _ = fleet.run(reqs, load="closed")
    assert _streams(comps) == base
    assert any(pending)
    assert fleet.utilization()["shared_store_cross_hits"] > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunked_publish_reads_the_written_blocks(params, kv_dtype):
    """A chunked colocated fleet inserts prompt blocks at plan time, before
    the program that writes them; the publish waits until that program is
    dispatched, so every published host block equals its device block bit
    for bit (codes and scales) — a publish issued at plan time would copy
    the blocks' earlier contents."""
    lk, opts = linkage(decode_steps=4)
    reqs = synthetic_requests(4, prompt_len=20, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=1,
                              shared_prefix_len=8)
    base, _ = _bare(params, lk, opts, reqs, kv_dtype=kv_dtype)
    fleet = _fleet(params, lk, opts, replicas=2, chunked=True,
                   chunk_budget=12, chunk_width=6, kv_dtype=kv_dtype)
    comps, _ = fleet.run(reqs, load="closed")
    assert _streams(comps) == base
    shared = fleet.shared
    for drain in shared.store.drains:
        drain()
    checked = 0
    for key, h in shared.prefix_map.items():
        kv = fleet.engines[shared.writer[key]].kv
        node = next((n for n in kv.index.walk()
                     if kv.index.node_tokens(n).tobytes() == key), None)
        if node is None:
            continue
        dev = export_chain(kv.cache, torch.tensor([node.block]), kv.groups)
        host = shared.store.read(h)
        for g, kvg in enumerate(dev):
            for name, t in kvg.items():
                assert torch.equal(raw(t[:, 0]), raw(host[g][name])), name
        checked += 1
    assert checked >= 4 and fleet.utilization()["kv_prefix_publishes"] >= 4


def test_save_prefix_cache_restores_into_jax(model, tmp_path):
    """The fleet's shared map saved by ``save_prefix_cache`` restores into a
    JAX engine: the same entries and tokens."""
    from repro.core import preset as jpreset
    from repro.serve import ServeEngine as JEngine
    jcfg, jp, tp = model
    lk, opts = linkage()
    fleet = FleetEngine(CFG, tp, opts, lk, replicas=2, n_slots=2,
                        max_len=MAX_LEN, kv="paged", block_size=BS)
    fleet.run(_reqs(), load="closed")
    path = str(tmp_path / "fleet.npz")
    n = fleet.save_prefix_cache(path)
    assert n >= len(fleet.shared.prefix_map) > 0
    jeng = JEngine(jcfg, jp, _jopts(), jpreset("byp"), 2, MAX_LEN,
                   kv="paged", block_size=BS, warm_start=path)
    assert jeng.kv.restored_entries == n
    with np.load(path) as data:
        want = {data[f"tok_{i}"].astype(np.int32).tobytes()
                for i in range(n)}
    assert set(jeng.kv.host_map) == want


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------

FLEET_KEYS = ("fleet_handoffs", "handoffs_out", "handoffs_in",
              "kv_prefix_publishes", "shared_store_entries",
              "shared_store_cross_hits", "fleet_pending_handoffs",
              "kv_prefix_promotions", "kv_prefix_shared_tokens",
              "programs_run", "prefill_tokens", "decode_tokens")


@pytest.mark.parametrize("layout", [dict(replicas=2, prefill_replicas=1),
                                    dict(replicas=2)],
                         ids=["disaggregated", "colocated"])
def test_fleet_counters_match_jax(model, layout):
    """One workload through JAX's ``FleetEngine`` and the port's, on the
    same converted parameters: the schedule is host logic, so the fleet
    counters agree."""
    from repro.core import preset as jpreset
    from repro.serve import FleetEngine as JFleet
    jcfg, jp, tp = model
    jlk = dataclasses.replace(jpreset("nss_shortcut"), decode_steps=4)
    lk, opts = linkage(decode_steps=4)
    kw = dict(n_slots=2, max_len=MAX_LEN, kv="paged", block_size=BS,
              **layout)
    reqs = _reqs()
    jf = JFleet(jcfg, jp, jlk.model_options(_jopts(), on_tpu=False), jlk,
                **kw)
    jf.run(reqs, load="closed")
    tf = FleetEngine(CFG, tp, opts, lk, **kw)
    tf.run(reqs, load="closed")
    ju, tu = jf.utilization(), tf.utilization()
    keys = [k for k in FLEET_KEYS if k in ju]
    assert {k: tu.get(k) for k in keys} == {k: ju[k] for k in keys}
    assert set(tu) == set(ju)
    assert tu["kv_prefix_publishes"] > 0


def test_chrome_trace_matches_jax(params, tmp_path):
    """A fleet run's stamped event list: the port's Chrome export equals
    JAX's, with a process track a replica and the requests after them;
    the events validate (handoff edges included) and ``load_trace`` reads
    each replica id back."""
    from repro.serve.telemetry import chrome_trace as jchrome
    lk, opts = linkage(decode_steps=4)
    tel = Telemetry(trace=True)
    fleet = _fleet(params, lk, opts, replicas=3, prefill_replicas=1,
                   telemetry=tel)
    fleet.run(_reqs(), load="closed")
    events = tel.trace.events
    validate_events(events)
    validate_spans(events)
    hand = [e for e in events if e["type"] == "handoff"]
    assert len(hand) == 4 and {e["args"]["dst"] for e in hand} == {1, 2}
    # routing stamps nothing: a request is queued before any replica ticks
    assert {e.get("eng") for e in events} - {None} == {0, 1, 2}
    doc = chrome_trace(events)
    assert doc == jchrome(events)
    names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert names == {1: "engine/0", 2: "engine/1", 3: "engine/2",
                     4: "requests"}
    # a single engine keeps its old pids
    single = [{k: v for k, v in e.items() if k != "eng"} for e in events]
    assert {e["pid"] for e in chrome_trace(single)["traceEvents"]} == {1, 2}
    path = str(tmp_path / "fleet.json")
    assert tel.trace.export_chrome(path) == len(events)
    back = load_trace(path)
    assert len(back) == len(events)
    srt = sorted(events, key=lambda e: e["ts"])
    assert [e.get("eng") for e in back] == [e.get("eng") for e in srt]
    assert sum(e["type"] == "handoff" for e in back) == 4
    assert tel.metrics.snapshot()["fleet_handoffs_total"] == 4


def test_fleet_rejects_bad_geometry(params):
    lk, opts = linkage()
    with pytest.raises(ValueError):
        FleetEngine(CFG, params, opts, lk, replicas=0, n_slots=2,
                    max_len=MAX_LEN)
    with pytest.raises(ValueError):     # disaggregation needs the swap lane
        FleetEngine(CFG, params, opts, lk, replicas=2, prefill_replicas=1,
                    n_slots=2, max_len=MAX_LEN, kv="slotted")
    with pytest.raises(ValueError):     # must keep >= 1 decode replica
        FleetEngine(CFG, params, opts, lk, replicas=2, prefill_replicas=2,
                    n_slots=2, max_len=MAX_LEN, kv="paged")
    with pytest.raises(ValueError):     # shared tier needs block structure
        ServeEngine(CFG, params, opts, lk, 2, MAX_LEN, kv="slotted",
                    shared_host=object())
    with pytest.raises(ValueError):
        FleetEngine(CFG, params, opts, lk, replicas=2, n_slots=2,
                    max_len=MAX_LEN, admit_cap=0)
    for bad in (dict(kv_dtype="int8"), dict(block_size=4)):
        tier = SharedHostTier.build(CFG, opts, bad.get("block_size", BS), 8,
                                    kv_dtype=bad.get("kv_dtype", "bf16"),
                                    device="cpu")
        with pytest.raises(ValueError, match="geometry"):
            ServeEngine(CFG, params, opts, lk, 2, MAX_LEN, kv="paged",
                        block_size=BS, shared_host=tier)


def test_run_fleet_engine_reports_jax_keys(tmp_path):
    """The launcher on the CPU reports JAX's key set (the fleet's and each
    replica's); ``--mesh 1,2`` runs both replicas over two spawned ranks,
    rank 0 reporting the mesh, both ranks' summaries and the one-device
    streams' token count."""
    from repro.launch.fleet import run_fleet_engine as jrun
    from repro_torch.launch.fleet import main, run_fleet_engine
    kw = dict(replicas=2, disaggregate=1, requests=2, prompt_len=8,
              gen_len=4, load="closed", decode_steps=2, shared_prefix_len=4,
              kv_dtype="int8")
    trep = run_fleet_engine("tinyllama-1.1b", "nss_shortcut", device="cpu",
                            **kw)
    jrep = jrun("tinyllama-1.1b", "nss_shortcut", **kw)
    assert set(trep) == set(jrep)
    assert ([set(u) for u in trep["per_replica"]]
            == [set(u) for u in jrep["per_replica"]])
    assert trep["requests"] == 2 and trep["fleet_handoffs"] == 2
    path = str(tmp_path / "mesh.json")
    assert main(["--mesh", "1,2", "--device", "cpu", "--requests", "2",
                 "--prompt-len", "8", "--gen-len", "4", "--load", "closed",
                 "--decode-steps", "2", "--shared-prefix-len", "4",
                 "--report-json", path]) == 0
    with open(path) as f:
        mrep = json.load(f)
    assert mrep["mesh"] == "1x2" and mrep["requests"] == 2
    assert mrep["total_tokens"] == 8
    assert [r["rank"] for r in mrep["ranks"]] == [0, 1]
    # --scale widens the smoke model as the serve launcher does
    srep = run_fleet_engine("tinyllama-1.1b", "nss_shortcut", device="cpu",
                            scale=1.5, requests=1, prompt_len=8, gen_len=4)
    assert srep["requests"] == 1 and srep["total_tokens"] == 4

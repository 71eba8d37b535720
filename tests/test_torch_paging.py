"""The port's paged KV and chunked prefill on the CPU, at smoke size.

Kernels: the paged kernels' plain versions and their ``ops`` wrappers
against the JAX package's Pallas kernels (``interpret=True``) and its
oracles, on seeded numpy inputs, over the sweep of tests/test_paging.py
and the ROADMAP parity bar (HKV=3, odd dh, block sizes 8 and 16, chunks of
1, 7 and up to a block boundary, W=1 equal to decode). Tolerances: float32
atol = rtol = 1e-5, bfloat16 2e-2.

Host pieces: ``BlockPool``, ``PrefixIndex``, ``pack_chunks`` and the
preemption choices against the JAX package's on the same seeded operation
sequences.

Model: ``decode_step_paged``, ``serve_chunk_step_paged`` and
``prefill_suffix`` teacher-forced against JAX's (``attn_impl="ref"``), with
the weights carried over by ``params_from_jax``, at atol 1e-4.

Engine: the identity matrix of tests/test_paging.py inside the port —
paged == slotted == sequential, chunked paged == two-phase paged ==
sequential — bit for bit on the CPU. Under a shortcut preset the kernels'
plain versions reduce over ``nb * bs`` keys where the slotted path reduces
over ``max_len``, so those cases use a ``max_len`` that is a multiple of
the block size. The identity cases run on the dense smoke model and on the
MoE one (moonshot-v1-16b-a3b-smoke, 4 experts, top-2) made dropless:
capacity is per routing group, and the engines group tokens differently
(a whole prompt, a suffix after a shared prefix, a padded chunk), so with
capacity drops their streams differ by design, as in JAX. With capacity
factor 8 an expert takes every token of its group (C = group size), no
token drops, and the MoE layer's output for a token is its own: the
engines must then agree bit for bit through the shared MLP dispatch.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import DENSE, SWA, LayerSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import L3_NSS, LinkageConfig, preset  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels import paged_decode as tpd  # noqa: E402
from repro_torch.kernels import paged_prefill as tpp  # noqa: E402
from repro_torch.models import (ModelOptions, decode_step,  # noqa: E402
                                decode_step_paged, init_params, prefill,
                                prefill_suffix, serve_chunk_step_paged)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import (BlockPool, PrefixIndex, Request,  # noqa: E402
                               ServeEngine, Telemetry, synthetic_requests)
from repro_torch.serve import scheduler as tsched  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
_MOE = get_config("moonshot-v1-16b-a3b").smoke()
ARCHS = {"tinyllama": CFG,
         "moe": dataclasses.replace(_MOE, moe=dataclasses.replace(
             _MOE.moe, capacity_factor=8.0))}
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48
F32, BF16 = "float32", "bfloat16"


def _tol(dt):
    return (dict(atol=2e-2, rtol=2e-2) if dt == BF16
            else dict(atol=1e-5, rtol=1e-5))


def _pair(a: np.ndarray, dt: str = F32):
    import jax.numpy as jnp
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16 and a.dtype == np.float32:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(got_t, want_j, dt=F32):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **_tol(dt))


def _pools(rng, B, nb, bs, HKV, dh, lives, spare=1):
    """Pools (P+1, bs, HKV, dh), P = B*nb + spare (row P the trash block),
    and (B, nb) tables: permuted, non-contiguous pool rows for each slot's
    first ceil(lives[b] / bs) blocks, the trash row for the rest."""
    P = B * nb + spare
    kp = rng.standard_normal((P + 1, bs, HKV, dh)).astype(np.float32)
    vp = rng.standard_normal((P + 1, bs, HKV, dh)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    tables = np.full((B, nb), P, np.int32)
    for b, live in enumerate(lives):
        used = -(-live // bs)
        tables[b, :used] = perm[b * nb:b * nb + used]
    return kp, vp, tables


# ---------------------------------------------------------------------------
# paged decode (Pallas paged_decode.py:135)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,nb,bs,HQ,HKV,dh,pos,dt", [
    (2, 3, 8, 4, 2, 64, (12, 0), F32),         # mid-block, freshly admitted
    (3, 4, 8, 6, 3, 33, (0, 13, 31), F32),     # HKV=3, odd dh, bs 8
    (2, 3, 16, 4, 1, 129, (47, 16), F32),      # MQA, dh=129, bs 16
    (4, 5, 16, 32, 4, 64, (32, 48, 71, 0), BF16),  # tinyllama path A, bf16
])
def test_paged_decode_matches_pallas(B, nb, bs, HQ, HKV, dh, pos, dt):
    """The plain version (through the kernel wrapper on CPU tensors) and
    the ops wrapper, which builds ``valid = arange(nb*bs) <= pos``, against
    the Pallas kernel in interpret mode (reached through JAX's ops wrapper,
    which builds the same mask) and the JAX oracle."""
    from repro.kernels import ops as jops, ref as jref
    rng = np.random.default_rng(sum(pos) + dh)
    kp, vp, tables = _pools(rng, B, nb, bs, HKV, dh, [p + 1 for p in pos])
    q = rng.standard_normal((B, HQ, dh)).astype(np.float32)
    valid = np.arange(nb * bs)[None] <= np.asarray(pos)[:, None]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dt) for a in (q, kp, vp))
    tj, tt = _pair(tables)
    mj, mt = _pair(valid)
    pj, pt = _pair(np.asarray(pos, np.int32))
    want = jops.paged_decode_attention(qj[:, None], kj, vj, tj, pj)
    got = tops.paged_decode_attention(qt[:, None], kt, vt, tt, pt)
    assert got.shape == (B, 1, HQ, dh)
    _close(got, want, dt)
    _close(tpd.paged_decode_attention(qt, kt, vt, tt, mt), want[:, 0], dt)
    _close(tref.paged_decode_attention_ref(qt, kt, vt, tt, mt),
           jref.paged_decode_attention_ref(qj, kj, vj, tj, mj), dt)


# ---------------------------------------------------------------------------
# paged prefill (Pallas paged_prefill.py:185)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,W,nb,bs,HQ,HKV,dh,starts,dt", [
    (3, 7, 4, 8, 6, 3, 33, (0, 5, 25), F32),    # HKV=3, odd dh, mid-block
    (2, 1, 3, 16, 4, 1, 129, (0, 40), F32),     # W=1, MQA, dh=129, bs 16
    (2, 8, 4, 8, 6, 3, 64, (8, 16), F32),       # chunks end on a block edge
    (4, 24, 5, 16, 32, 4, 64, (0, 8, 24, 40), BF16),  # tinyllama path B
])
def test_paged_prefill_matches_pallas(B, W, nb, bs, HQ, HKV, dh, starts, dt):
    from repro.kernels import ops as jops, ref as jref
    rng = np.random.default_rng(W * dh + sum(starts))
    kp, vp, tables = _pools(rng, B, nb, bs, HKV, dh,
                            [min(s + W, nb * bs) for s in starts])
    q = rng.standard_normal((B, W, HQ, dh)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dt) for a in (q, kp, vp))
    tj, tt = _pair(tables)
    sj, st = _pair(np.asarray(starts, np.int32))
    # JAX's ops wrapper runs the Pallas kernel in interpret mode off-TPU
    want = jops.paged_prefill_attention(qj, kj, vj, tj, sj)
    _close(tpp.paged_prefill_attention(qt, kt, vt, tt, st), want, dt)
    _close(tops.paged_prefill_attention(qt, kt, vt, tt, st), want, dt)
    _close(tref.paged_prefill_attention_ref(qt, kt, vt, tt, st),
           jref.paged_prefill_attention_ref(qj, kj, vj, tj, sj), dt)


@pytest.mark.parametrize("bs,HKV,dh", [(8, 3, 33), (16, 2, 64)])
def test_paged_prefill_width_one_is_decode(bs, HKV, dh):
    """A W=1 chunk at ``start`` is a decode step at ``pos = start``: the
    two plain versions agree bit for bit."""
    rng = np.random.default_rng(bs + dh)
    pos = (0, 13, 30)
    kp, vp, tables = _pools(rng, 3, 4, bs, HKV, dh, [p + 1 for p in pos])
    q = torch.from_numpy(rng.standard_normal((3, 2 * HKV, dh)).astype(
        np.float32))
    kt, vt, tt = map(torch.from_numpy, (kp, vp, tables))
    pt = torch.tensor(pos, dtype=torch.int32)
    dec = tops.paged_decode_attention(q[:, None], kt, vt, tt, pt)
    pre = tops.paged_prefill_attention(q[:, None], kt, vt, tt, pt)
    assert torch.equal(dec, pre)


@pytest.mark.parametrize("fn", ["decode", "prefill"])
def test_paged_quantized_pools_raise(fn):
    """The quantization arguments are checked on every device: scales on an
    fp32 pool, one scale tensor without the other, scales of the wrong
    shape, and codes without scales all raise (tests/test_torch_quant.py
    holds the quantized kernels' values)."""
    q, kp = torch.zeros(1, 2, 8), torch.zeros(3, 4, 1, 8)
    codes = torch.zeros(3, 4, 1, 8, dtype=torch.int8)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    scales = torch.ones(3, 1)

    def call(kp, ks, vs):
        if fn == "decode":
            return tpd.paged_decode_attention(
                q, kp, kp, tables, torch.ones(1, 8, dtype=torch.bool), ks, vs)
        return tpp.paged_prefill_attention(
            q[:, None], kp, kp, tables, torch.zeros(1, dtype=torch.int32), ks,
            vs)

    with pytest.raises(TypeError, match="int8 or float8"):
        call(kp, scales, scales)
    with pytest.raises(ValueError, match="both ks and vs"):
        call(codes, scales, None)
    with pytest.raises(ValueError, match="ks must be a float32"):
        call(codes, torch.ones(3, 2), scales)
    with pytest.raises(TypeError, match="share q's dtype"):
        call(codes, None, None)
    assert call(codes, scales, scales).shape[-1] == 8


# ---------------------------------------------------------------------------
# host pieces against the JAX package's
# ---------------------------------------------------------------------------

def test_block_pool_and_prefix_index_match_jax():
    """A seeded random mix of alloc / retain / free / insert / match /
    evict / n_evictable through both packages' BlockPool + PrefixIndex:
    every result and the refcounts after every operation agree."""
    from repro.serve import paging as jpaging
    logs = []
    for Pool, Index in ((BlockPool, PrefixIndex),
                        (jpaging.BlockPool, jpaging.PrefixIndex)):
        rng = np.random.default_rng(42)
        pool, idx, log = Pool(10, block_size=4), Index(block_size=4), []
        held = []                                  # references we hold
        prompts = [rng.integers(0, 3, size=12).astype(np.int32)
                   for _ in range(6)]
        for op in rng.integers(0, 6, size=300):
            if op == 0:
                blk = pool.alloc()
                log.append(("alloc", blk))
                if blk is not None:
                    held.append(blk)
            elif op == 1 and held:
                blk = held[int(rng.integers(len(held)))]
                pool.retain(blk)
                held.append(blk)
                log.append(("retain", blk))
            elif op == 2 and held:
                blk = held.pop(int(rng.integers(len(held))))
                log.append(("free", blk, pool.free(blk)))
            elif op == 3 and len(held) >= 3:
                p = prompts[int(rng.integers(len(prompts)))]
                n_full = int(rng.integers(0, 4))
                chain = idx.match(p)
                chain = chain + held[:3 - len(chain)]
                idx.insert(p, chain, n_full, pool)
                log.append(("insert", len(idx)))
            elif op == 4:
                p = prompts[int(rng.integers(len(prompts)))]
                log.append(("match", idx.match(p)))
            elif op == 5:
                log.append(("evict", idx.evict(pool, int(rng.integers(1, 3))),
                            idx.n_evictable(pool)))
            log.append((pool.n_free, pool.hwm, pool.refs.tolist()))
        logs.append(log)
    assert logs[0] == logs[1]


def test_pool_scheduler_differential_matches_jax():
    """tests/test_paging.py:143's seeded admit / reserve / CoW / finish /
    preempt sequence through both packages' BlockPool: identical blocks,
    refcounts and free-list sizes at every step."""
    from repro.serve import BlockPool as JPool
    traces = []
    for Pool in (BlockPool, JPool):
        rng = np.random.default_rng(42)
        pool, chains, order, trace, nxt = Pool(12, block_size=4), {}, [], [], 0
        for op in rng.integers(0, 5, size=400):
            if op == 0:
                n, chain = int(rng.integers(1, 5)), []
                if rng.random() < 0.5 and order:
                    for blk in chains[order[0]][:n - 1]:
                        pool.retain(blk)
                        chain.append(blk)
                while len(chain) < n:
                    blk = pool.alloc()
                    if blk is None:
                        for b in chain:
                            pool.free(b)
                        chain = None
                        break
                    chain.append(blk)
                if chain is not None:
                    chains[nxt], nxt = chain, nxt + 1
                    order.append(nxt - 1)
            elif op == 1 and chains:
                blk = pool.alloc()
                if blk is not None:
                    chains[sorted(chains)[int(rng.integers(len(chains)))]
                           ].append(blk)
            elif op == 2:
                shared = [(s, i) for s, c in chains.items()
                          for i, b in enumerate(c) if pool.refs[b] > 1]
                if shared:
                    s, i = shared[int(rng.integers(len(shared)))]
                    new = pool.alloc()
                    if new is not None:
                        pool.free(chains[s][i])
                        chains[s][i] = new
            elif op in (3, 4) and order:
                s = (sorted(chains)[int(rng.integers(len(chains)))]
                     if op == 3 else order[-1])
                for b in chains.pop(s):
                    pool.free(b)
                order.remove(s)
            trace.append((pool.n_free, pool.hwm, pool.refs.tolist(),
                          sorted((s, tuple(c)) for s, c in chains.items())))
        traces.append(trace)
    assert traces[0] == traces[1]


def test_pack_chunks_matches_jax():
    from repro.serve.scheduler import pack_chunks as jpack
    rng = np.random.default_rng(0)
    for _ in range(500):
        budget, width = int(rng.integers(1, 80)), int(rng.integers(1, 30))
        dec = int(rng.integers(0, 64))
        rem = [int(r) for r in rng.integers(0, 50, size=rng.integers(0, 5))]
        got = tsched.pack_chunks(budget, width, dec, rem)
        assert got == jpack(budget, width, dec, rem)
        assert sum(got) <= max(budget - dec, 0)
    for bad in ((0, 4, 0, [1]), (4, 0, 0, [1]), (4, 4, 0, [-1])):
        with pytest.raises(ValueError):
            tsched.pack_chunks(*bad)


def test_preemption_choices_match_jax():
    """Victim choice (youngest / lru), requeue_front and the policy parser
    against the JAX scheduler; the parser takes swap, as JAX's does."""
    from repro.serve import scheduler as jsched
    picks = []
    for mod in (tsched, jsched):
        rng = np.random.default_rng(1)
        s, out = mod.SlotScheduler(4), []
        for rid in range(6):
            s.enqueue(mod.Request(rid=rid, prompt=np.zeros(3, np.int32),
                                  max_new_tokens=2))
        for t in range(4):
            s.admit_next(now=float(t))
        for slot, st in s.active.items():
            st.last_emit_s = float(rng.integers(0, 3)) if slot % 2 else None
        for policy in ("youngest", "lru"):
            victim = s.choose_victim(policy)
            out.append((policy, victim, s.active[victim].admit_seq))
        s.requeue_front(s.release(s.choose_victim("youngest")).req)
        out.append((s.peek().rid, s.n_queued, s.n_free))
        picks.append(out)
    assert picks[0] == picks[1]
    assert tsched.PreemptionPolicy.parse("recompute").victim == "youngest"
    assert tsched.PreemptionPolicy.parse("swap").mode == "swap"
    with pytest.raises(ValueError, match="victim"):
        tsched.PreemptionPolicy(victim="oldest").validate()


# ---------------------------------------------------------------------------
# the model against JAX, teacher-forced (attn_impl="ref")
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jax = pytest.importorskip("jax")
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


def _prefilled_pools(jcfg, jp, toks, n_res, bs, nb, P, tables):
    """JAX prefill of ``toks``; its first ``n_res[b]`` positions of each
    row scattered into numpy pools (L, P+1, bs, HKV, dh) through
    ``tables``. Returns (prefill logits, kp, vp)."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    lj, cj = jprefill(jp, jnp.asarray(toks), jcfg, _jopts(), max_len=MAX_LEN)
    k, v = np.asarray(cj[0]["k"]), np.asarray(cj[0]["v"])   # (L,B,T,HKV,dh)
    L = k.shape[0]
    kp = np.zeros((L, P + 1, bs) + k.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    for b, n in enumerate(n_res):
        for p in range(n):
            kp[:, tables[b, p // bs], p % bs] = k[:, b, p]
            vp[:, tables[b, p // bs], p % bs] = v[:, b, p]
    return lj, kp, vp


def _caches(kp, vp, pos):
    """The same pools as the JAX paged cache (one stacked group) and the
    port's (one dict per layer)."""
    import jax.numpy as jnp
    L = kp.shape[0]
    jc = ({"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
           "pos": jnp.asarray(np.tile(np.asarray(pos, np.int32), (L, 1)))},)
    tc = [{"kp": torch.from_numpy(kp[l].copy()),
           "vp": torch.from_numpy(vp[l].copy()),
           "pos": torch.tensor(pos, dtype=torch.int32)} for l in range(L)]
    return jc, tc


def test_decode_step_paged_matches_jax(model):
    """Prefill, the cache scattered into pools through permuted tables,
    then 6 paged decode steps (crossing a block boundary) in both
    packages, the port fed JAX's greedy tokens; the port also through the
    shortcut options (the kernels' plain versions on the CPU)."""
    import jax.numpy as jnp
    from repro.models import decode_step_paged as jdecode
    jcfg, jp, tp = model
    bs, nb, S = 8, MAX_LEN // 8, 13
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, S), dtype=np.int32)
    tables = rng.permutation(2 * nb + 1)[:2 * nb].reshape(2, nb).astype(
        np.int32)
    lj, kp, vp = _prefilled_pools(jcfg, jp, toks, (S, S), bs, nb, 2 * nb + 1,
                                  tables)
    jc, tc = _caches(kp, vp, (S, S))
    tk = [{k: v.clone() for k, v in g.items()} for g in tc]
    kern = preset("nss_shortcut").model_options(OPTS)
    tt = torch.from_numpy(tables)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        lj, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.asarray(tables),
                         jcfg, _jopts(), MAX_LEN)
        lt, tc = decode_step_paged(tp, tc, torch.from_numpy(nxt), tt, CFG,
                                   OPTS, MAX_LEN)
        lk, tk = decode_step_paged(tp, tk, torch.from_numpy(nxt), tt, CFG,
                                   kern, MAX_LEN)
        for got in (lt, lk):
            np.testing.assert_allclose(got.numpy(), np.asarray(lj),
                                       atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc[1]["kp"].numpy(),
                               np.asarray(jc[0]["kp"][1]), atol=1e-4)
    assert tc[0]["pos"].tolist() == [S + 6] * 2


def test_serve_chunk_step_paged_matches_jax(model):
    """One chunk pass, three rows: a fresh 7-token chunk, a 5-token chunk
    starting mid-block over 8 resident positions, and a row with no chunk.
    Logits at each row's last chunk position, the written pools and the
    positions agree with JAX's."""
    import jax.numpy as jnp
    from repro.models import serve_chunk_step_paged as jchunk
    jcfg, jp, tp = model
    bs, nb, W = 8, MAX_LEN // 8, 7
    rng = np.random.default_rng(6)
    full = rng.integers(0, 256, (3, 13), dtype=np.int32)
    P = 3 * nb + 1
    tables = rng.permutation(P)[:3 * nb].reshape(3, nb).astype(np.int32)
    _, kp, vp = _prefilled_pools(jcfg, jp, full, (0, 8, 10), bs, nb, P,
                                 tables)
    start = np.array([0, 8, 10], np.int32)
    clen = np.array([7, 5, 0], np.int32)
    chunk = np.zeros((3, W), np.int32)
    chunk[0, :7], chunk[1, :5] = full[0, :7], full[1, 8:13]
    jc, tc = _caches(kp, vp, (0, 8, 10))
    lj, jc = jchunk(jp, jc, jnp.asarray(chunk), jnp.asarray(tables),
                    jnp.asarray(start), jnp.asarray(clen), jcfg, _jopts(),
                    MAX_LEN)
    for opts in (OPTS, preset("nss_shortcut").model_options(OPTS)):
        caches = [{k: v.clone() for k, v in g.items()} for g in tc]
        lt, caches = serve_chunk_step_paged(
            tp, caches, torch.from_numpy(chunk), torch.from_numpy(tables),
            torch.from_numpy(start), torch.from_numpy(clen), CFG, opts,
            MAX_LEN)
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                   atol=1e-4, rtol=0)
        for l, g in enumerate(caches):
            real = np.asarray(jc[0]["kp"][l])[:-1]     # the trash row aside
            np.testing.assert_allclose(g["kp"].numpy()[:-1], real, atol=1e-4)
            assert g["pos"].tolist() == [7, 13, 10]


@pytest.mark.parametrize("true_len", [None, 3])
def test_prefill_suffix_matches_jax(model, true_len):
    """The suffix prefill over a resident 8-token prefix (bucket-padded to
    5 with ``true_len``): logits and the suffix K/V agree with JAX's."""
    import jax.numpy as jnp
    from repro.models import prefill as jprefill
    from repro.models import prefill_suffix as jsuffix
    jcfg, jp, tp = model
    rng = np.random.default_rng(7)
    full = rng.integers(0, 256, (1, 13), dtype=np.int32)
    _, cj = jprefill(jp, jnp.asarray(full[:, :8]), jcfg, _jopts(),
                     max_len=MAX_LEN)
    k, v = np.asarray(cj[0]["k"]), np.asarray(cj[0]["v"])  # (L,1,T,HKV,dh)
    suffix = full[:, 8:]
    jkw = {} if true_len is None else {"true_len": jnp.asarray(true_len)}
    lj, kvj = jsuffix(jp, jnp.asarray(suffix),
                      ({"k": jnp.asarray(k), "v": jnp.asarray(v)},),
                      jnp.asarray(8), jcfg, _jopts(), **jkw)
    pre = [{"k": torch.from_numpy(k[l].copy()), "v": torch.from_numpy(v[l].copy())}
           for l in range(k.shape[0])]
    for opts in (OPTS, preset("nss_shortcut").model_options(OPTS)):
        lt, kvt = prefill_suffix(tp, torch.from_numpy(suffix), pre, 8, CFG,
                                 opts, true_len=true_len)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=0)
        for l, g in enumerate(kvt):
            np.testing.assert_allclose(g["k"].numpy(),
                                       np.asarray(kvj[0]["k"][l]), atol=1e-4)


@pytest.mark.parametrize("window,qc,kc", [(0, 4, 8), (5, 3, 16), (0, 512, 1024)])
def test_sdpa_chunked_matches_jax(window, qc, kc):
    """The blockwise attention (rectangular q over a longer, masked kv, as
    the suffix prefill uses it) against JAX's ``_sdpa_chunked``."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(qc + kc + window)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    qp, kp = np.arange(6, 15, dtype=np.int32), np.arange(20, dtype=np.int32)
    kw = dict(causal=True, window=window)
    want = JL._sdpa_chunked(*map(jnp.asarray, (q, k, v)), q_pos=qp, k_pos=kp,
                            q_chunk=qc, kv_chunk=kc, **kw)
    got = TL._sdpa_chunked(*map(torch.from_numpy, (q, k, v)),
                           q_pos=torch.from_numpy(qp),
                           k_pos=torch.from_numpy(kp), q_chunk=qc,
                           kv_chunk=kc, **kw)
    _close(got, want)


# ---------------------------------------------------------------------------
# engine identity inside the port (tests/test_paging.py:262-515)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module", params=list(ARCHS))
def engine_model(request, params):
    """(config, parameters) of the dense and of the dropless MoE smoke
    model."""
    cfg = ARCHS[request.param]
    if cfg is CFG:
        return cfg, params
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def sequential_tokens(params, req, opts=OPTS, cfg=CFG):
    """Reference: the request alone, prefill + one-token decode loop."""
    logits, cache = prefill(params, torch.from_numpy(req.prompt)[None], cfg,
                            opts, max_len=MAX_LEN)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out = [int(nxt[0])]
    for _ in range(req.max_new_tokens - 1):
        logits, cache = decode_step(params, cache, nxt, cfg, opts)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        out.append(int(nxt[0]))
    return out


def run_engine(params, linkage, requests, *, kv, n_slots=2, load="closed",
               opts=OPTS, cfg=CFG, **kw):
    eng = ServeEngine(cfg, params, opts, linkage, n_slots=n_slots,
                      max_len=MAX_LEN, kv=kv, **kw)
    comps, _ = eng.run(requests, load=load)
    assert len(comps) == len(requests)
    return {c.rid: c.tokens.tolist() for c in comps}, eng


def assert_paged_identical(params, linkage, requests, *, check_seq=True,
                           n_slots=2, opts=OPTS, cfg=CFG, **kw):
    slotted, _ = run_engine(params, linkage, requests, kv="slotted",
                            n_slots=n_slots, opts=opts, cfg=cfg)
    paged, eng = run_engine(params, linkage, requests, kv="paged",
                            n_slots=n_slots, opts=opts, cfg=cfg, **kw)
    assert slotted == paged, f"paged diverged:\n{slotted}\n{paged}"
    if check_seq:
        for req in requests:
            assert paged[req.rid] == sequential_tokens(params, req,
                                                       cfg=cfg), req.rid
    return eng


def test_paged_identity_shared_prefix(engine_model):
    """4 requests CoW-sharing a 16-token prefix: paged == slotted ==
    sequential, and the index shared blocks (suffix prefill taken)."""
    cfg, params = engine_model
    reqs = synthetic_requests(4, prompt_len=24, max_new_tokens=5,
                              vocab_size=cfg.vocab_size, seed=7,
                              shared_prefix_len=16)
    eng = assert_paged_identical(params, preset("base"), reqs, block_size=8,
                                 cfg=cfg)
    assert eng.utilization()["kv_prefix_shared_tokens"] >= 16 * 3
    assert eng.sched.n_free == 2 and eng.kv.pool.n_resident == len(
        eng.kv.index)                   # only index-held blocks remain


def test_paged_identity_identical_prompts_cow(params):
    """Identical block-aligned prompts: a full-prefix radix hit prefills one
    token and forks the tail block copy-on-write before writing it."""
    base = synthetic_requests(1, prompt_len=16, max_new_tokens=4,
                              vocab_size=CFG.vocab_size, seed=9)[0]
    reqs = [dataclasses.replace(base, rid=i) for i in range(3)]
    eng = assert_paged_identical(params, preset("byp"), reqs, block_size=8)
    u = eng.utilization()
    assert u["kv_cow_forks"] >= 2
    assert u["kv_prefix_shared_tokens"] == 15 * 2


def test_paged_identity_l3_crosses_blocks(engine_model):
    """L3 programs of 3 microsteps over blocks of 4: demand allocation
    crosses block boundaries inside one program."""
    cfg, params = engine_model
    lk = LinkageConfig(level=L3_NSS, ret_async=True, decode_steps=3)
    reqs = synthetic_requests(5, prompt_len=8, max_new_tokens=7,
                              vocab_size=cfg.vocab_size, seed=1,
                              shared_prefix_len=4)
    assert_paged_identical(params, lk, reqs, block_size=4, cfg=cfg)


def test_paged_identity_nss_shortcut(engine_model):
    """The shortcut preset (the kernels' plain versions on the CPU) with
    max_len a multiple of the block size: paged == slotted."""
    cfg, params = engine_model
    lk = dataclasses.replace(preset("nss_shortcut"), decode_steps=4)
    opts = lk.model_options(OPTS)
    reqs = synthetic_requests(4, prompt_len=10, max_new_tokens=6,
                              vocab_size=cfg.vocab_size, seed=4)
    assert_paged_identical(params, lk, reqs, check_seq=False, opts=opts,
                           block_size=16, cfg=cfg)


def test_paged_preemption_recompute(params):
    """A pool far smaller than worst case forces recompute preemption; the
    preempted requests replay bit-identically on re-admission, and the
    trace's lifecycle spans stay legal."""
    from repro_torch.serve.telemetry import validate_events, validate_spans
    tel = Telemetry(trace=True)
    reqs = synthetic_requests(4, prompt_len=8, max_new_tokens=12,
                              vocab_size=CFG.vocab_size, seed=3)
    eng = assert_paged_identical(params, preset("byp"), reqs, n_slots=3,
                                 block_size=4, num_blocks=9, telemetry=tel)
    assert eng.preemptions > 0 and eng.kv.pool.hwm <= 9
    events = tel.trace.events
    validate_events(events)
    paths = validate_spans(events)
    assert any("preempted" in p for p in paths.values())


def test_paged_admission_gated_on_blocks(params):
    """With blocks for about one sequence, free slots alone don't admit:
    the engine serializes on the block pool, not the slot count."""
    reqs = synthetic_requests(3, prompt_len=8, max_new_tokens=4,
                              vocab_size=CFG.vocab_size, seed=4)
    paged, eng = run_engine(params, preset("base"), reqs, kv="paged",
                            n_slots=3, block_size=4, num_blocks=5)
    for req in reqs:
        assert paged[req.rid] == sequential_tokens(params, req)
    assert eng.kv.pool.hwm <= 5


def test_paged_rejects_oversized_and_sliding_window(params):
    eng = ServeEngine(CFG, params, OPTS, preset("base"), n_slots=1,
                      max_len=MAX_LEN, kv="paged", block_size=4,
                      num_blocks=3)
    eng.sched.enqueue(Request(rid=0, prompt=np.zeros(8, np.int32),
                              max_new_tokens=8))
    with pytest.raises(ValueError, match="never fit"):
        eng._admit(lambda: 0.0)
    swa = dataclasses.replace(CFG, block_pattern=(LayerSpec(SWA, DENSE),))
    with pytest.raises(ValueError, match="plain-attention"):
        ServeEngine(swa, params, OPTS, preset("base"), n_slots=1,
                    max_len=16, kv="paged")


def _chunked(params, linkage, requests, *, n_slots=2, budget=6, opts=OPTS,
             load="closed", **kw):
    return run_engine(params, linkage, requests, kv="paged", n_slots=n_slots,
                      load=load, opts=opts, chunked=True, chunk_budget=budget,
                      **kw)


def test_chunked_paged_shared_prefix_identity(engine_model):
    """A shared system prompt under chunked admission: the radix index
    resolves the prefix once, suffix chunks split over several steps, and
    the streams match two-phase paged and sequential."""
    cfg, params = engine_model
    reqs = synthetic_requests(4, prompt_len=12, max_new_tokens=6,
                              vocab_size=cfg.vocab_size, seed=7,
                              shared_prefix_len=8)
    two_phase, _ = run_engine(params, preset("byp"), reqs, kv="paged",
                              block_size=8, cfg=cfg)
    got, eng = _chunked(params, preset("byp"), reqs, budget=5, block_size=8,
                        cfg=cfg)
    assert got == two_phase
    for req in reqs:
        assert got[req.rid] == sequential_tokens(params, req,
                                                 cfg=cfg), req.rid
    assert eng.utilization()["kv_prefix_shared_tokens"] > 0


def test_chunked_paged_identical_prompts_cow(params):
    """Identical prompts: rids 0 and 1 admit in the same step (nothing
    resident to share yet); rid 2, admitted after a completion, hits the
    index for P-1 tokens and forks the shared tail block."""
    base = synthetic_requests(1, prompt_len=16, max_new_tokens=4,
                              vocab_size=CFG.vocab_size, seed=9)[0]
    reqs = [dataclasses.replace(base, rid=i) for i in range(3)]
    got, eng = _chunked(params, preset("byp"), reqs, budget=6, block_size=8)
    want = sequential_tokens(params, base)
    assert all(got[rid] == want for rid in got)
    u = eng.utilization()
    assert u["kv_cow_forks"] >= 1 and u["kv_prefix_shared_tokens"] == 15


def test_chunked_paged_progressive_prefix_insert(params):
    """Full prompt blocks enter the radix index as their chunks land, so an
    admission while another slot is mid-prefill shares what is resident."""
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=2,
                      max_len=MAX_LEN, kv="paged", block_size=8,
                      chunked=True, chunk_budget=8)
    kv = eng.kv
    prompt = np.arange(24, dtype=np.int32) % CFG.vocab_size
    assert kv.admit_chunked(0, prompt) == 0
    assert kv.append_chunk(0, 0, prompt[:8])
    assert kv.append_chunk(0, 8, prompt[8:16])
    assert len(kv.index) == 2
    assert kv.admit_chunked(1, prompt) == 16
    assert kv.chains[1].blocks == kv.chains[0].blocks[:2]
    assert kv.pool.refs[kv.chains[0][0]] == 3           # 2 chains + index


def test_chunked_paged_mid_prefill_preemption(params):
    """Pool pressure while a slot is still absorbing its prompt: the victim
    may be mid-prefill; recompute replays its stream exactly."""
    reqs = synthetic_requests(4, prompt_len=12, max_new_tokens=10,
                              vocab_size=CFG.vocab_size, seed=3)
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=3,
                      max_len=MAX_LEN, kv="paged", block_size=4,
                      num_blocks=11, chunked=True, chunk_budget=5)
    mid_prefill = []
    orig = eng._preempt

    def spy(slot):
        mid_prefill.append(eng.sched.active[slot].prefilling)
        orig(slot)

    eng._preempt = spy
    comps, _ = eng.run(reqs, load="closed")
    got = {c.rid: c.tokens.tolist() for c in comps}
    assert eng.preemptions > 0 and any(mid_prefill)
    for req in reqs:
        assert got[req.rid] == sequential_tokens(params, req), req.rid


def test_chunked_paged_nss_shortcut_open_loop(engine_model):
    """Open-loop arrivals, fused L3 shortcut decode and chunked admission:
    timing changes, streams don't; the trace holds the chunk, pack and
    overlap events and legal spans."""
    from repro_torch.serve.telemetry import validate_events, validate_spans
    cfg, params = engine_model
    lk = preset("nss_shortcut")
    opts = lk.model_options(OPTS)
    reqs = synthetic_requests(4, prompt_len=10, max_new_tokens=6,
                              vocab_size=cfg.vocab_size, seed=4, rate=400.0)
    tel = Telemetry(trace=True)
    got, eng = _chunked(params, lk, reqs, budget=6, opts=opts, load="open",
                        block_size=8, telemetry=tel, cfg=cfg)
    two_phase, _ = run_engine(params, lk, reqs, kv="paged", opts=opts,
                              block_size=8, cfg=cfg)
    assert got == two_phase
    events = tel.trace.events
    validate_events(events)
    validate_spans(events)
    kinds = {e["type"] for e in events}
    assert {"prefill_chunk", "pack", "overlap"} <= kinds
    assert eng.utilization()["step_mode"] == "chunked"


@pytest.mark.parametrize("chunked", [False, True])
def test_paged_serve_report_has_the_jax_keys(params, chunked):
    """The paged (and chunked) report has every key the JAX engine's has
    without a host tier."""
    import jax
    from repro.configs import get_config as jget
    from repro.core import preset as jpreset
    from repro.models import ModelOptions as JOpts, init_params as jinit
    from repro.serve import ServeEngine as JEngine, serve_report as jreport
    from repro_torch.serve import serve_report
    kw = dict(kv="paged", block_size=8, chunked=chunked)
    jcfg = jget("tinyllama-1.1b").smoke()
    jeng = JEngine(jcfg, jinit(jax.random.PRNGKey(0), jcfg), JOpts(),
                   jpreset("byp"), n_slots=2, max_len=MAX_LEN, **kw)
    reqs = synthetic_requests(2, 8, 3, CFG.vocab_size)
    jcomps, jwall = jeng.run(reqs)
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=2,
                      max_len=MAX_LEN, **kw)
    comps, wall = eng.run(reqs)
    assert (set(serve_report(comps, wall, eng.utilization()))
            == set(jreport(jcomps, jwall, jeng.utilization())))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,mode", [
    (["--kv", "paged", "--shared-prefix-len", "4", "--block-size", "4"],
     "two_phase"),
    (["--kv", "paged", "--chunked", "--budget", "6", "--chunk-width", "4"],
     "chunked"),
])
def test_launcher_paged_prints_a_report(extra, mode, capsys):
    from repro_torch.launch import serve as launch
    rc = launch.main(["--device", "cpu", "--load", "closed", "--requests",
                      "2", "--prompt-len", "8", "--gen-len", "5", *extra])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["kv_backend"] == "paged" and rep["step_mode"] == mode
    assert rep["total_tokens"] == 2 * 5 and rep["device"] == "cpu"


# ---------------------------------------------------------------------------
# on the card: both paged kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_kernels_match_plain(dtype):
    """Both paged kernels against their plain versions on the card: the
    sweep's HKV=3 / dh 33 shape, path A/B's, and jamba's attention shape
    (dh 128, G 4) at a chunk of 40 (three 64-row tiles, several key tiles),
    the last also over int8 and fp8 pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU "
                    "interpret mode)")
    from repro_torch.kernels import kv_quant as tkq
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    rng = np.random.default_rng(0)
    for B, W, nb, bs, HQ, HKV, dh, pos in (
            (3, 3, 4, 8, 6, 3, 33, (0, 13, 31)),
            (4, 3, 5, 16, 32, 4, 64, (32, 48, 71, 0)),
            (4, 40, 16, 16, 32, 8, 128, (100, 150, 30, 0))):
        kp, vp, tables = _pools(rng, B, nb, bs, HKV, dh, [p + 1 for p in pos])
        kt, vt = (torch.from_numpy(a).cuda().to(dtype) for a in (kp, vp))
        tt = torch.from_numpy(tables).cuda()
        q = torch.from_numpy(rng.standard_normal((B, W, HQ, dh)).astype(
            np.float32)).cuda().to(dtype)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(nb * bs, device="cuda")[None] <= pt[:, None]
        torch.testing.assert_close(
            tpd.paged_decode_attention(q[:, 0], kt, vt, tt, valid),
            tref.paged_decode_attention_ref(q[:, 0], kt, vt, tt, valid),
            atol=tol, rtol=tol)
        start = torch.clamp(pt - 2, min=0)
        torch.testing.assert_close(
            tpp.paged_prefill_attention(q, kt, vt, tt, start),
            tref.paged_prefill_attention_ref(q, kt, vt, tt, start),
            atol=tol, rtol=tol)
        if dh != 128:
            continue
        for kvd in ("int8", "fp8"):
            store = tkq.storage_dtype(kvd, torch.float32)
            pools = []
            for f in (torch.from_numpy(kp).cuda(), torch.from_numpy(vp).cuda()):
                s = tkq.block_scales(f.abs().amax(dim=(1, 3)), store)
                pools += [tkq.quantize(f, s[:, None, :, None], store), s]
            kq, ks, vq, vs = pools
            torch.testing.assert_close(
                tpp.paged_prefill_attention(q, kq, vq, tt, start, ks, vs),
                tref.paged_prefill_attention_ref(q, kq, vq, tt, start, ks=ks,
                                                 vs=vs),
                atol=tol, rtol=tol)

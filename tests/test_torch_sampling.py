"""Threefry sampling in the port on the CPU, against jax.random and the
JAX package's sampler, and the sampled engine's invariants.

``repro_torch.core.prng`` must reproduce jax 0.9.0's bits (with
``jax_threefry_partitionable`` on, its default): keys, ``fold_in``,
``split``, 32-bit ``random_bits`` and uniforms bit for bit. The Gumbel
noise goes through ``log`` twice, which may round differently in torch and
XLA: it is held to |diff| <= 1e-6 * max(1, |noise|), and a drawn token is
held equal to JAX's wherever the winner of logits + noise leads the runner
up by more than 1e-5. Key chains never depend on logits, so every key the
engine leaves behind must equal JAX's chain bit for bit.

Engine invariants (tests/test_serve.py:253-292 and :437-458, held to the
port's own streams): a request's sampled stream is a function of (request,
seed) only — slot count, backend, step discipline and admission time are
invisible — every sampled token lies in the top-k of its step's logits,
and the chunked engine's EOS trimming and sampling equal the two-phase
engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SamplingConfig, make_sampler, preset  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import (ModelOptions, decode_step,  # noqa: E402
                                init_params, prefill)
from repro_torch.serve import ServeEngine, synthetic_requests  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48
SC = SamplingConfig(temperature=0.7, top_k=16, seed=42)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64 and int(t.min()) >= 0
    assert int(t.max()) <= 0xFFFFFFFF
    return t.numpy().astype(np.uint32)


def _jkeys(keys: torch.Tensor):
    return jnp.asarray(_u32(keys))


# ---------------------------------------------------------------------------
# prng against jax.random
# ---------------------------------------------------------------------------

def test_partitionable_threefry_is_on():
    """The bits the port matches are those of partitionable threefry."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_keys_fold_in_split_bit_exact(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(key), np.asarray(jkey))
    folded = []
    for rid in (0, 1, 7, 1000, 2 ** 32 - 1):
        k = prng.fold_in(key, rid)
        np.testing.assert_array_equal(_u32(k), jax.random.fold_in(jkey, rid))
        folded.append(k)
        np.testing.assert_array_equal(
            _u32(SamplingConfig(seed=seed).request_key(rid)),
            jax.random.fold_in(jkey, rid))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_u32(prng.split(key, num)),
                                      jax.random.split(jkey, num))
    # a batch of keys splits row by row, as jax.vmap(split)
    keys = torch.stack(folded)
    want = jax.vmap(lambda k: jax.random.split(k, 2))(_jkeys(keys))
    np.testing.assert_array_equal(_u32(prng.split(keys)), want)


@pytest.mark.parametrize("shape", [(1,), (7,), (256,), (3, 33)])
@pytest.mark.parametrize("seed", [0, 42])
def test_bits_and_uniform_bit_exact(seed, shape):
    key = prng.fold_in(prng.PRNGKey(seed), 3)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    np.testing.assert_array_equal(
        _u32(prng.random_bits(key, shape)),
        jax.random.bits(jkey, shape, jnp.uint32))
    np.testing.assert_array_equal(prng.uniform(key, shape).numpy(),
                                  jax.random.uniform(jkey, shape))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(key, shape, minval=prng.TINY).numpy(),
        jax.random.uniform(jkey, shape, minval=tiny, maxval=1.0))
    # a batch of keys draws row by row, as jax.vmap(bits)
    keys = torch.stack([prng.fold_in(key, r) for r in range(3)])
    want = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(
        _jkeys(keys))
    np.testing.assert_array_equal(_u32(prng.random_bits(keys, shape)), want)


def _margin_mask(perturbed: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Rows whose argmax leads the runner up by more than ``tol``."""
    top2 = np.sort(perturbed, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > tol


def test_gumbel_and_categorical():
    rng = np.random.default_rng(0)
    keys = torch.stack([prng.fold_in(prng.PRNGKey(5), r) for r in range(16)])
    jk = _jkeys(keys)
    V = 4096
    got = prng.gumbel(keys, (V,)).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk))
    assert (np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(want))).all()
    logits = (3 * rng.standard_normal((16, V))).astype(np.float32)
    toks = prng.categorical(keys, torch.from_numpy(logits)).numpy()
    jtoks = np.asarray(jax.vmap(jax.random.categorical)(
        jk, jnp.asarray(logits)))
    sure = _margin_mask(logits + want)
    assert sure.sum() >= 14
    np.testing.assert_array_equal(toks[sure], jtoks[sure])


@pytest.mark.parametrize("top_k", [0, 5, CFG.vocab_size])
def test_make_sampler_matches_jax(top_k):
    """Four chained sampler steps over fresh logits: keys bit-exact at every
    step, tokens equal wherever the draw is not a near-tie."""
    from repro.core.step import SamplingConfig as JSampling
    from repro.core.step import make_sampler as jmake
    rng = np.random.default_rng(top_k)
    B, V = 6, CFG.vocab_size
    sc = SamplingConfig(temperature=0.7, top_k=top_k, seed=3)
    tsample = make_sampler(sc)
    jsample = jax.jit(jmake(JSampling(temperature=0.7, top_k=top_k, seed=3)))
    keys = torch.stack([sc.request_key(r) for r in range(B)])
    jkeys = _jkeys(keys)
    checked = 0
    for _ in range(4):
        logits = (2 * rng.standard_normal((B, V))).astype(np.float32)
        toks, keys = tsample(torch.from_numpy(logits), keys)
        subs = jax.vmap(lambda k: jax.random.split(k, 2)[1])(jkeys)
        jtoks, jkeys = jsample(jnp.asarray(logits), jkeys)
        np.testing.assert_array_equal(_u32(keys), jkeys)
        # the noise JAX drew, on the logits JAX drew from
        lg = logits / np.float32(0.7)
        if top_k:
            kth = np.sort(lg, axis=-1)[:, -top_k][:, None]
            lg = np.where(lg >= kth, lg, -np.inf)
        noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
            subs))
        sure = _margin_mask(lg + noise)
        checked += int(sure.sum())
        assert toks.dtype == torch.int32
        np.testing.assert_array_equal(toks.numpy()[sure],
                                      np.asarray(jtoks)[sure])
        if top_k:
            assert all(int(t) in np.argsort(logits[b])[-top_k:]
                       for b, t in enumerate(toks.tolist()))
    assert checked >= 20
    greedy = make_sampler(SamplingConfig())
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    toks, same = greedy(logits, keys)
    assert same is keys and toks.tolist() == logits.argmax(-1).tolist()


# ---------------------------------------------------------------------------
# the sampled engine
# ---------------------------------------------------------------------------

def final_keys(eng) -> dict:
    """rid -> the key its slot held when the request finished (recorded
    by wrapping ``_finalize``, a device-side copy)."""
    keys, fin = {}, eng._finalize

    def finalize(slot, now_fn):
        keys[eng.sched.active[slot].req.rid] = eng.kv.keys[slot].clone()
        return fin(slot, now_fn)
    eng._finalize = finalize
    return keys


def _streams(params, reqs, linkage=None, n_slots=2, load="closed", **kw):
    eng = ServeEngine(CFG, params, OPTS, linkage or preset("byp"),
                      n_slots=n_slots, max_len=MAX_LEN, **kw)
    keys = final_keys(eng)
    comps, _ = eng.run(reqs, load=load)
    assert len(comps) == len(reqs)
    return {c.rid: c.tokens.tolist() for c in comps}, keys


def _jax_chain(seed: int, rid: int, n: int) -> np.ndarray:
    k = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
    for _ in range(n):
        k = jax.random.split(k, 2)[0]
    return np.asarray(k)


@pytest.mark.parametrize("kw", [dict(), dict(kv="paged", block_size=8),
                                dict(chunked=True, chunk_budget=5)])
def test_engine_final_keys_follow_the_jax_chain(params, kw):
    """One key split per token drawn (one per program at L2): a request's
    last key is split^n(fold_in(PRNGKey(seed), rid))[0] for its n tokens,
    bit for bit with JAX, on each backend and step discipline."""
    reqs = synthetic_requests(5, prompt_len=8, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=2)
    got, keys = _streams(params, reqs, sampling=SC, **kw)
    assert set(keys) == {r.rid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(
            _u32(keys[r.rid]), _jax_chain(SC.seed, r.rid, len(got[r.rid])))


def test_sampling_replays_across_schedules(params):
    """Per-request key chains make the streams a function of (request,
    seed) only: slot count, backend, step discipline and (open-loop)
    admission time are invisible."""
    reqs = synthetic_requests(5, prompt_len=8, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=2)
    a, _ = _streams(params, reqs, sampling=SC)
    runs = [_streams(params, reqs, n_slots=4, sampling=SC)[0],
            _streams(params, reqs, n_slots=3, sampling=SC, kv="paged",
                     block_size=8)[0],
            _streams(params, reqs, sampling=SC, chunked=True,
                     chunk_budget=5)[0],
            _streams(params, reqs, n_slots=1, sampling=SC)[0]]
    arrivals = [dataclasses.replace(r, arrival_s=0.002 * i)
                for i, r in enumerate(reqs)]
    runs.append(_streams(params, arrivals, sampling=SC, load="open")[0])
    assert all(r == a for r in runs)
    greedy, _ = _streams(params, reqs)
    assert a != greedy                         # it actually sampled


def test_sampling_top_k_respects_support(params):
    """Every sampled token lies in the top-k of the logits of its step,
    replayed sequentially on the plain model over the sampled prefix."""
    k = 4
    sc = SamplingConfig(temperature=1.5, top_k=k, seed=0)
    req = synthetic_requests(1, prompt_len=8, max_new_tokens=6,
                             vocab_size=CFG.vocab_size, seed=8)[0]
    got, _ = _streams(params, [req], preset("base"), n_slots=1, sampling=sc)
    logits, cache = prefill(params, torch.from_numpy(req.prompt)[None], CFG,
                            OPTS, max_len=MAX_LEN)
    for tok in got[req.rid]:
        assert tok in torch.topk(logits[0], k).indices.tolist()
        logits, cache = decode_step(params, cache,
                                    torch.tensor([tok], dtype=torch.int32),
                                    CFG, OPTS)


def test_chunked_eos_and_sampling_match_two_phase(params):
    """EOS trims at the same host sync points, and the serve program's
    sampler splits the key chains as the two-phase admission and decode
    do: chunked vs two-phase is invisible in the streams."""
    reqs = synthetic_requests(3, prompt_len=8, max_new_tokens=8,
                              vocab_size=CFG.vocab_size, seed=6)
    greedy, _ = _streams(params, reqs, preset("base"))
    want = greedy[0]
    stop_at = next(i for i in range(1, 8) if want.index(want[i]) == i)
    reqs_eos = [dataclasses.replace(r, eos_id=int(want[stop_at]))
                for r in reqs]
    two_phase, _ = _streams(params, reqs_eos, preset("base"))
    chunked, _ = _streams(params, reqs_eos, preset("base"), chunked=True,
                          chunk_budget=5)
    assert chunked == two_phase and len(chunked[0]) == stop_at + 1
    a, _ = _streams(params, reqs, sampling=SC)
    b, _ = _streams(params, reqs, sampling=SC, chunked=True, chunk_budget=5)
    assert a == b and a != greedy

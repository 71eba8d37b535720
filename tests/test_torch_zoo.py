"""The model zoo's remainder in the port against the JAX package, at smoke
size on the CPU: qwen2-7b (QKV bias, GQA), h2o-danube-1.8b (sliding
window), mistral-large-123b, kimi-k2-1t-a32b and mixtral-8x7b (MoE),
musicgen-medium (embedding inputs, no embedding table) and
llama-3.2-vision-11b (a gated cross-attention layer in every fifth).

Weights cross once, through ``repro_torch.convert.params_from_jax``; the
QKV biases are drawn nonzero and every cross-attention gate is set to 0.5
in the JAX tree first (JAX inits both at zero, which hides them). The
token ids, frame embeddings and context embeddings are seeded numpy, the
same for both. Teacher-forced: each decode step of both models is fed the
JAX model's greedy token (the next seeded frame for musicgen), so logits
are compared step by step. float32, JAX at ``attn_impl="ref"``; atol 1e-4
(observed ~1e-6: the frameworks sum in other orders).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import ModelOptions as TOpts  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import slotify as tslotify  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ATOL = 1e-4
TOPTS = TOpts(attn_impl="ref", dtype=torch.float32)
ZOO = ["qwen2-7b", "h2o-danube-1.8b", "mistral-large-123b",
       "kimi-k2-1t-a32b", "musicgen-medium", "llama-3.2-vision-11b",
       "mixtral-8x7b"]
#: the cross-attention gate both trees get (tanh(0.5) ~ 0.46)
XGATE = 0.5


def _jopts():
    from repro.models import ModelOptions
    return ModelOptions(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)


def _jax_params(jcfg, seed=0):
    """JAX's init with the QKV biases drawn nonzero and every ``xgate`` at
    ``XGATE``."""
    from repro.models import init_params
    p = init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for group in p["blocks"]:
        g = group["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in g:
                g[name] = g[name] + rng.standard_normal(
                    g[name].shape).astype(np.float32) * 0.1
        if "xgate" in g:
            g["xgate"] = jnp.full_like(g["xgate"], XGATE)
    return p


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX config, port config, JAX parameters, port parameters) of a
    smoke config, made once a worker."""
    from repro.configs import get_config
    jcfg = get_config(name).smoke()
    jp = _jax_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tget(name).smoke(), jp, tp


@pytest.fixture(params=ZOO)
def model(request):
    return _model(request.param)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _inputs(cfg, B, S, seed):
    """Seeded numpy inputs of S positions: token ids (B, S), or frame
    embeddings (B, S, D) x 0.1 for an ``embeds_in`` model; and the
    cross-attention context (B, ctx_len, ctx_dim) x 0.1, or None."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_in:
        x = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(
            np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    xctx = None
    if cfg.xattn_ctx_len:
        xctx = (rng.standard_normal((B, cfg.xattn_ctx_len, cfg.xattn_ctx_dim))
                * 0.1).astype(np.float32)
    return x, xctx


# ---------------------------------------------------------------------------
# the registry's data and the weights
# ---------------------------------------------------------------------------

def test_params_from_jax_round_trips(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == tcfg.num_layers
    assert ("embed" in tp) == (not tcfg.embeds_in)
    if "embed" in tp:
        np.testing.assert_array_equal(tp["embed"].numpy(),
                                      np.asarray(jp["embed"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(),
                                  np.asarray(jp["lm_head"]))
    P = len(jcfg.block_pattern)
    for i, layer in enumerate(tp["layers"]):
        blk = jp["blocks"][i % P]
        for group, leaves in layer.items():
            assert set(leaves) == set(blk[group])
            for name, t in leaves.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(blk[group][name])[i // P])


def test_init_params_count_and_structure(model):
    """``param_count()`` equals the port's own init element count (JAX's
    ``test_param_count_matches_init``), and the init has the converted JAX
    tree's structure and shapes: the cross-attention weights and gate (at
    zero), no embed table for embedding inputs."""
    jcfg, tcfg, _, want = model
    got = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(p):
        if isinstance(p, dict):
            return {k: shapes(v) for k, v in p.items()}
        if isinstance(p, list):
            return [shapes(v) for v in p]
        return tuple(p.shape)

    assert shapes(got) == shapes(want)
    n = sum(t.numel() for t in jax.tree.leaves(got))
    assert n == tcfg.param_count() == jcfg.param_count()
    for layer in got["layers"]:
        if "xgate" in layer["mixer"]:
            assert torch.equal(layer["mixer"]["xgate"], torch.zeros(1))


def test_full_size_param_counts_match_published():
    """The configs reproduce the published model sizes (JAX's
    ``test_full_size_param_counts_match_published``, with danube's 1.8 B
    and mixtral's 46.7 B beside them)."""
    expect = {
        "tinyllama-1.1b": (1.10e9, 0.03),
        "qwen2-7b": (7.62e9, 0.03),
        "h2o-danube-1.8b": (1.83e9, 0.03),
        "mistral-large-123b": (122.6e9, 0.03),
        "kimi-k2-1t-a32b": (1.04e12, 0.05),
        "jamba-v0.1-52b": (51.6e9, 0.05),
        "rwkv6-7b": (8.0e9, 0.1),
        "mixtral-8x7b": (46.7e9, 0.01),
    }
    for arch, (want, tol) in expect.items():
        got = tget(arch).param_count()
        assert abs(got - want) / want < tol, (arch, got, want)
    assert abs(tget("kimi-k2-1t-a32b").active_param_count() - 31e9) < 3e9
    assert abs(tget("mixtral-8x7b").active_param_count() - 12.9e9) < 0.2e9


# ---------------------------------------------------------------------------
# the model: prefill + teacher-forced decode, uniform and slotted
# ---------------------------------------------------------------------------

def _teacher_forced(model, S, max_len, steps=8, true_len=None):
    """Prefill, then ``steps`` decode steps in both frameworks; the port
    decodes through the uniform step and, from a slotified copy of its
    cache, the slotted step, each fed the JAX model's greedy token (or the
    next seeded frame)."""
    from repro.models import decode_step, prefill
    jcfg, tcfg, jp, tp = model
    x, xctx = _inputs(tcfg, 2, S + steps, seed=S + max_len)
    jkw, tkw = {}, {}
    if xctx is not None:
        jkw["xctx"], tkw["xctx"] = jnp.asarray(xctx), torch.from_numpy(xctx)
    if true_len is not None:
        jkw["true_len"], tkw["true_len"] = jnp.asarray(true_len), true_len
    jl, jc = prefill(jp, jnp.asarray(x[:, :S]), jcfg, _jopts(),
                     max_len=max_len, **jkw)
    tl, tc = TT.prefill(tp, torch.from_numpy(x[:, :S]), tcfg, TOPTS,
                        max_len=max_len, **tkw)
    _close(tl, jl)
    ts = tslotify(tc)
    first = S if true_len is None else true_len
    for i in range(steps):
        if tcfg.embeds_in:
            nxt = x[:, first + i]
        else:
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode_step(jp, jc, jnp.asarray(nxt), jcfg, _jopts())
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcfg, TOPTS)
        sl, ts = TT.decode_step_slots(tp, ts, torch.from_numpy(nxt), tcfg,
                                      TOPTS)
        _close(tl, jl)
        _close(sl, jl)


def test_prefill_and_decode_teacher_forced(model):
    """12 prompt positions, 8 decode steps: danube's 16-key window binds
    from the fifth step (its circular buffer wraps)."""
    _teacher_forced(model, S=12, max_len=24)


def test_embedding_inputs_pass_through_contiguous():
    """musicgen's embeddings pass through ``embed`` unchanged but
    contiguous, a strided slice included: the CUDA kernels take contiguous
    rows (the rmsnorm kernel refused a slice of a longer sequence on the
    card)."""
    _, tcfg, _, tp = _model("musicgen-medium")
    x, _ = _inputs(tcfg, 2, 12, seed=1)
    xt = torch.from_numpy(x)
    for view in (xt[:, :8], xt[:, 9][:, None]):
        assert not view.is_contiguous()
        h = TT.embed(tp, view, tcfg, TOPTS)
        assert h.is_contiguous() and torch.equal(h, view)


def test_vision_bucketed_prefill_true_len():
    """A right-padded bucket with ``true_len`` on the cross-attention
    model: logits at true_len - 1, the cache fixed up, decode continues
    (JAX allows XATTN there, ``transformer.py:579``)."""
    _teacher_forced(_model("llama-3.2-vision-11b"), S=16, max_len=24,
                    steps=2, true_len=11)


def test_cross_attention_layer_matches_jax():
    """One cross-attention layer, full sequence and one-token decode from
    the cache, against JAX's ``attention`` and ``attention_decode_slots``
    with a nonzero gate; the ``xctx``-less call raises."""
    from repro.models import layers as JL
    jcfg, tcfg, jp, tp = _model("llama-3.2-vision-11b")
    lj = {k: v[0] for k, v in jp["blocks"][0]["mixer"].items()}
    lt = tp["layers"][0]["mixer"]
    spec_j, spec_t = jcfg.block_pattern[0], tcfg.block_pattern[0]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    _, xctx = _inputs(tcfg, 2, 1, seed=6)
    pos = np.arange(9, dtype=np.int32)
    want = JL.attention(lj, jnp.asarray(x), jcfg, spec_j, _jopts(),
                        jnp.asarray(pos), jnp.asarray(xctx))
    _close(TL.attention(lt, torch.from_numpy(x), tcfg, spec_t, TOPTS,
                        torch.from_numpy(pos), torch.from_numpy(xctx)), want)
    with pytest.raises(ValueError, match="xctx"):
        TL.attention(lt, torch.from_numpy(x), tcfg, spec_t, TOPTS,
                     torch.from_numpy(pos))
    # decode: a slot cache holding 4 keys and the context's K/V
    xk, xv = TL.xattn_kv(lt, torch.from_numpy(xctx), tcfg, torch.float32)
    T, hkv, dh = 8, tcfg.n_kv_heads, tcfg.head_dim
    kv = rng.standard_normal((2, 2, T, hkv, dh)).astype(np.float32)
    slot_pos = np.where(np.arange(T) < 4, np.arange(T), -1).astype(np.int32)
    cache_np = {"k": kv[0], "v": kv[1], "xk": xk.numpy(), "xv": xv.numpy(),
                "slot_pos": np.stack([slot_pos] * 2),
                "pos": np.array([4, 4], np.int32)}
    x1 = x[:, :1]
    want, _ = JL.attention_decode_slots(
        lj, jnp.asarray(x1), {k: jnp.asarray(v) for k, v in cache_np.items()},
        jcfg, spec_j, _jopts())
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    _close(TL.attention_decode_slots(lt, torch.from_numpy(x1), cache_t, tcfg,
                                     spec_t, TOPTS), want)

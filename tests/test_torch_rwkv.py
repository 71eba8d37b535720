"""The port's RWKV path against the JAX package's, at small size on the CPU.

Seeded numpy inputs go through both packages:

- the recurrence: ``rwkv_scan_ref`` (and the ``ops.rwkv_scan`` wrapper on
  CPU tensors, which runs it) against JAX's oracle ``kernels/ref.py``
  (atol 1e-4, rtol 1e-5) and the Pallas ``rwkv_scan`` under
  ``interpret=True`` (JAX's own 5e-4 / 5e-3), at tests/test_kernels.py's
  shapes; the final state against JAX ``layers.rwkv_scan_ref``'s
  ``S_last`` (1e-4);
- the layers: ``_rwkv_gates``, ``rwkv``, ``rwkv_decode`` and ``rwkv_mix``
  against JAX's on ``params_from_jax``-converted smoke weights, float32
  (1e-5) and bfloat16 (2e-2);
- the model: the smoke rwkv6-7b's prefill logits and cache against JAX
  ``prefill`` at scan_impl "ref" and "chunked" (JAX's serving prefill runs
  the chunked scan under "pallas"), then 4 teacher-forced decode steps
  (1e-4); decode equals the prefill of one more token;
- the slot cache: ``slotify`` and ``write_slot`` on a cache of recurrent
  state; paged KV, bucketed prompts and ``true_len`` raise ``ValueError``
  (the slotted engine's streams against the sequential reference run in
  tests/test_torch_serve.py, over its ``ARCHS``);
- the init: structure, scales, and the published config's 8.05 B
  parameters counted on the meta device.

The test marked ``cuda`` holds the kernel against its plain version on the
card and skips here (``python -m pytest --noconftest -m cuda
tests/test_torch_rwkv.py`` there; JAX is imported only inside the tests
that compare against it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import LinkageConfig  # noqa: E402
from repro_torch.core import preset as tpreset  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.models import ModelOptions as TOpts  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve import slotify as tslotify  # noqa: E402
from repro_torch.serve.cache import write_slot  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ARCH = "rwkv6-7b"
F32, BF16 = "float32", "bfloat16"
TCFG = tget(ARCH).smoke()
TOPTS = TOpts(attn_impl="ref", dtype=torch.float32)
#: the port's option pairs for the prefill: "ref" against JAX "ref", the
#: shortcut's "kernel" (the plain version on the CPU) against JAX
#: "chunked", which JAX's prefill runs for "pallas" (transformer.py:758)
PREFILL_IMPLS = {"ref": "ref", "kernel": "chunked"}
MAX_LEN = 32


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else \
        x.detach().float().numpy()


def _scan_inputs(B, S, nh, hd, seed):
    """r, k, v (B,S,nh,hd) unit normals, w = exp(-exp(n - 2)) in (0, 1)
    and u (nh,hd) at 0.5, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    shape = (B, S, nh, hd)
    return (n(*shape), n(*shape), n(*shape),
            np.exp(-np.exp(n(*shape) - 2)).astype(np.float32),
            n(nh, hd) * np.float32(0.5))


# ---------------------------------------------------------------------------
# the recurrence (Pallas rwkv6.py:75)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,nh,hd,chunk", [
    (2, 70, 3, 16, 16),
    (1, 64, 2, 32, 64),
    (2, 31, 1, 64, 8),
])
def test_rwkv_scan_ref_matches_pallas_and_oracles(B, S, nh, hd, chunk):
    import jax.numpy as jnp
    from repro.kernels import ref as kref
    from repro.kernels.rwkv6 import rwkv_scan
    from repro.models import layers as JL
    arrs = _scan_inputs(B, S, nh, hd, seed=B * 100 + S)
    js = [jnp.asarray(a) for a in arrs]
    ts = [torch.from_numpy(a) for a in arrs]
    oracle = np.asarray(kref.rwkv_scan_ref(*js))
    pallas = np.asarray(rwkv_scan(*js, chunk=chunk, interpret=True))
    _, s_last = JL.rwkv_scan_ref(*js)
    y, state = tref.rwkv_scan_ref(*ts)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (B, S, nh, hd) and state.shape == (B, nh, hd, hd)
    wy, wstate = tops.rwkv_scan(*ts)
    assert torch.equal(wy, y) and torch.equal(wstate, state)
    np.testing.assert_allclose(y.numpy(), oracle, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), pallas, atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_last), atol=1e-4,
                               rtol=0)


def test_rwkv_scan_wrapper_counts_no_launch_on_the_cpu():
    tops.reset_launch_counts()
    r, k, v, w, u = (torch.from_numpy(a) for a in _scan_inputs(1, 5, 2, 8, 0))
    y, state = tops.rwkv_scan(r, k, v, w, u)
    assert tops.launch_counts().get("rwkv_scan", 0) == 0
    # an empty sequence: no output rows, the zero state
    y0, s0 = tops.rwkv_scan(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    assert y0.shape == (1, 0, 2, 8) and not s0.any()
    # the state after S tokens carries the (S+1)-th token's output
    y1, _ = tops.rwkv_scan(*(t[:, :1] for t in (r, k, v, w)), u)
    torch.testing.assert_close(y1, y[:, :1], atol=0, rtol=0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tops.rwkv_scan(r, k, v, w, u.to("meta"))


# ---------------------------------------------------------------------------
# the layers (layers.py:712-731, 966-1118)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    jcfg = jget(ARCH).smoke()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _pair(a: np.ndarray, dt: str):
    import jax.numpy as jnp
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


LAYER_TOL = {F32: dict(atol=1e-5, rtol=1e-5), BF16: dict(atol=2e-2,
                                                           rtol=2e-2)}


@pytest.mark.parametrize("dt", [F32, BF16])
def test_rwkv_layers_match_jax(smoke_model, dt):
    """Layer 1's weights (block 1 of the JAX stack) on x (2,12,64): the
    gates, the full-sequence time mix (port "ref" against JAX "ref", the
    port's "kernel" against JAX "pallas", the Pallas kernel interpreted),
    one decode step on a random state, and the channel mix."""
    import jax
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import layers as JL
    from repro.models.transformer import _shift_right as jshift
    jcfg, jp, tp = smoke_model
    jmix = jax.tree.map(lambda a: a[1], jp["blocks"][0]["mixer"])
    jmlp = jax.tree.map(lambda a: a[1], jp["blocks"][0]["mlp"])
    tmix, tmlp = tp["layers"][1]["mixer"], tp["layers"][1]["mlp"]
    tol = LAYER_TOL[dt]
    rng = np.random.default_rng(21)
    xj, xt = _pair(rng.standard_normal((2, 12, 64)).astype(np.float32), dt)
    sj, st = jshift(xj), TT._shift_right(xt)
    np.testing.assert_array_equal(_np(st), np.asarray(sj, np.float32))

    for got, want in zip(TL._rwkv_gates(tmix, xt, st, TCFG),
                         JL._rwkv_gates(jmix, xj, sj, jcfg)):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)

    jdt = jnp.bfloat16 if dt == BF16 else jnp.float32
    for impl, jimpl in (("ref", "ref"), ("kernel", "pallas")):
        want = np.asarray(JL.rwkv(jmix, xj, sj, jcfg,
                                  JOpts(scan_impl=jimpl, dtype=jdt)),
                          np.float32)
        out, state = TL.rwkv(tmix, xt, st, TCFG,
                             TOpts(scan_impl=impl, dtype=xt.dtype))
        assert out.dtype == xt.dtype and state.shape == (2, 4, 16, 16)
        np.testing.assert_allclose(_np(out), want, **tol)

    state0 = (rng.standard_normal((2, 4, 16, 16)) * 0.3).astype(np.float32)
    shift0 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    x1j, x1t = xj[:, :1], xt[:, :1]
    s0j, s0t = _pair(shift0, dt)
    jout, jcache = JL.rwkv_decode(jmix, x1j, {"state": jnp.asarray(state0),
                                              "shift": s0j}, jcfg)
    cache = {"state": torch.from_numpy(state0.copy()), "shift": s0t.clone()}
    tout = TL.rwkv_decode(tmix, x1t, cache, TCFG)
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32),
                               **tol)
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(jcache["state"]),
                               **tol)
    assert torch.equal(cache["shift"], x1t)

    np.testing.assert_allclose(
        _np(TL.rwkv_mix(tmlp, xt, st)),
        np.asarray(JL.rwkv_mix(jmlp, xj, sj), np.float32), **tol)


def test_rwkv_group_norm_is_the_population_variance():
    """``_rwkv_out`` normalises each head by ``jnp.var``'s ddof-0 variance:
    with a unit scale, a gate of 1 and an identity ``wo``, each head of the
    output has mean 0 and population variance var / (var + 1e-5)."""
    d, hd = TCFG.d_model, TCFG.rwkv_head_dim
    y = torch.randn(1, 3, d, generator=torch.Generator().manual_seed(0))
    params = {"ln_scale": torch.ones(d), "wo": torch.eye(d)}
    out = TL._rwkv_out(params, y, torch.ones(1, 3, d), y, TCFG)
    yh = y.reshape(1, 3, d // hd, hd)
    heads = out.reshape(1, 3, d // hd, hd)
    var = yh.var(-1, correction=0)
    torch.testing.assert_close(heads.mean(-1), torch.zeros_like(var),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(heads.var(-1, correction=0),
                               var / (var + 1e-5), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model: the smoke rwkv6-7b, prefill + teacher-forced decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", list(PREFILL_IMPLS))
def test_smoke_model_teacher_forced(smoke_model, impl):
    """Prefill 13 tokens (two rows), then 4 decode steps fed JAX's greedy
    tokens, through the uniform and the slotted decode: logits within 1e-4
    of JAX's, the cache's state within 1e-4, its shifts and pos exact."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import decode_step, prefill
    jcfg, jp, tp = smoke_model
    jopts = JOpts(attn_impl="ref", scan_impl=PREFILL_IMPLS[impl],
                  scan_chunk=8, dtype=jnp.float32)
    topts = (tpreset("nss_shortcut").model_options(TOPTS)
             if impl == "kernel" else TOPTS)
    assert topts.scan_impl == impl
    toks = np.random.default_rng(4).integers(0, TCFG.vocab_size, (2, 13),
                                             dtype=np.int32)
    jl, jc = prefill(jp, jnp.asarray(toks), jcfg, jopts, max_len=MAX_LEN)
    tl, tc = TT.prefill(tp, torch.from_numpy(toks), TCFG, topts,
                        max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for layer, g in enumerate(tc):
        want = {k: np.asarray(v[layer]) for k, v in jc[0].items()}
        assert set(g) == set(want) == {"state", "shift", "shift_mlp", "pos"}
        np.testing.assert_allclose(g["state"].numpy(), want["state"],
                                   atol=1e-4, rtol=0)
        for k in ("shift", "shift_mlp"):
            np.testing.assert_allclose(g[k].numpy(), want[k], atol=1e-5,
                                       rtol=0)
        assert int(g["pos"]) == int(want["pos"]) == 13
    ts = tslotify(tc)
    tc = [{k: v.clone() for k, v in g.items()} for g in tc]
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode_step(jp, jc, jnp.asarray(nxt), jcfg, jopts)
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(nxt), TCFG, topts)
        sl, ts = TT.decode_step_slots(tp, ts, torch.from_numpy(nxt), TCFG,
                                      topts)
        for got in (tl, sl):
            np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=0)
    assert ts[0]["pos"].tolist() == [17, 17] and int(tc[1]["pos"]) == 17


def test_decode_matches_prefill_of_one_more_token():
    """One-token decode against the prefill cache == the prefill of the
    sequence one token longer (tests/test_models.py:76, the port alone)."""
    tp = TT.init_params(TCFG, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, TCFG.vocab_size, (2, 25), dtype=np.int32))
    _, cache = TT.prefill(tp, toks[:, :24], TCFG, TOPTS, max_len=MAX_LEN)
    dec, _ = TT.decode_step(tp, cache, toks[:, 24], TCFG, TOPTS)
    full, _ = TT.prefill(tp, toks, TCFG, TOPTS, max_len=MAX_LEN)
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=0)


def test_backbone_matches_jax_forward(smoke_model):
    """The full-sequence forward (``apply_layer``: the train path's layer)
    against JAX's ``backbone``, at the shortcut (the kernel wrapper)."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models.transformer import backbone, embed
    jcfg, jp, tp = smoke_model
    toks = np.random.default_rng(8).integers(0, TCFG.vocab_size, (2, 10),
                                             dtype=np.int32)
    jopts = JOpts(attn_impl="ref", scan_impl="pallas", dtype=jnp.float32)
    pos = jnp.arange(10, dtype=jnp.int32)
    jh, _ = backbone(jp, embed(jp, jnp.asarray(toks), jcfg, jopts), jcfg,
                     jopts, pos, None)
    topts = tpreset("nss_shortcut").model_options(TOPTS)
    th = TT.backbone(tp, TT.embed(tp, torch.from_numpy(toks), TCFG, topts),
                     TCFG, topts, torch.arange(10))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the slotted engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return TT.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")


def test_slot_cache_of_an_rwkv_model(params):
    """``slotify`` reads the batch off the state (there is no K and no
    ``slot_pos``) and gives each row its ``pos``; ``write_slot`` replaces
    every leaf of the row."""
    _, c2 = TT.prefill(params, torch.zeros((2, 6), dtype=torch.int32), TCFG,
                       TOPTS, max_len=MAX_LEN)
    s2 = tslotify(c2)
    assert set(s2[0]) == {"state", "shift", "shift_mlp", "pos"}
    assert s2[0]["pos"].tolist() == [6, 6]
    _, c1 = TT.prefill(params, torch.ones((1, 3), dtype=torch.int32), TCFG,
                       TOPTS, max_len=MAX_LEN)
    write_slot(s2, tslotify(c1), 1)
    for g, one in zip(s2, c1):
        assert g["pos"].tolist() == [6, 3]
        for k in ("state", "shift", "shift_mlp"):
            assert torch.equal(g[k][1], one[k][0])
            assert not torch.equal(g[k][0], one[k][0])


@pytest.mark.parametrize("how", ["paged", "paged-launcher", "bucketed",
                                 "true_len"])
def test_non_slotted_rwkv_raises(params, how):
    """Paged KV and bucketed prefill need attention layers: on RWKV they
    raise ``ValueError`` with JAX's advice to use the slotted backend."""
    if how == "true_len":
        with pytest.raises(ValueError, match="mlp='rwkv_mix'"):
            TT.prefill(params, torch.zeros((1, 8), dtype=torch.int32), TCFG,
                       TOPTS, max_len=MAX_LEN, true_len=5)
    elif how == "paged":
        with pytest.raises(ValueError, match="slotted KV backend"):
            ServeEngine(TCFG, params, TOPTS, tpreset("byp"), n_slots=2,
                        max_len=MAX_LEN, kv="paged")
    elif how == "paged-launcher":
        from repro_torch.launch import serve as launch
        with pytest.raises(ValueError, match="slotted KV backend"):
            launch.main(["--device", "cpu", "--arch", ARCH, "--kv", "paged",
                         "--requests", "1"])
    else:
        from repro_torch.launch import serve as launch
        with pytest.raises(ValueError, match="true_len"):
            launch.main(["--device", "cpu", "--arch", ARCH,
                         "--bucket-prompts", "--requests", "1",
                         "--prompt-len", "5", "--gen-len", "2"])


def test_launcher_serves_rwkv(capsys):
    import json
    from repro_torch.launch import serve as launch
    launch.main(["--device", "cpu", "--arch", ARCH, "--load", "open",
                 "--requests", "3", "--prompt-len", "6", "--gen-len", "4",
                 "--slots", "2"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["arch"] == ARCH + "-smoke" and rep["requests"] == 3
    assert rep["total_tokens"] == 12 and rep["dtype"] == "float32"


# ---------------------------------------------------------------------------
# the init and the conversion
# ---------------------------------------------------------------------------

def _shapes(p):
    if isinstance(p, dict):
        return {k: _shapes(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_shapes(v) for v in p]
    return tuple(p.shape)


def test_init_rwkv_structure_and_scales(smoke_model):
    """The port's own init has the JAX tree's structure; at width 512 the
    projections are N(0, 1/D), ``ww`` 0.01, ``u`` 0.5, the MLP's ``wv``
    1/sqrt(F), the decay bias -6, the mixes 0.5, the norm scale 1."""
    _, _, want = smoke_model
    got = TT.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(got) == _shapes(want)
    wide = dataclasses.replace(TCFG, d_model=512, d_ff=1024)
    gen = torch.Generator().manual_seed(1)
    m, c = TL.init_rwkv(gen, wide, "cpu"), TL.init_rwkv_mix(gen, wide, "cpu")
    assert m["u"].shape == (32, 16)
    for p, name, std in ((m, "wr", 512 ** -0.5), (m, "wg", 512 ** -0.5),
                         (m, "ww", 0.01), (m, "wo", 512 ** -0.5),
                         (m, "u", 0.5), (c, "wk", 512 ** -0.5),
                         (c, "wv", 1024 ** -0.5), (c, "wr", 512 ** -0.5)):
        assert abs(float(p[name].std()) / std - 1.0) < 0.05, name
    assert bool((m["w_bias"] == -6.0).all())
    assert all(bool((p[k] == 0.5).all()) for p, k in
               [(m, "mix_" + n) for n in "rkvwg"] + [(c, "mix_k"),
                                                     (c, "mix_r")])
    assert bool((m["ln_scale"] == 1.0).all())


def test_full_config_counts_8_05_billion_parameters():
    """rwkv6-7b at its published widths, its layer built on the meta
    device (nothing allocated): the tensors' sizes add up to
    ``param_count()``, 8.05 B, 32.2 GB in float32."""
    cfg = tget(ARCH)
    assert (cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff, cfg.num_layers) == (
        4096, 64, 14336, 32)
    layer = TT.init_layer(torch.Generator(), cfg, TT.layer_specs(cfg)[0],
                          "meta")
    per_layer = sum(t.numel() for g in layer.values() for t in g.values())
    total = (per_layer * cfg.num_layers + 2 * cfg.vocab_size * cfg.d_model
             + cfg.d_model)
    assert total == cfg.param_count() == 8_054_640_640
    assert layer["mixer"]["u"].shape == (64, 64)


def test_params_from_jax_carries_an_rwkv_tree(smoke_model):
    """Every mixer and MLP key crosses, ``u`` split per block to (nh, hd),
    the values exact."""
    _, jp, tp = smoke_model
    assert set(tp["layers"][0]["mixer"]) == {
        "wr", "wk", "wv", "wg", "ww", "wo", "w_bias", "u", "mix_r", "mix_k",
        "mix_v", "mix_w", "mix_g", "ln_scale"}
    assert set(tp["layers"][0]["mlp"]) == {"wk", "wv", "wr", "mix_k",
                                           "mix_r"}
    for b in range(TCFG.num_blocks):
        u = tp["layers"][b]["mixer"]["u"]
        assert u.shape == (4, 16)
        np.testing.assert_array_equal(
            u.numpy(), np.asarray(jp["blocks"][0]["mixer"]["u"][b]))


def test_linkage_shortcut_selects_the_scan_kernel():
    assert tpreset("nss_shortcut").model_options(TOPTS).scan_impl == "kernel"
    assert tpreset("nss").model_options(TOPTS).scan_impl == "ref"
    assert LinkageConfig().model_options(TOPTS) == TOPTS


# ---------------------------------------------------------------------------
# on the card: the scan kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU "
                    "interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_rwkv_scan_matches_plain(cuda):
    from repro_torch import resolve_device
    resolve_device("cuda")                          # TF32 off
    cases = [(1, 32, 64, 64), (2, 70, 3, 16), (1, 64, 2, 32), (2, 31, 1, 64),
             (2, 1, 3, 16), (1, 5, 2, 100), (1, 9, 2, 128), (1, 6, 2, 192),
             (2, 4, 2, 256)]
    for (B, S, nh, hd), dtype in [(c, torch.float32) for c in cases] + [
            ((1, 32, 64, 64), torch.bfloat16), ((1, 6, 2, 192), torch.bfloat16),
            ((2, 4, 2, 256), torch.bfloat16)]:
        ins = [torch.from_numpy(a).to(cuda)
               for a in _scan_inputs(B, S, nh, hd, seed=S)]
        # bfloat16 r, k, v, w (u stays float32): widened in the kernel, as
        # the plain version widens them, so the float32 gates hold
        ins = [t.to(dtype) for t in ins[:4]] + ins[4:]
        tops.reset_launch_counts()
        y, state = tops.rwkv_scan(*ins)
        assert tops.launch_counts()["rwkv_scan"] == 1
        want_y, want_s = tref.rwkv_scan_ref(*ins)
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(state, want_s, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(tops.rwkv_scan(*ins)[0], y, atol=0,
                                   rtol=0)
    r, k, v, w, u = (t.float() for t in ins)
    with pytest.raises(TypeError, match="one dtype"):
        tops.rwkv_scan(r.bfloat16(), k, v, w, u)
    with pytest.raises(ValueError, match="contiguous"):
        tops.rwkv_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       w, u)
    big = torch.zeros(1, 2, 1, 513, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tops.rwkv_scan(big, big, big, big, torch.zeros(1, 513, device=cuda))

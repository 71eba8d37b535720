"""The port's MoE path against the JAX package's, at small size on the CPU.

Seeded numpy inputs go through both packages:

- the router: ``moe_route_ref`` (and the ``ops.moe_route`` wrapper on CPU
  tensors, which runs it) against the Pallas ``moe_route`` under
  ``interpret=True``, at tests/test_kernels.py's shapes and at
  moonshot-v1-16b-a3b's (D 2048, E 64, k 6; N 4 for a decode microstep
  and 32 for an admission), in float32 and bfloat16, with an exact-tie case:
  gates within 1e-5, indices equal;
- the layer: ``layers.moe`` against JAX ``L.moe``, the port's "ref" against
  JAX's "ref" and the port's "kernel" against JAX's "pallas", at a length
  where capacity drops tokens, on the smoke config (4 experts, top-2) and on
  a narrow variant with the published 64 experts, top-6: output and aux
  within 1e-5 in float32 (absolute plus relative: at the JAX init's
  expert std of 1/sqrt(E) = 0.5 at E 4 outputs reach ~30, where a float32
  ulp is 2e-6); in bfloat16 the "ref" routing equals
  ``lax.top_k`` on tied probabilities;
- the model: the smoke moonshot converted by ``params_from_jax``, prefill
  and 4 teacher-forced decode steps, logits within 1e-4, both option pairs;
- the init: structure, scales (the 1/sqrt(E) expert std) and the bfloat16
  parameter dtype.

The test marked ``cuda`` holds the router kernel against its plain version
on the card and skips here (``python -m pytest --noconftest -m cuda
tests/test_torch_moe.py`` there; JAX is imported only inside the tests
that compare against it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import preset as tpreset  # noqa: E402
from repro_torch.kernels import moe_route as troute  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.models import ModelOptions as TOpts  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import slotify as tslotify  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ARCH = "moonshot-v1-16b-a3b"
F32, BF16 = "float32", "bfloat16"
#: the port's option pairs: "ref" against JAX "ref", the shortcut's
#: "kernel" (the router's plain version on the CPU) against JAX "pallas"
IMPLS = {"ref": "ref", "kernel": "pallas"}


def _pair(a: np.ndarray, dt: str = F32):
    """One numpy array as (jax array, torch tensor) of dtype ``dt``."""
    import jax.numpy as jnp
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else \
        x.detach().float().numpy()


# ---------------------------------------------------------------------------
# the router (Pallas moe_route.py:47)
# ---------------------------------------------------------------------------

ROUTE_SHAPES = [(100, 64, 16, 4), (64, 32, 8, 1), (33, 16, 4, 2),
                (4, 2048, 64, 6), (32, 2048, 64, 6)]


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("N,D,E,K", ROUTE_SHAPES)
def test_moe_route_ref_matches_pallas(N, D, E, K, dt):
    from repro.kernels.moe_route import moe_route
    rng = np.random.default_rng(N * 7 + E)
    xj, xt = _pair(rng.standard_normal((N, D)).astype(np.float32), dt)
    wj, wt = _pair((rng.standard_normal((D, E)) * 0.1).astype(np.float32),
                   dt)
    gj, ij = moe_route(xj, wj, K, block_n=32, interpret=True)
    for fn in (tref.moe_route_ref, tops.moe_route):
        g, i = fn(xt, wt, K)
        assert g.dtype == torch.float32 and i.dtype == torch.int32
        assert g.shape == i.shape == (N, K)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_moe_route_exact_ties_go_to_the_lowest_index(dt):
    """Small integers in x and a router whose columns come in equal pairs:
    every logit is exact in any summation order and every probability
    appears twice, so each pair is a tie that the lower index wins — in
    the Pallas kernel and in the plain version alike."""
    from repro.kernels.moe_route import moe_route
    rng = np.random.default_rng(3)
    N, D, E, K = 20, 16, 16, 6
    x = rng.integers(-2, 3, (N, D)).astype(np.float32)
    half = rng.integers(-2, 3, (D, E // 2)).astype(np.float32) * 0.25
    w = np.repeat(half, 2, axis=1)                 # columns 2j, 2j+1 equal
    xj, xt = _pair(x, dt)
    wj, wt = _pair(w, dt)
    gj, ij = moe_route(xj, wj, K, interpret=True)
    g, i = tref.moe_route_ref(xt, wt, K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-6, rtol=0)
    idx = i.numpy()
    # each winner's twin follows it directly, the even (lower) one first
    assert (idx[:, 0::2] % 2 == 0).all()
    np.testing.assert_array_equal(idx[:, 1::2], idx[:, 0::2] + 1)
    np.testing.assert_array_equal(g.numpy()[:, 0::2], g.numpy()[:, 1::2])


def test_top_k_stable_matches_lax_top_k_on_ties():
    """The "ref" routing's top-k: bfloat16 probabilities drawn from a few
    values, so every row ties; the stable descending sort orders ties as
    ``lax.top_k`` does (lower index first)."""
    from jax import lax
    rng = np.random.default_rng(0)
    p = rng.choice(np.array([0.5, 0.25, 0.125, 0.0625], np.float32),
                   (64, 16))
    pj, pt = _pair(p, BF16)
    for k in (1, 2, 6, 16):
        vj, ij = lax.top_k(pj, k)
        v, i = TL.top_k_stable(pt, k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(_np(v), np.asarray(vj, np.float32))
    assert all(len(set(row)) < len(row) for row in p)   # every row ties


def test_moe_route_wrapper_splits_d_as_the_kernel_checks():
    """The wrapper's launch (``route_geometry``) is one the kernel takes:
    whole D slices of ``rows`` rows, none empty (the kernel refuses a
    split count that is not ceil(D / rows)), whole 32- or 64-row chunks
    above the decode sizes; small N splits D, N 16384 at D 2048 does
    not."""
    for N in (1, 4, 16, 17, 32, 64, 65, 100, 264, 1000, 4096, 70000):
        for D in (1, 16, 64, 127, 128, 129, 1000, 2048, 4095, 8192, 100000):
            for E, size in ((64, 2), (64, 4), (384, 2), (100, 4)):
                g = troute.route_geometry(N, D, E, size, True)
                assert g.splits == -(-D // g.rows), (N, D, g)
                assert (g.splits - 1) * g.rows < D, (N, D, g)
                if g.mode != "decode":
                    assert g.rows % troute.CHUNK[g.mode] == 0, (N, D, g)
    assert troute.route_geometry(4, 2048, 64, 2, True).splits == 16
    assert troute.route_geometry(4096, 2048, 64, 2, True).splits == 3
    assert troute.route_geometry(8192, 2048, 64, 2, True).splits == 2
    assert troute.route_geometry(16384, 2048, 64, 2, True).splits == 1


def test_moe_route_wrapper_counts_no_launch_on_the_cpu():
    tops.reset_launch_counts()
    x, w = torch.zeros(3, 8), torch.zeros(8, 4)
    g, i = tops.moe_route(x, w, 2)
    assert tops.launch_counts().get("moe_route", 0) == 0
    assert i.tolist() == [[0, 1]] * 3            # all equal: lowest first
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tops.moe_route(x, w.to("meta"), 2)


# ---------------------------------------------------------------------------
# the layer (layers.py:750-818)
# ---------------------------------------------------------------------------

#: the smoke config (E 4, K 2) and a narrow variant with the published
#: E 64, K 6
LAYER_VARIANTS = {"smoke": {}, "e64k6": dict(num_experts=64, top_k=6)}


def _layer_cfgs(variant):
    from repro.configs import get_config as jget
    jcfg, tcfg = jget(ARCH).smoke(), tget(ARCH).smoke()
    if LAYER_VARIANTS[variant]:
        over = LAYER_VARIANTS[variant]
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **over))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **over))
    return jcfg, tcfg


def _moe_params(cfg, rng, router_scale=0.5):
    """Numpy MoE parameters at the JAX init's scales, the router wider than
    the init's 0.02 so routing is skewed and capacity drops tokens."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"router": n(d, e) * router_scale, "wi": n(e, d, f) / np.sqrt(e),
            "wg": n(e, d, f) / np.sqrt(e), "wo": n(e, f, d) / np.sqrt(f)}


def _dropped(tcfg, idx, S):
    """Assignments past their expert's capacity in the (s, k) order, for
    routing ``idx`` (B, S, K) in one group per sequence."""
    E, K = tcfg.moe.num_experts, tcfg.moe.top_k
    C = min(max(int(S * K * tcfg.moe.capacity_factor / E), 1), S)
    loads = np.stack([np.bincount(r.ravel(), minlength=E) for r in idx])
    return int(np.clip(loads - C, 0, None).sum())


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("variant", list(LAYER_VARIANTS))
def test_moe_layer_matches_jax(variant, impl):
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import layers as JL
    jcfg, tcfg = _layer_cfgs(variant)
    rng = np.random.default_rng(11)
    B, S = 2, 24
    p = _moe_params(tcfg, rng)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    yj, auxj = JL.moe({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), jcfg,
                      JOpts(attn_impl="ref", scan_impl=IMPLS[impl],
                            dtype=jnp.float32))
    opts = TOpts(attn_impl="ref", scan_impl=impl, dtype=torch.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    yt, auxt = TL.moe_with_aux(tp, torch.from_numpy(x), tcfg, opts)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), atol=1e-5, rtol=0)
    assert torch.equal(TL.moe(tp, torch.from_numpy(x), tcfg, opts), yt)
    _, idx = TL._route(tp["router"], torch.from_numpy(x), tcfg.moe.top_k,
                       opts)
    assert _dropped(tcfg, idx.numpy(), S) > 0       # capacity bit


def test_moe_layer_bf16_ref_routing_is_lax_top_k():
    """bfloat16 "ref" routing: the probabilities are cast to bfloat16
    before the top-k, where they tie often; the port's indices and gates
    are ``lax.top_k``'s on the same probabilities."""
    import jax.numpy as jnp
    from jax import lax
    _, tcfg = _layer_cfgs("e64k6")
    rng = np.random.default_rng(5)
    p = _moe_params(tcfg, rng, router_scale=0.02)   # near-uniform: ties
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    opts = TOpts(attn_impl="ref", scan_impl="ref", dtype=torch.bfloat16)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gates, idx = TL._route(tp["router"], xt, tcfg.moe.top_k, opts)
    probs = TL.router_probs(tp["router"], xt, opts)
    assert probs.dtype == torch.bfloat16
    pj = jnp.asarray(_np(probs)).astype(jnp.bfloat16)
    gj, ij = lax.top_k(pj, tcfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_np(gates), np.asarray(gj, np.float32))
    srt = np.sort(_np(probs), axis=-1)[..., ::-1][..., :tcfg.moe.top_k + 1]
    assert (np.diff(srt, axis=-1) == 0).any()        # ties were there
    yt = TL.moe({k: v.to(torch.bfloat16) for k, v in tp.items()}, xt, tcfg,
                opts)
    assert yt.dtype == torch.bfloat16 and bool(torch.isfinite(yt).all())


def test_serving_moe_forms_no_router_probabilities(monkeypatch):
    """Under the router kernel the serving layer (``moe``, what
    ``mlp_block`` calls) routes with the kernel alone: the (N, E)
    probabilities, which only the aux loss reads, are never formed."""
    _, tcfg = _layer_cfgs("e64k6")
    rng = np.random.default_rng(3)
    tp = {k: torch.from_numpy(v) for k, v in _moe_params(tcfg, rng).items()}
    x = torch.from_numpy(rng.standard_normal((2, 8, tcfg.d_model))
                         .astype(np.float32))
    opts = TOpts(attn_impl="ref", scan_impl="kernel", dtype=torch.float32)
    want = TL.moe_with_aux(tp, x, tcfg, opts)[0]

    def boom(*a, **k):
        raise AssertionError("router_probs on the serving path")

    monkeypatch.setattr(TL, "router_probs", boom)
    assert torch.equal(TL.moe(tp, x, tcfg, opts), want)


@pytest.mark.parametrize("moe_group,want_gs", [(4096, 24), (10, 8), (5, 4)])
def test_moe_group_is_the_largest_divisor(moe_group, want_gs, monkeypatch):
    """Groups are the largest divisor of S not above the group size
    (``MOE_GROUP``), as in JAX with that ``moe_group`` (the output then
    matches JAX's at that grouping)."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import layers as JL
    jcfg, tcfg = _layer_cfgs("smoke")
    rng = np.random.default_rng(2)
    p = _moe_params(tcfg, rng)
    x = rng.standard_normal((1, 24, tcfg.d_model)).astype(np.float32)
    seen = []
    orig = TL._route

    def spy(router, xt, K, opts):
        seen.append(tuple(xt.shape))
        return orig(router, xt, K, opts)

    monkeypatch.setattr(TL, "_route", spy)
    monkeypatch.setattr(TL, "MOE_GROUP", moe_group)
    yt = TL.moe({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), tcfg,
                TOpts(attn_impl="ref", dtype=torch.float32))
    assert seen == [(24 // want_gs, want_gs, tcfg.d_model)]
    yj, _ = JL.moe({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                   jcfg, JOpts(attn_impl="ref", scan_impl="ref",
                               dtype=jnp.float32, moe_group=moe_group))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)


def test_expert_matmul_copies_no_weight():
    """The expert products run over E with the weight in its stored
    layout: the batched product reads the parameter's own storage."""
    E, G, C, a, b = 4, 3, 2, 8, 5
    w = torch.randn(E, a, b)
    xe = torch.randn(G, E, C, a)
    want = torch.einsum("gecd,edf->gecf", xe, w)
    seen = []
    orig = torch.bmm

    def spy(x, y):
        seen.append(y.data_ptr())
        return orig(x, y)

    torch.bmm = spy
    try:
        got = TL._expert_matmul(xe, w)
    finally:
        torch.bmm = orig
    torch.testing.assert_close(got, want)
    assert seen == [w.data_ptr()]


# ---------------------------------------------------------------------------
# the model: the smoke moonshot, prefill + teacher-forced decode
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


@pytest.mark.parametrize("impl", list(IMPLS))
def test_smoke_model_teacher_forced(smoke_model, impl):
    """Prefill 12 tokens (capacity 7 of 24 assignments per expert), then 4
    decode steps fed JAX's greedy tokens, through the uniform and the
    slotted decode; logits within 1e-4 of JAX's."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import decode_step, prefill
    jcfg, jp, tp = smoke_model
    tcfg = tget(ARCH).smoke()
    jopts = JOpts(attn_impl="ref", scan_impl=IMPLS[impl], dtype=jnp.float32)
    base = TOpts(attn_impl="ref", dtype=torch.float32)
    topts = (tpreset("nss_shortcut").model_options(base) if impl == "kernel"
             else base)
    assert topts.scan_impl == impl
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jl, jc = prefill(jp, jnp.asarray(toks), jcfg, jopts, max_len=20)
    tl, tc = TT.prefill(tp, torch.from_numpy(toks), tcfg, topts, max_len=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    ts = tslotify(tc)
    tc = [{k: v.clone() for k, v in g.items()} for g in tc]
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode_step(jp, jc, jnp.asarray(nxt), jcfg, jopts)
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcfg, topts)
        sl, ts = TT.decode_step_slots(tp, ts, torch.from_numpy(nxt), tcfg,
                                      topts)
        for got in (tl, sl):
            np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=0)


def test_smoke_model_bucketed_prefill_pads_like_jax(smoke_model):
    """A right-padded bucket with ``true_len``: the padding takes capacity
    in JAX's MoE, and in the port's the same way."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import prefill
    jcfg, jp, tp = smoke_model
    tcfg = tget(ARCH).smoke()
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.random.default_rng(9).integers(0, tcfg.vocab_size, 11)
    jl, _ = prefill(jp, jnp.asarray(toks), jcfg,
                    JOpts(attn_impl="ref", scan_impl="ref",
                          dtype=jnp.float32),
                    max_len=24, true_len=jnp.asarray(11))
    tl, _ = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                       TOpts(attn_impl="ref", dtype=torch.float32),
                       max_len=24, true_len=11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the init and the conversion
# ---------------------------------------------------------------------------

def _shapes(p):
    if isinstance(p, dict):
        return {k: _shapes(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_shapes(v) for v in p]
    return tuple(p.shape)


def test_init_moe_structure_and_scales(smoke_model):
    """The port's own init has the JAX tree's structure; the (E, D, F)
    experts keep JAX's ``fan_in = shape[0]`` std 1/sqrt(E), 0.125 at the
    published E 64; the router N(0, 0.02²), wo 1/sqrt(F)."""
    _, _, want = smoke_model
    tcfg = tget(ARCH).smoke()
    got = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(got) == _shapes(want)
    _, wide = _layer_cfgs("e64k6")
    wide = dataclasses.replace(wide, d_model=256, d_ff=96)
    m = TL.init_moe(torch.Generator().manual_seed(1), wide, "cpu")
    assert m["wi"].shape == (64, 256, 96) and m["wo"].shape == (64, 96, 256)
    for name, std in (("wi", 0.125), ("wg", 0.125), ("router", 0.02),
                      ("wo", 96 ** -0.5)):
        assert abs(float(m[name].std()) / std - 1.0) < 0.05, name


def test_init_params_bf16_casts_every_float_leaf():
    """``param_dtype=bfloat16`` casts every float32 draw as JAX's
    ``init_params(key, cfg, param_dtype)`` does; the values are the float32
    draws rounded (same generator state)."""
    tcfg = tget(ARCH).smoke()
    f32 = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b16 = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                         param_dtype=torch.bfloat16)

    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from pairs(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                yield from pairs(x, y)
        else:
            yield a, b
    n = 0
    for a, b in pairs(f32, b16):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
        n += 1
    assert n == 2 + 2 * (2 + 4 + 4) + 1


def test_params_from_jax_carries_a_bf16_moe_tree():
    """A JAX tree initialised with ``param_dtype=bfloat16`` (ml_dtypes
    leaves) converts exactly, and stays bfloat16."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    jcfg = jget(ARCH).smoke()
    jp = jinit(jax.random.PRNGKey(1), jcfg, param_dtype=jax.numpy.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mlp = tp["layers"][1]["mlp"]
    assert set(mlp) == {"router", "wi", "wg", "wo"}
    assert mlp["wi"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(mlp["wi"]), np.asarray(jp["blocks"][0]["mlp"]["wi"][1],
                                   np.float32))
    assert all(t.dtype == torch.bfloat16 for t in
               (tp["embed"], tp["lm_head"], tp["layers"][0]["mlp"]["router"],
                tp["layers"][0]["norm1"]["scale"]))


def test_linkage_shortcut_selects_the_router_kernel():
    opts = tpreset("nss_shortcut").model_options(TOpts())
    assert opts.scan_impl == "kernel" and opts.attn_impl == "kernel"
    assert tpreset("byp").model_options(TOpts()).scan_impl == "ref"
    with pytest.raises(ValueError, match="scan_impl"):
        TOpts(scan_impl="pallas")


# ---------------------------------------------------------------------------
# on the card: the router kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU "
                    "interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_moe_route_matches_plain(cuda, dtype):
    from repro_torch import resolve_device
    resolve_device("cuda")                          # TF32 off
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    for N, D, E, K in [(4, 2048, 64, 6), (33, 16, 4, 2), (100, 64, 16, 4),
                       (1, 100, 8, 8)]:
        x = torch.randn(N, D, generator=g, device=cuda).to(dtype)
        w = (torch.randn(D, E, generator=g, device=cuda) * 0.1).to(dtype)
        got, gi = tops.moe_route(x, w, K)
        want, wi = tref.moe_route_ref(x, w, K)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        assert torch.equal(gi, wi), (N, D, E, K)
    x = torch.randint(-2, 3, (20, 16), generator=g, device=cuda).to(dtype)
    w = (torch.randint(-2, 3, (16, 8), generator=g, device=cuda) * 0.25
         ).to(dtype).repeat_interleave(2, dim=1)
    got, gi = tops.moe_route(x, w, 6)
    assert torch.equal(gi, tref.moe_route_ref(x, w, 6)[1])
    assert bool((gi[:, 0::2] % 2 == 0).all())
    # kimi-k2's router (D 7168, E 384, top-8), past the old E <= 256
    x = torch.randn(4, 7168, generator=g, device=cuda).to(dtype)
    w = (torch.randn(7168, 384, generator=g, device=cuda) * 0.02).to(dtype)
    got, gi = tops.moe_route(x, w, 8)
    want, wi = tref.moe_route_ref(x, w, 8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(gi, wi)
    with pytest.raises(ValueError, match="the kernel takes"):
        tops.moe_route(torch.zeros(2, 8, device=cuda),
                       torch.zeros(8, 4, device=cuda), 5)       # k > E

"""The port's Mamba path against the JAX package's, at small size on the CPU.

Seeded numpy inputs go through both packages:

- the scan: ``mamba_scan_ref`` (and the ``ops.mamba_scan`` wrapper on CPU
  tensors, which runs it) against JAX's oracles ``kernels/ref.py`` (y) and
  ``layers.mamba_scan_ref`` (y and the final state), at
  tests/test_kernels.py's shapes plus one more at ds 16, float32 and
  bfloat16 alike within atol 1e-4, rtol 1e-5 (an associative scan against
  a sequential one: both form ``dt·x`` in the inputs' dtype); against
  ``layers.mamba_scan_chunked`` (y and the final state) and the Pallas
  ``mamba_scan`` under ``interpret=True``, which both widen ``dt·x`` to
  float32 first in bfloat16 (the Pallas kernel by its casts, the chunked
  scan through XLA's excess precision inside the jitted loop): float32
  within 1e-4 / 1e-5 (Pallas: JAX's own 5e-4 / 5e-3), bfloat16 within
  2e-2 (that one rounding, up to 0.95 % of 1 + |y| here), and the plain
  version fed the widened product within 1e-4 / 1e-5;
- the layers: ``_mamba_gates``, ``mamba`` (output, final state, conv state)
  and ``mamba_decode`` against JAX's on JAX-initialised weights, float32
  (1e-5) and bfloat16 (2e-2), on the smoke config (ds 4, d_conv 2) and on a
  narrow config with the published ``MambaConfig(16, 4, 2)`` (a 3-row conv
  state, ds 16), at S = 1 and 2 (shorter than d_conv - 1: the conv state
  keeps rows of the zero pad) and 33;
- the model: the smoke jamba-v0.1-52b (2 blocks: Mamba, attention, dense
  and MoE layers) and its narrow-Mamba variant converted by
  ``params_from_jax``, prefill logits and cache against JAX ``prefill`` at
  scan_impl "ref" and "chunked" (JAX's serving prefill runs the chunked
  scan under "pallas"), then 4 teacher-forced decode steps against JAX's
  ``decode_step_slots`` (1e-4); decode equals the prefill of one more
  token; the full-sequence forward against JAX's ``backbone``;
- the slot cache: ``slotify`` and ``write_slot`` carry the conv and scan
  states, and admission overwrites both; paged KV, bucketed prompts and
  ``true_len`` raise ``ValueError`` (the slotted engine's streams against
  the sequential reference run in tests/test_torch_serve.py, over its
  ``ARCHS``);
- the init: structure, distributions and the bfloat16 parameter dtype, and
  the published config's 13.295 B (1 block) and 51.57 B (4 blocks)
  parameters counted on the meta device.

The tests marked ``cuda`` hold the kernel against its plain version on the
card and skip here (``python -m pytest --noconftest -m cuda
tests/test_torch_mamba.py`` there; JAX is imported only inside the tests
that compare against it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import DENSE, LayerSpec, MambaConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
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

ARCH = "jamba-v0.1-52b"
F32, BF16 = "float32", "bfloat16"
TCFG = tget(ARCH).smoke()
#: the smoke config with the published Mamba widths: d_state 16, d_conv 4
NARROW = MambaConfig(d_state=16, d_conv=4, expand=2)
CONFIGS = {"smoke": TCFG.mamba, "narrow": NARROW}
TOPTS = TOpts(attn_impl="ref", dtype=torch.float32)
#: the port's option pairs for the prefill: "ref" against JAX "ref", the
#: shortcut's "kernel" (the plain version on the CPU) against JAX
#: "chunked", which JAX's prefill runs for "pallas" (transformer.py:741-752)
PREFILL_IMPLS = {"ref": "ref", "kernel": "chunked"}
MAX_LEN = 32
LAYER_TOL = {F32: dict(atol=1e-5, rtol=1e-5), BF16: dict(atol=2e-2,
                                                           rtol=2e-2)}
SCAN_SHAPES = [(2, 100, 96, 8, 16, 32), (1, 64, 64, 4, 64, 64),
               (2, 33, 128, 16, 8, 32), (1, 24, 256, 16, 8, 128)]


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else \
        x.detach().float().numpy()


def _jcfg(name: str):
    """The JAX smoke jamba with the named Mamba config."""
    from repro.configs import get_config as jget
    from repro.configs.base import MambaConfig as JMamba
    return dataclasses.replace(jget(ARCH).smoke(),
                               mamba=JMamba(**dataclasses.asdict(
                                   CONFIGS[name])))


def _tcfg(name: str):
    return dataclasses.replace(TCFG, mamba=CONFIGS[name])


def _scan_inputs(B, S, di, ds, seed):
    """x at 0.5, dt = softplus(n - 1), A = -exp(0.3 n) (di, ds), B and C
    unit normals, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(B, S, di) * np.float32(0.5),
            np.logaddexp(n(B, S, di) - 1, 0).astype(np.float32),
            -np.exp(n(di, ds) * np.float32(0.3)).astype(np.float32),
            n(B, S, ds), n(B, S, ds))


def _pair(a: np.ndarray, dt: str):
    import jax.numpy as jnp
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# the scan (Pallas mamba_ssm.py:74)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("B,S,di,ds,chunk,dtile", SCAN_SHAPES)
def test_mamba_scan_ref_matches_pallas_and_oracles(B, S, di, ds, chunk,
                                                   dtile, dt):
    from repro.kernels import ref as kref
    from repro.kernels.mamba_ssm import mamba_scan
    from repro.models import layers as JL
    x, d, A, Bv, Cv = _scan_inputs(B, S, di, ds, seed=B * 100 + S + ds)
    (xj, xt), (dj, dtt), (bj, bt), (cj, ct) = (_pair(a, dt)
                                               for a in (x, d, Bv, Cv))
    Aj, At = _pair(A, F32)
    y, h = tref.mamba_scan_ref(xt, dtt, At, bt, ct)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, ds)
    wy, wh = tops.mamba_scan(xt, dtt, At, bt, ct)
    assert torch.equal(wy, y) and torch.equal(wh, h)
    tight = dict(atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(kref.mamba_scan_ref(xj, dj, Aj, bj, cj)),
        **tight)
    jy, jh = JL.mamba_scan_ref(xj, dj, Aj, bj, cj)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tight)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tight)

    # the widened-first contract: the chunked scan and the Pallas kernel
    cy, chl = JL.mamba_scan_chunked(xj, dj, Aj, bj, cj, chunk)
    pallas = np.asarray(mamba_scan(xj, dj, Aj, bj, cj, chunk=chunk,
                                   di_tile=dtile, interpret=True),
                        np.float32)
    wide_y, wide_h = tref.mamba_scan_ref(xt.float(), dtt.float(), At,
                                         bt.float(), ct.float())
    ptol = dict(atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(wide_y.numpy(), np.asarray(cy), **tight)
    np.testing.assert_allclose(wide_h.numpy(), np.asarray(chl), **tight)
    np.testing.assert_allclose(wide_y.numpy(), pallas, **ptol)
    if dt == BF16:
        tight = ptol = dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(y.numpy(), np.asarray(cy), **tight)
    np.testing.assert_allclose(h.numpy(), np.asarray(chl), **tight)
    np.testing.assert_allclose(y.numpy(), pallas, **ptol)


def test_bf16_contract_rounds_dt_x_once():
    """In bfloat16 the plain version forms ``dt·x`` in bfloat16 and widens
    it after (the oracles' contract, which the kernel keeps): its state is
    the float32 recurrence over that rounded product, exactly. The
    product widened first (the Pallas contract) differs on these inputs,
    so the test tells the two apart."""
    x, d, A, Bv, Cv = _scan_inputs(1, 6, 16, 4, seed=7)
    xt, dtt, bt, ct = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (x, d, Bv, Cv))
    At = torch.from_numpy(A)
    y, h = tref.mamba_scan_ref(xt, dtt, At, bt, ct)
    a = torch.exp(dtt.float()[..., None] * At)
    bx = (dtt * xt).float()[..., None] * bt.float()[..., None, :]
    want = torch.zeros(1, 16, 4)
    for t in range(6):
        want = a[:, t] * want + bx[:, t]
    torch.testing.assert_close(h, want, atol=0, rtol=0)
    assert not torch.equal(dtt.float() * xt.float(), (dtt * xt).float())


def test_mamba_scan_wrapper_counts_no_launch_on_the_cpu():
    tops.reset_launch_counts()
    x, d, A, Bv, Cv = (torch.from_numpy(a) for a in _scan_inputs(1, 5, 8, 4,
                                                                 0))
    y, h = tops.mamba_scan(x, d, A, Bv, Cv)
    assert tops.launch_counts().get("mamba_scan", 0) == 0
    # an empty sequence: no output rows, the zero state
    y0, h0 = tops.mamba_scan(x[:, :0], d[:, :0], A, Bv[:, :0], Cv[:, :0])
    assert y0.shape == (1, 0, 8) and h0.shape == (1, 8, 4) and not h0.any()
    # the state after the first token carries the first output
    y1, _ = tops.mamba_scan(x[:, :1], d[:, :1], A, Bv[:, :1], Cv[:, :1])
    torch.testing.assert_close(y1, y[:, :1], atol=0, rtol=0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tops.mamba_scan(x, d, A.to("meta"), Bv, Cv)


# ---------------------------------------------------------------------------
# the layers (layers.py:825-960)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_weights():
    """JAX ``init_mamba`` weights for each config, and the same as torch
    tensors."""
    jax = pytest.importorskip("jax")
    from repro.models import layers as JL
    out = {}
    for name in CONFIGS:
        jp = JL.init_mamba(jax.random.PRNGKey(3), _jcfg(name))
        out[name] = (jp, {k: torch.from_numpy(np.array(v)) for k, v in
                          jp.items()})
    return out


@pytest.mark.parametrize("S", [1, 2, 33])
@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mamba_layers_match_jax(mamba_weights, name, dt, S):
    """On x (2,S,64): the gates and the new conv state, the full-sequence
    layer (port "ref" against JAX "ref", the port's "kernel" against JAX
    "pallas", the Pallas kernel interpreted) with the final scan state
    (against JAX's oracle on JAX's gates) and the conv state, and one
    decode step from a random conv and scan state, updating both in
    place."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import layers as JL
    jcfg, tcfg = _jcfg(name), _tcfg(name)
    jp, tp = mamba_weights[name]
    mc = tcfg.mamba
    di = mc.expand * tcfg.d_model
    tol = LAYER_TOL[dt]
    rng = np.random.default_rng(S * 10 + len(name))
    xj, xt = _pair(rng.standard_normal((2, S, 64)).astype(np.float32), dt)

    jg = JL._mamba_gates(jp, xj, jcfg)
    tg = TL._mamba_gates(tp, xt, tcfg)
    for got, want in zip(tg, jg):
        assert got.dtype == getattr(torch, str(want.dtype))
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)
    assert tg[-1].shape == (2, mc.d_conv - 1, di)
    if S < mc.d_conv - 1:           # the pad's zero rows stay in the state
        assert not tg[-1][:, :mc.d_conv - 1 - S].any()

    jdt, jA, jB, jC, jxc = jg[:5]
    _, jh = JL.mamba_scan_ref(jxc, jdt, jA, jB, jC)
    jdtype = jnp.bfloat16 if dt == BF16 else jnp.float32
    for impl, jimpl in (("ref", "ref"), ("kernel", "pallas")):
        want = np.asarray(JL.mamba(jp, xj, jcfg,
                                   JOpts(scan_impl=jimpl, scan_chunk=8,
                                         dtype=jdtype)), np.float32)
        out, h_last, conv = TL.mamba(tp, xt, tcfg,
                                     TOpts(scan_impl=impl, dtype=xt.dtype))
        assert out.dtype == xt.dtype and h_last.dtype == torch.float32
        np.testing.assert_allclose(_np(out), want, **tol)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), **tol)
        assert torch.equal(conv, tg[-1])

    conv0 = rng.standard_normal((2, mc.d_conv - 1, di)).astype(np.float32)
    ssm0 = (rng.standard_normal((2, di, mc.d_state)) * 0.3).astype(
        np.float32)
    c0j, c0t = _pair(conv0, dt)
    jout, jcache = JL.mamba_decode(jp, xj[:, :1], {"conv": c0j,
                                                   "ssm": jnp.asarray(ssm0)},
                                   jcfg)
    cache = {"conv": c0t.clone(), "ssm": torch.from_numpy(ssm0.copy())}
    tout = TL.mamba_decode(tp, xt[:, :1], cache, tcfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32),
                               **tol)
    for k in ("conv", "ssm"):
        assert cache[k].dtype == (c0t.dtype if k == "conv" else
                                  torch.float32)
        np.testing.assert_allclose(_np(cache[k]),
                                   np.asarray(jcache[k], np.float32), **tol)


# ---------------------------------------------------------------------------
# the model: the smoke jamba-v0.1-52b, prefill + teacher-forced decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_models():
    """(JAX config, JAX params, port params) of the smoke jamba and its
    narrow-Mamba variant."""
    jax = pytest.importorskip("jax")
    from repro.models import init_params as jinit
    out = {}
    for name in CONFIGS:
        jcfg = _jcfg(name)
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
    return out


@pytest.mark.parametrize("impl", list(PREFILL_IMPLS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoke_model_teacher_forced(smoke_models, name, impl):
    """Prefill 13 tokens (two rows), then 4 decode steps fed JAX's greedy
    tokens, through the port's uniform and slotted decode against JAX's
    ``decode_step_slots``: logits within 1e-4 of JAX's, and the cache
    leaves too (the Mamba layers' scan and conv states, the attention
    layer's K/V, which follows four layers of float32 rounding), pos
    exact."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import decode_step_slots, prefill
    from repro.serve.cache import slotify as jslotify
    jcfg, jp, tp = smoke_models[name]
    tcfg = _tcfg(name)
    jopts = JOpts(attn_impl="ref", scan_impl=PREFILL_IMPLS[impl],
                  scan_chunk=8, dtype=jnp.float32)
    topts = (tpreset("nss_shortcut").model_options(TOPTS)
             if impl == "kernel" else TOPTS)
    assert topts.scan_impl == impl
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 13),
                                             dtype=np.int32)
    jl, jc = prefill(jp, jnp.asarray(toks), jcfg, jopts, max_len=MAX_LEN)
    tl, tc = TT.prefill(tp, torch.from_numpy(toks), tcfg, topts,
                        max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    P = len(tcfg.block_pattern)
    for layer, g in enumerate(tc):
        want = {k: np.asarray(v[layer // P])
                for k, v in jc[layer % P].items()}
        assert set(g) == set(want)
        for k in ("ssm", "conv") if "ssm" in g else ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), want[k], atol=1e-4,
                                       rtol=0)
        assert int(g["pos"]) == int(want["pos"]) == 13
    ts = tslotify(tc)
    tc = [{k: v.clone() for k, v in g.items()} for g in tc]
    js = jslotify(jc)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, js = decode_step_slots(jp, js, jnp.asarray(nxt), jcfg, jopts)
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcfg, topts)
        sl, ts = TT.decode_step_slots(tp, ts, torch.from_numpy(nxt), tcfg,
                                      topts)
        for got in (tl, sl):
            np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=0)
    assert ts[0]["pos"].tolist() == [17, 17] and int(tc[1]["pos"]) == 17


@pytest.mark.parametrize("S", [1, 2])
def test_prompt_shorter_than_the_conv(smoke_models, S):
    """A prompt of 1 or 2 tokens under d_conv 4: the prefill's conv state
    holds the zero pad's rows before the prompt's, as JAX's does, and the
    next decode step matches JAX's."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import decode_step, prefill
    jcfg, jp, tp = smoke_models["narrow"]
    tcfg = _tcfg("narrow")
    jopts = JOpts(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)
    toks = np.arange(3, 3 + S, dtype=np.int32)[None]
    jl, jc = prefill(jp, jnp.asarray(toks), jcfg, jopts, max_len=MAX_LEN)
    tl, tc = TT.prefill(tp, torch.from_numpy(toks), tcfg, TOPTS,
                        max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    conv = tc[0]["conv"]
    assert conv.shape == (1, 3, 128) and not conv[:, :3 - S].any()
    assert conv[:, 3 - S:].abs().sum() > 0
    np.testing.assert_allclose(conv.numpy(), np.asarray(jc[0]["conv"][0]),
                               atol=1e-5, rtol=0)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, _ = decode_step(jp, jc, jnp.asarray(nxt), jcfg, jopts)
    tl, _ = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcfg, TOPTS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_prefill_of_one_more_token(name):
    """One-token decode against the prefill cache == the prefill of the
    sequence one token longer (tests/test_models.py:76, the port alone), on
    the jamba pattern with dense MLPs: MoE capacity drops depend on the
    routing group (25 tokens against 2), so a MoE layer breaks the
    identity by design."""
    tcfg = dataclasses.replace(
        _tcfg(name), block_pattern=tuple(LayerSpec(s.mixer, DENSE)
                                         for s in TCFG.block_pattern))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 25), dtype=np.int32))
    _, cache = TT.prefill(tp, toks[:, :24], tcfg, TOPTS, max_len=MAX_LEN)
    dec, _ = TT.decode_step(tp, cache, toks[:, 24], tcfg, TOPTS)
    full, _ = TT.prefill(tp, toks, tcfg, TOPTS, max_len=MAX_LEN)
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=0)


def test_backbone_matches_jax_forward(smoke_models):
    """The full-sequence forward (``apply_layer``: the train path's layer)
    against JAX's ``backbone``, at the shortcut (the kernel wrappers; JAX's
    Pallas scan interpreted)."""
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models.transformer import backbone, embed
    jcfg, jp, tp = smoke_models["narrow"]
    tcfg = _tcfg("narrow")
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 10),
                                             dtype=np.int32)
    jopts = JOpts(attn_impl="ref", scan_impl="pallas", scan_chunk=8,
                  dtype=jnp.float32)
    pos = jnp.arange(10, dtype=jnp.int32)
    jh, _ = backbone(jp, embed(jp, jnp.asarray(toks), jcfg, jopts), jcfg,
                     jopts, pos, None)
    topts = tpreset("nss_shortcut").model_options(TOPTS)
    th = TT.backbone(tp, TT.embed(tp, torch.from_numpy(toks), tcfg, topts),
                     tcfg, topts, torch.arange(10))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the slotted engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return TT.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")


def test_admission_overwrites_the_mamba_state(params):
    """``slotify`` reads the batch off the conv state (a Mamba layer has no
    K and no ``slot_pos``) and gives each row its ``pos``; ``write_slot``
    replaces the row's conv and scan states, so nothing of the request
    that held the slot reaches the next one; the other row keeps its own."""
    _, c2 = TT.prefill(params, torch.zeros((2, 6), dtype=torch.int32), TCFG,
                       TOPTS, max_len=MAX_LEN)
    s2 = tslotify(c2)
    assert set(s2[0]) == {"conv", "ssm", "pos"}
    assert set(s2[4]) == {"k", "v", "slot_pos", "pos"}
    assert s2[0]["pos"].tolist() == [6, 6]
    before = [{k: v.clone() for k, v in g.items()} for g in s2]
    _, c1 = TT.prefill(params, torch.ones((1, 3), dtype=torch.int32), TCFG,
                       TOPTS, max_len=MAX_LEN)
    write_slot(s2, tslotify(c1), 1)
    for g, one, old in zip(s2, c1, before):
        assert g["pos"].tolist() == [6, 3]
        for k in ("conv", "ssm") if "ssm" in g else ("k", "v"):
            assert torch.equal(g[k][1], one[k][0])
            assert torch.equal(g[k][0], old[k][0])
            assert not torch.equal(g[k][1], old[k][1])


@pytest.mark.parametrize("how", ["paged", "paged-launcher", "bucketed",
                                 "true_len"])
def test_non_slotted_mamba_raises(params, how):
    """Paged KV and bucketed prefill need attention layers: on jamba they
    raise ``ValueError`` with JAX's advice to use the slotted backend."""
    if how == "true_len":
        with pytest.raises(ValueError, match="mixer='mamba'"):
            TT.prefill(params, torch.zeros((1, 8), dtype=torch.int32), TCFG,
                       TOPTS, max_len=MAX_LEN, true_len=5)
    elif how == "paged":
        with pytest.raises(ValueError, match="slotted KV backend"):
            ServeEngine(TCFG, params, TOPTS, tpreset("byp"), n_slots=2,
                        max_len=MAX_LEN, kv="paged")
    elif how == "paged-launcher":
        from repro_torch.launch import serve as launch
        with pytest.raises(ValueError, match="mixer='mamba'"):
            launch.main(["--device", "cpu", "--arch", ARCH, "--kv", "paged",
                         "--requests", "1"])
    else:
        from repro_torch.launch import serve as launch
        with pytest.raises(ValueError, match="true_len"):
            launch.main(["--device", "cpu", "--arch", ARCH,
                         "--bucket-prompts", "--requests", "1",
                         "--prompt-len", "5", "--gen-len", "2"])


def test_run_engine_takes_a_config_cut_in_depth():
    """``run_engine`` serves an ``ArchConfig`` in place of a registered
    name, as chip_smoke serves jamba-v0.1-52b cut to one block."""
    from repro_torch.launch import serve as launch
    cfg = dataclasses.replace(TCFG, num_blocks=1)
    rep = launch.run_engine(cfg, "nss_shortcut", smoke=False, device="cpu",
                            n_slots=2, prompt_len=6, gen_len=4, requests=3)
    assert rep["arch"] == cfg.name and rep["requests"] == 3
    assert rep["total_tokens"] == 12 and rep["dtype"] == "float32"


def test_launcher_serves_jamba(capsys):
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


def test_init_mamba_structure_and_distributions(smoke_models):
    """The port's own init has the JAX tree's structure; at width 512 the
    projections are N(0, 1/fan_in) (in_proj 1/D, x_proj 1/di), conv_w
    0.2, dt_proj dt_rank^-1/2, out_proj di^-1/2; A_log = log(1..ds) on
    every channel, D = 1, and softplus(dt_bias) = clip(U(0, 0.1), 1e-3),
    whose mean is 0.05."""
    _, _, want = smoke_models["smoke"]
    got = TT.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(got) == _shapes(want)
    wide = dataclasses.replace(TCFG, d_model=512, mamba=NARROW)
    m = TL.init_mamba(torch.Generator().manual_seed(1), wide, "cpu")
    di, dt_rank = 1024, 32
    assert m["x_proj"].shape == (di, dt_rank + 32)
    assert m["conv_w"].shape == (4, di) and m["dt_proj"].shape == (dt_rank,
                                                                    di)
    for name, std in (("in_proj", 512 ** -0.5), ("x_proj", di ** -0.5),
                      ("conv_w", 0.2), ("dt_proj", dt_rank ** -0.5),
                      ("out_proj", di ** -0.5)):
        assert abs(float(m[name].std()) / std - 1.0) < 0.05, name
        assert abs(float(m[name].mean())) < 0.05 * std, name
    torch.testing.assert_close(
        m["A_log"], torch.log(torch.arange(1.0, 17.0)).expand(di, -1),
        atol=0, rtol=0)
    assert bool((m["D"] == 1.0).all())
    dt0 = torch.nn.functional.softplus(m["dt_bias"])
    assert 1e-3 - 1e-7 <= float(dt0.min()) and float(dt0.max()) <= 0.1 + 1e-7
    assert abs(float(dt0.mean()) - 0.05) < 0.005


def test_bf16_init_casts_every_leaf_as_jax_does():
    """With ``param_dtype`` bfloat16 every Mamba leaf is stored in
    bfloat16, A_log and D included, as JAX's ``init_params`` casts them,
    and ``params_from_jax`` carries a bfloat16 JAX tree leaf for leaf."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import init_params as jinit
    tp = TT.init_params(TCFG, torch.Generator().manual_seed(0), "cpu",
                        param_dtype=torch.bfloat16)
    jp = jinit(jax.random.PRNGKey(0), _jcfg("smoke"),
               param_dtype=jnp.bfloat16)
    cp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for p in (tp, cp):
        mix = p["layers"][0]["mixer"]
        assert set(mix) == {"in_proj", "conv_w", "x_proj", "dt_proj",
                            "dt_bias", "A_log", "D", "out_proj"}
        assert all(t.dtype == torch.bfloat16 for t in mix.values())
    np.testing.assert_array_equal(
        cp["layers"][8]["mixer"]["A_log"].float().numpy(),
        np.asarray(jp["blocks"][0]["mixer"]["A_log"][1], np.float32))


@pytest.mark.parametrize("blocks,total", [(1, 13_295_177_728),
                                          (4, 51_570_085_888)])
def test_full_config_parameter_count(blocks, total):
    """jamba-v0.1-52b at its published widths, its layers built on the
    meta device (nothing allocated): the tensors' sizes add up to
    ``param_count()``, 13.295 B for the one block chip_smoke serves (53.2
    GB in fp32) and 51.57 B for the published 4."""
    cfg = dataclasses.replace(tget(ARCH), num_blocks=blocks)
    assert (cfg.d_model, cfg.d_ff, cfg.mamba.d_state, cfg.mamba.d_conv) == (
        4096, 14336, 16, 4)
    per_block = 0
    for spec in cfg.block_pattern:
        layer = TT.init_layer(torch.Generator(), cfg, spec, "meta")
        per_block += sum(t.numel() for g in layer.values()
                         for t in g.values())
    n = (per_block * blocks + 2 * cfg.vocab_size * cfg.d_model
         + cfg.d_model)
    assert n == cfg.param_count() == total


def test_params_from_jax_carries_a_mamba_tree(smoke_models):
    """Every Mamba key crosses, A_log split per block to (di, ds), the
    values exact; the attention layer sits at pattern position 4."""
    _, jp, tp = smoke_models["narrow"]
    assert set(tp["layers"][0]["mixer"]) == {
        "in_proj", "conv_w", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
        "out_proj"}
    assert set(tp["layers"][4]["mixer"]) == {"wq", "wk", "wv", "wo"}
    for b in range(TCFG.num_blocks):
        a = tp["layers"][8 * b + 1]["mixer"]["A_log"]
        assert a.shape == (128, 16)
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(jp["blocks"][1]["mixer"]["A_log"][b]))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba_scan_matches_plain(cuda, dtype):
    from repro_torch import resolve_device
    resolve_device("cuda")                          # TF32 off
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for B, S, di, ds in [(1, 32, 8192, 16), (2, 100, 96, 8), (1, 64, 64, 4),
                         (2, 33, 128, 16), (2, 1, 96, 8), (1, 40, 100, 16),
                         (4, 20, 64, 16), (2, 17, 70, 5), (1, 9, 40, 32),
                         (2, 9, 72, 64), (1, 9, 48, 128), (1, 0, 64, 16)]:
        x, d, A, Bv, Cv = (torch.from_numpy(a).to(cuda) for a in
                           _scan_inputs(B, S, di, ds, seed=S + ds))
        x, d, Bv, Cv = (t.to(dtype) for t in (x, d, Bv, Cv))
        tops.reset_launch_counts()
        y, h = tops.mamba_scan(x, d, A, Bv, Cv)
        assert tops.launch_counts()["mamba_scan"] == 1
        want_y, want_h = tref.mamba_scan_ref(x, d, A, Bv, Cv)
        torch.testing.assert_close(y, want_y, atol=tol, rtol=tol)
        torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)
        torch.testing.assert_close(tops.mamba_scan(x, d, A, Bv, Cv)[0], y,
                                   atol=0, rtol=0)
    x, d, A, Bv, Cv = (torch.from_numpy(a).to(cuda) for a in
                       _scan_inputs(1, 4, 8, 4, seed=0))
    with pytest.raises(TypeError, match="one dtype"):
        tops.mamba_scan(x.bfloat16(), d, A, Bv, Cv)
    with pytest.raises(TypeError, match="float32"):
        tops.mamba_scan(x, d, A.bfloat16(), Bv, Cv)
    with pytest.raises(ValueError, match="contiguous"):
        tops.mamba_scan(x.transpose(1, 2).contiguous().transpose(1, 2), d, A,
                        Bv, Cv)
    big = torch.zeros(8, 513, device=cuda)
    with pytest.raises(ValueError, match="state sizes"):
        tops.mamba_scan(x, d, big, torch.zeros(1, 4, 513, device=cuda),
                        torch.zeros(1, 4, 513, device=cuda))


@pytest.mark.cuda
def test_cuda_mamba_layer_kernel_matches_plain(cuda):
    """The layer at the shortcut on the card (B and C sliced from x_proj's
    output, made contiguous for the kernel) against its plain path."""
    from repro_torch import resolve_device
    resolve_device("cuda")
    cfg = dataclasses.replace(TCFG, mamba=NARROW)
    p = TL.init_mamba(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    x = torch.randn(2, 33, 64, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    got = TL.mamba(p, x, cfg, TOpts(scan_impl="kernel", dtype=x.dtype))
    want = TL.mamba(p, x, cfg, TOpts(scan_impl="ref", dtype=x.dtype))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)

"""The port's model against the JAX package's, at smoke size on the CPU.

Weights cross once, through ``repro_torch.convert.params_from_jax``; then
the same seeded numpy token ids go through both. Teacher-forced: every
decode step of both models is fed the JAX model's greedy token, so the
logits are compared step by step and never drift apart through a flipped
argmax. Logits in float32 (``attn_impl="ref"`` in JAX) agree to
atol = 1e-4 (observed ~1e-6: the two frameworks sum in other orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import DENSE, SWA, LayerSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import preset as tpreset  # noqa: E402
from repro_torch.models import ModelOptions as TOpts  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import slotify as tslotify  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ATOL = 1e-4
TOPTS = TOpts(attn_impl="ref", dtype=torch.float32)
# the shortcut on the CPU: the kernel wrappers, which run their plain versions
TOPTS_KERNEL = tpreset("nss_shortcut").model_options(TOPTS)

VARIANTS = {
    "tinyllama": {},
    # sliding-window layers with a window shorter than the sequence, plus
    # the qwen2-style QKV bias: the SWA circular cache and the bias paths
    "swa_bias": dict(block_pattern=(LayerSpec(SWA, DENSE),),
                     sliding_window=8, attn_bias=True),
}


def _cfgs(variant):
    from repro.configs import get_config
    from repro.configs.base import LayerSpec as JLayerSpec
    over = dict(VARIANTS[variant])
    jover = dict(over)
    if "block_pattern" in over:
        jover["block_pattern"] = tuple(JLayerSpec(s.mixer, s.mlp)
                                       for s in over["block_pattern"])
    jcfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke(), **jover)
    tcfg = dataclasses.replace(tget("tinyllama-1.1b").smoke(), **over)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    import jax
    from repro.models import init_params
    p = init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.attn_bias:     # JAX inits biases at zero: make them matter
        rng = np.random.default_rng(seed)
        g = p["blocks"][0]["mixer"]
        for name in ("bq", "bk", "bv"):
            g[name] = g[name] + rng.standard_normal(
                g[name].shape).astype(np.float32) * 0.1
    return p


def _jopts():
    import jax.numpy as jnp
    from repro.models import ModelOptions
    return ModelOptions(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jax = pytest.importorskip("jax")
    jcfg, tcfg = _cfgs(request.param)
    jp = _jax_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_params_from_jax_round_trips(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == tcfg.num_layers
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(),
                                  np.asarray(jp["lm_head"]))
    np.testing.assert_array_equal(tp["final_norm"]["scale"].numpy(),
                                  np.asarray(jp["final_norm"]["scale"]))
    for i, layer in enumerate(tp["layers"]):
        for group, leaves in layer.items():
            for name, t in leaves.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jp["blocks"][0][group][name])[i])


def test_params_from_jax_orders_layers_block_major():
    """With a two-position block pattern, layer b*2+p is block b, position p
    (the order the JAX scan runs them in); a tree without lm_head is a
    tied-embedding model."""
    nb = 3
    tree = {"embed": np.zeros((4, 2), np.float32),
            "final_norm": {"scale": np.ones(2, np.float32)},
            "blocks": tuple({"norm1": {"scale": np.stack(
                [np.full(2, 10 * p + b, np.float32) for b in range(nb)])}}
                for p in range(2))}
    tp = params_from_jax(tree, device="cpu")
    assert "lm_head" not in tp
    got = [float(l["norm1"]["scale"][0]) for l in tp["layers"]]
    assert got == [0, 10, 1, 11, 2, 12]


def test_init_params_matches_jax_structure_and_scales():
    """The port's own init (used at full width on the card) has the JAX
    tree's structure, shapes and distributions."""
    jcfg, tcfg = _cfgs("tinyllama")
    import jax
    want = params_from_jax(jax.tree.map(np.asarray, _jax_params(jcfg)),
                           device="cpu")
    got = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(p):
        if isinstance(p, dict):
            return {k: shapes(v) for k, v in p.items()}
        if isinstance(p, list):
            return [shapes(v) for v in p]
        return tuple(p.shape)
    assert shapes(got) == shapes(want)
    d, f = tcfg.d_model, tcfg.d_ff
    l0 = got["layers"][0]
    for w, fan_in in ((l0["mixer"]["wq"], d), (l0["mlp"]["wi"], d),
                      (l0["mlp"]["wo"], f)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert abs(float(got["embed"].std()) / 0.02 - 1.0) < 0.1
    assert torch.equal(l0["norm1"]["scale"], torch.ones(d))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", [16, 7])
def test_rope_matches_jax_including_odd_tail(dh):
    import jax.numpy as jnp
    from repro.models import layers as JL
    x = np.random.default_rng(dh).standard_normal((2, 5, 3, dh)).astype(
        np.float32)
    pos = np.arange(3, 8, dtype=np.int32)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), atol=1e-5)


def test_layers_match_jax(model):
    """rmsnorm (plain and through the kernel wrapper), full-sequence
    attention (with the SWA window / QKV bias of the variant) and the MLP."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(1).standard_normal((2, 12, tcfg.d_model)
                                                  ).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    lj = {g: {k: v[0] for k, v in leaves.items()}
          for g, leaves in jp["blocks"][0].items()}
    lt = tp["layers"][0]
    want = JL.rmsnorm(lj["norm1"], xj, jcfg.norm_eps, _jopts())
    _close(TL.rmsnorm(lt["norm1"], xt, tcfg.norm_eps, TOPTS), want, 1e-5)
    _close(TL.rmsnorm(lt["norm1"], xt, tcfg.norm_eps, TOPTS_KERNEL), want,
           1e-5)
    pos = np.arange(12, dtype=np.int32)
    spec_j, spec_t = jcfg.block_pattern[0], tcfg.block_pattern[0]
    want = JL.attention(lj["mixer"], xj, jcfg, spec_j, _jopts(),
                        jnp.asarray(pos))
    for opts in (TOPTS, TOPTS_KERNEL):
        _close(TL.attention(lt["mixer"], xt, tcfg, spec_t, opts,
                            torch.from_numpy(pos)), want, 1e-5)
    _close(TL.mlp(lt["mlp"], xt), JL.mlp(lj["mlp"], xj), 1e-5)


# ---------------------------------------------------------------------------
# the model: prefill + teacher-forced decode
# ---------------------------------------------------------------------------

def _teacher_forced(model, S, max_len, steps=8, true_len=None,
                    topts=TOPTS):
    """Prefill then ``steps`` decode steps in both frameworks, the port fed
    the JAX model's greedy tokens; the port decodes through the uniform
    step and, from a slotified copy of its cache, the slotted step."""
    import jax.numpy as jnp
    from repro.models import decode_step, prefill
    jcfg, tcfg, jp, tp = model
    toks = _tokens(S + max_len, 2, S)
    jkw = {} if true_len is None else {"true_len": jnp.asarray(true_len)}
    jl, jc = prefill(jp, jnp.asarray(toks), jcfg, _jopts(), max_len=max_len,
                     **jkw)
    tl, tc = TT.prefill(tp, torch.from_numpy(toks), tcfg, topts,
                        max_len=max_len, true_len=true_len)
    _close(tl, jl)
    ts = tslotify(tc)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode_step(jp, jc, jnp.asarray(nxt), jcfg, _jopts())
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcfg, topts)
        sl, ts = TT.decode_step_slots(tp, ts, torch.from_numpy(nxt), tcfg,
                                      topts)
        _close(tl, jl)
        _close(sl, jl)


def test_prefill_and_decode_teacher_forced(model):
    _teacher_forced(model, S=12, max_len=24)


def test_prefill_longer_than_the_cache(model):
    """S >= T: prefill keeps the last T positions in circular order
    (transformer.py:719-726) and decode continues from there."""
    _teacher_forced(model, S=20, max_len=16)


def test_bucketed_prefill_true_len(model):
    """A right-padded bucket with true_len: logits at true_len - 1 and the
    cache fixed up (pos = true_len, padded marks invalidated)."""
    jcfg, tcfg, _, _ = model
    if tcfg.block_pattern[0].mixer == SWA:
        with pytest.raises(ValueError, match="full-window"):
            TT.prefill(model[3], torch.zeros(1, 8, dtype=torch.int32), tcfg,
                       TOPTS, max_len=16, true_len=5)
        return
    _teacher_forced(model, S=16, max_len=24, true_len=11)


def test_shortcut_plain_versions_match_jax(model):
    """The shortcut configuration on the CPU — kernel wrappers, fused norm —
    runs the kernels' plain versions, and holds to the JAX model."""
    _teacher_forced(model, S=12, max_len=24, topts=TOPTS_KERNEL)


def test_backbone_matches_jax(model):
    import jax.numpy as jnp
    from repro.models import backbone, embed
    jcfg, tcfg, jp, tp = model
    toks = _tokens(3, 2, 10)
    pos = np.arange(10, dtype=np.int32)
    hj, _ = backbone(jp, embed(jp, jnp.asarray(toks), jcfg, _jopts()), jcfg,
                     _jopts(), jnp.asarray(pos), None)
    ht = TT.backbone(tp, TT.embed(tp, torch.from_numpy(toks), tcfg, TOPTS),
                     tcfg, TOPTS, torch.from_numpy(pos))
    _close(ht, hj)


def test_tied_embeddings_unembed_matches_jax():
    import jax.numpy as jnp
    from repro.models import unembed_logits
    jcfg, tcfg = _cfgs("tinyllama")
    jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=True)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((tcfg.vocab_size, tcfg.d_model)).astype(
        np.float32)
    h = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    _close(TT.unembed_logits({"embed": torch.from_numpy(emb)},
                             torch.from_numpy(h), tcfg),
           unembed_logits({"embed": jnp.asarray(emb)}, jnp.asarray(h), jcfg),
           1e-4)


def test_functional_decode_leaves_the_callers_cache():
    """inplace=False (linkage L0/L1) returns an updated copy and leaves the
    caller's cache as it was, like the functional JAX step; in place (L2+)
    updates the caller's tensors."""
    _, tcfg = _cfgs("tinyllama")
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    _, cache = TT.prefill(tp, torch.from_numpy(_tokens(0, 1, 6)), tcfg,
                          TOPTS, max_len=12)
    before = [{k: v.clone() for k, v in g.items()} for g in cache]
    _, new = TT.decode_step(tp, cache, torch.tensor([3], dtype=torch.int32),
                            tcfg, TOPTS, inplace=False)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(cache, before)
               for k in a)
    assert int(new[0]["pos"]) == 7 and int(cache[0]["pos"]) == 6
    TT.decode_step(tp, cache, torch.tensor([3], dtype=torch.int32), tcfg,
                   TOPTS)
    assert int(cache[0]["pos"]) == 7


def test_registry_matches_jax():
    """The port registers the JAX package's configs under the same names,
    in the same order, and each (and its ``-smoke``) equals JAX's field for
    field; ``all_cells`` gives JAX's dry-run cells."""
    from repro import configs as J
    from repro_torch import configs as T
    assert T.list_archs() == J.list_archs()
    assert T.list_archs(include_extras=True) == J.list_archs(True)
    assert len(T.list_archs(True)) == 11
    for name in T.list_archs(True):
        for n in (name, name + "-smoke"):
            assert (dataclasses.asdict(T.get_config(n))
                    == dataclasses.asdict(J.get_config(n))), n
    assert T.all_cells() == J.all_cells()


def test_unknown_arch_and_layer_raise():
    """An unknown name raises ``KeyError``, and a layer the JAX model
    cannot run (an unknown mixer) ``ValueError``, as JAX's ``apply_layer``
    does."""
    with pytest.raises(KeyError, match="unknown arch"):
        tget("llama-9-1t")
    cfg = dataclasses.replace(tget("tinyllama-1.1b").smoke(),
                              block_pattern=(LayerSpec("conv", DENSE),))
    with pytest.raises(ValueError, match="not one the model runs"):
        TT.layer_specs(cfg)

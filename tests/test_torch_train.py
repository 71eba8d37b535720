"""Training in the port against the JAX package, at smoke size on the CPU:
``loss_fn`` and its gradients, the flash attention backward's plain
version, AdamW, a few train steps, and the linkage levels of the train
step inside the port.

Both packages start from one state: JAX's init (or ``init_train_state``)
crosses through ``repro_torch.convert``; token ids, embeddings, context
and gradients are seeded numpy, the same for both. fp32 throughout, JAX
at ``attn_impl="ref"``. Tolerances are stated beside each check; the
frameworks sum in other orders, so fp32 agreement is ~1e-6 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.core import (L0_EAGER, L1_BASE, L2_BYP, L3_NSS,  # noqa: E402
                              LinkageConfig, build_sharded_train_step,
                              build_train_step, init_train_state)
from repro_torch.data import DataConfig, Pipeline, stage  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)
from repro_torch.models import ModelOptions as TOpts  # noqa: E402
from repro_torch.models import loss_fn as tloss  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

TOPTS = TOpts(attn_impl="ref", scan_impl="ref", dtype=torch.float32)
#: the shortcut as the training launcher resolves it: the flash and
#: rmsnorm autograd Functions (their plain versions on the CPU), plain scans
TKERNEL = dataclasses.replace(TOPTS, attn_impl="kernel", fused_norm=True)
#: loss_fn / gradient agreement with JAX: fp32 in other summation orders.
#: A gradient is held per parameter: max |port - JAX| within GRAD_FRAC of
#: the parameter's largest |gradient| entry (observed up to 2.4e-5 on the
#: recurrent models, whose scans carry the rounding across positions;
#: ~1.4e-6 on the rest)
LOSS_RTOL, GRAD_FRAC = 1e-5, 1e-4
#: the archs whose loss and gradients are held against JAX's: dense GQA,
#: MoE (the aux loss), RWKV and Mamba (plain scans), embedding inputs,
#: cross-attention (``xctx``)
LOSS_ARCHS = ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "rwkv6-7b",
              "jamba-v0.1-52b", "musicgen-medium", "llama-3.2-vision-11b"]
B, S = 2, 16


def _jopts(**kw):
    from repro.models import ModelOptions
    return ModelOptions(attn_impl="ref", scan_impl="ref", dtype=jnp.float32,
                        **kw)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


@functools.lru_cache(maxsize=None)
def _model(name, seed=0):
    """(JAX config, port config, JAX params, port params) of a smoke
    config; every cross-attention gate at 0.5 (JAX inits it at zero, which
    hides the cross-attention's gradient)."""
    from repro.configs import get_config
    from repro.models import init_params
    jcfg = get_config(name).smoke()
    jp = init_params(jax.random.PRNGKey(seed), jcfg)
    for group in jp["blocks"]:
        if "xgate" in group["mixer"]:
            group["mixer"]["xgate"] = jnp.full_like(group["mixer"]["xgate"],
                                                    0.5)
    return jcfg, tget(name).smoke(), jp, params_from_jax(_np(jp), "cpu")


def _batch(jcfg, seed=1):
    """A seeded batch of the JAX pipeline's layout (numpy)."""
    from repro.data import DataConfig as JData, Pipeline as JPipe
    return JPipe(jcfg, JData(global_batch=B, seq_len=S, seed=seed)).batch_at(0)


def _jax_loss_grads(jcfg, jp, batch, opts):
    from repro.models import loss_fn
    (loss, m), g = jax.value_and_grad(
        lambda p: loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg, opts),
        has_aux=True)(jp)
    return float(loss), {k: float(v) for k, v in m.items()}, g


def _port_loss_grads(tcfg, tp, batch, opts):
    live = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, m = tloss(tree.unflatten(tp, live), stage(batch, "cpu"), tcfg, opts)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in m.items()},
            tree.unflatten(tp, grads))


def _assert_grads_close(got, want, what, frac=GRAD_FRAC):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        err = float((g.detach().float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        assert err <= frac * top + 1e-12, (what, i, err, top)


def _assert_tree_close(got, want, atol, rtol, what):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.detach().float().numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_loss_and_grads_match_jax(name):
    """``loss_fn`` (ce, moe_aux, loss) and every parameter's gradient
    against ``jax.value_and_grad(repro.models.loss_fn)`` from one init and
    one batch: loss within 1e-5 relative, each parameter's gradient within
    GRAD_FRAC of its largest entry (fp32, other summation orders). The
    MoE model's loss carries its router aux loss; rwkv6-7b and jamba train
    on their plain scans."""
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(jcfg)
    jl, jm, jg = _jax_loss_grads(jcfg, jp, batch, _jopts())
    tl, tm, tg = _port_loss_grads(tcfg, tp, batch, TOPTS)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for k in ("ce", "moe_aux"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=1e-7)
    if tcfg.moe is not None:
        assert tm["moe_aux"] > 0
    _assert_grads_close(tg, params_from_jax(_np(jg), "cpu"), f"{name} grads")


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "h2o-danube-1.8b"])
def test_shortcut_loss_and_grads_match_jax(name):
    """The launcher's shortcut (flash and rmsnorm through their autograd
    ``Function``s, which take their plain versions on the CPU) against
    JAX's plain loss and gradients: as ``test_loss_and_grads_match_jax``;
    danube's sliding window (16 at smoke size) binds at S 16 + 8."""
    jcfg, tcfg, jp, tp = _model(name)
    from repro.data import DataConfig as JData, Pipeline as JPipe
    batch = JPipe(jcfg, JData(global_batch=B, seq_len=24, seed=3)).batch_at(0)
    jl, _, jg = _jax_loss_grads(jcfg, jp, batch, _jopts())
    tl, _, tg = _port_loss_grads(tcfg, tp, batch, TKERNEL)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_grads_close(tg, params_from_jax(_np(jg), "cpu"),
                        f"{name} shortcut grads")


def test_shortcut_trains_through_the_kernel_functions():
    """Under the shortcut every norm and attention of the training forward
    is a node of the kernels' autograd ``Function``s (``RMSNorm``,
    ``FlashAttention``), which on the card run the kernels forward and
    the flash backward kernel; on the CPU their plain versions. Counted
    by wrapping both ``Function``s' forwards and the backward wrapper:
    2 layers give 5 norms, 2 attention forwards and 2 backwards."""
    from repro_torch.kernels import rmsnorm as krms
    jcfg, tcfg, _, tp = _model("tinyllama-1.1b")
    seen = {"RMSNorm": 0, "FlashAttention": 0, "bwd": 0}
    fns = {"RMSNorm": krms.RMSNorm.forward,
           "FlashAttention": kfa.FlashAttention.forward}
    bwd = kfa.flash_attention_bwd

    def counting(name):
        def fwd(*a, **k):
            seen[name] += 1
            return fns[name](*a, **k)
        return staticmethod(fwd)

    def counting_bwd(*a, **k):
        seen["bwd"] += 1
        return bwd(*a, **k)
    mp = pytest.MonkeyPatch()
    mp.setattr(krms.RMSNorm, "forward", counting("RMSNorm"))
    mp.setattr(kfa.FlashAttention, "forward", counting("FlashAttention"))
    mp.setattr(kfa, "flash_attention_bwd", counting_bwd)
    try:
        _port_loss_grads(tcfg, tp, _batch(jcfg), TKERNEL)
    finally:
        mp.undo()
    assert seen == {"RMSNorm": 5, "FlashAttention": 2, "bwd": 2}


def test_logit_chunk_equals_full():
    """JAX's ``test_logit_chunking_equals_full`` in the port: chunked
    cross-entropy (4 chunks of 4) == whole-sequence logits, loss within
    1e-6 relative and gradients within 1e-7 + 1e-5; the chunked loss
    against JAX's chunked one too."""
    jcfg, tcfg, jp, tp = _model("tinyllama-1.1b")
    batch = _batch(jcfg)
    full = _port_loss_grads(tcfg, tp, batch, TOPTS)
    chunk = _port_loss_grads(tcfg, tp, batch,
                             dataclasses.replace(TOPTS, logit_chunk=4))
    np.testing.assert_allclose(chunk[0], full[0], rtol=1e-6)
    _assert_tree_close(chunk[2], full[2], 1e-7, 1e-5, "chunked grads")
    jl = _jax_loss_grads(jcfg, jp, batch, _jopts(logit_chunk=4))[0]
    np.testing.assert_allclose(chunk[0], jl, rtol=LOSS_RTOL)
    with pytest.raises(ValueError):
        _port_loss_grads(tcfg, tp, batch,
                         dataclasses.replace(TOPTS, logit_chunk=5))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_remat_equals_no_remat(name):
    """``remat`` (each block under non-reentrant checkpoint) recomputes
    the same forward: loss and gradients bit-identical to no remat on the
    CPU (the MoE model's aux loss included)."""
    _, tcfg, _, tp = _model(name)
    batch = _batch(get_jcfg(name))
    plain = _port_loss_grads(tcfg, tp, batch, TOPTS)
    remat = _port_loss_grads(tcfg, tp, batch,
                             dataclasses.replace(TOPTS, remat=True))
    assert remat[0] == plain[0] and remat[1] == plain[1]
    _assert_tree_close(remat[2], plain[2], 0, 0, "remat grads")


def get_jcfg(name):
    return _model(name)[0]


def test_norm_bf16_grad_matches_fp32_within_tolerance():
    """JAX's ``test_perf_knobs`` case: ``norm_bf16_grad`` (the rmsnorm
    autograd ``Function`` with dx cast to the activation dtype) at fp32
    activations, against autograd of the plain norm and against JAX's
    gradients with the knob on: within 1e-6 + 1e-5 relative of autograd
    (the cast is a no-op in fp32; the derivative is analytic, autograd's
    is not), and within GRAD_FRAC of JAX's."""
    jcfg, tcfg, jp, tp = _model("tinyllama-1.1b")
    batch = _batch(jcfg)
    on = dataclasses.replace(TOPTS, norm_bf16_grad=True)
    g0 = _port_loss_grads(tcfg, tp, batch, TOPTS)[2]
    g1 = _port_loss_grads(tcfg, tp, batch, on)[2]
    _assert_tree_close(g1, g0, 1e-6, 1e-5, "norm_bf16_grad grads")
    jg = _jax_loss_grads(jcfg, jp, batch, _jopts(norm_bf16_grad=True))[2]
    _assert_grads_close(g1, params_from_jax(_np(jg), "cpu"),
                        "norm_bf16_grad grads against JAX")


def test_norm_bf16_grad_casts_dx_to_the_activation_dtype():
    """In bf16 the ``Function``'s dx comes back in bf16, the scale's
    gradient in the scale's dtype, and both within bf16 rounding (2e-2) of
    autograd through the plain norm."""
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64), np.float32)).to(
        torch.bfloat16).requires_grad_()
    scale = torch.from_numpy(
        1 + 0.1 * rng.standard_normal(64).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((3, 5, 64), np.float32)).to(
        torch.bfloat16)
    opts = TOpts(dtype=torch.bfloat16, norm_bf16_grad=True)
    dx, ds = torch.autograd.grad(TL.rmsnorm({"scale": scale}, x, 1e-5, opts),
                                 (x, scale), dy)
    ex, es = torch.autograd.grad(TL._rmsnorm_raw(scale, x, 1e-5), (x, scale),
                                 dy)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), ex.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ds.numpy(), es.numpy(), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the flash backward's plain version against JAX's custom_vjp
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's sweeps: HKV 3, odd dh, a window, Sq 1 and 7
FLASH_BWD_SWEEP = [
    (2, 32, 4, 4, 32, 0),
    (1, 24, 6, 3, 16, 0),
    (1, 20, 4, 2, 33, 0),
    (2, 40, 4, 2, 32, 8),
    (1, 1, 4, 2, 16, 0),
    (2, 7, 4, 1, 24, 3),
]


@pytest.mark.parametrize("B_,S_,HQ,HKV,dh,window", FLASH_BWD_SWEEP)
def test_flash_bwd_ref_matches_jax_vjp(B_, S_, HQ, HKV, dh, window):
    """``flash_attention_bwd_ref`` and the ``FlashAttention`` Function (its
    CPU path) against the VJP of JAX's ``flash_attention(interpret=True)``
    (the Pallas forward, ``_flash_bwd``'s blockwise recompute) on one
    seeded q, k, v and cotangent: dq, dk, dv within 1e-5 + 1e-4 relative
    (fp32, other summation orders); the Function's forward equals the
    plain forward."""
    from repro.kernels.flash_attention import flash_attention as jflash
    rng = np.random.default_rng(B_ * 1000 + S_ * 10 + dh)
    q = rng.standard_normal((B_, S_, HQ, dh), np.float32)
    k = rng.standard_normal((B_, S_, HKV, dh), np.float32)
    v = rng.standard_normal((B_, S_, HKV, dh), np.float32)
    do = rng.standard_normal((B_, S_, HQ, dh), np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jflash(
        a, b, c, causal=True, window=window, block_q=8, block_k=8,
        interpret=True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    got = flash_attention_bwd_ref(tq, tk, tv, tdo, causal=True, window=window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = kfa.flash_attention(*leaves, causal=True, window=window)
    via_fn = torch.autograd.grad(o, leaves, tdo)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-4)
    for g, f, w, n in zip(got, via_fn, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=n)
        assert torch.equal(f, g), n


@pytest.mark.parametrize("B_,S_,HQ,HKV,dh,window", [
    FLASH_BWD_SWEEP[1], FLASH_BWD_SWEEP[3], FLASH_BWD_SWEEP[5]])
def test_flash_lse_ref_matches_jax(B_, S_, HQ, HKV, dh, window):
    """The forward's row log-sum-exp, plain (``flash_attention_ref(...,
    return_lse=True)``, what the kernel's ``lse`` output is held to on the
    card) against ``jax.nn.logsumexp`` over the masked, scaled scores, at
    HKV 3 and two windows, within 1e-5 + 1e-5 relative; the forward's
    output the same with and without it, through the wrapper too; the
    ``FlashAttention`` Function's CPU backward bit for bit the plain one
    with the lse given or not."""
    rng = np.random.default_rng(S_ * 100 + dh)
    q = rng.standard_normal((B_, S_, HQ, dh), np.float32)
    k = rng.standard_normal((B_, S_, HKV, dh), np.float32)
    v = rng.standard_normal((B_, S_, HKV, dh), np.float32)
    do = rng.standard_normal((B_, S_, HQ, dh), np.float32)
    G = HQ // HKV
    s = jnp.einsum("bqhgd,bkhd->bhgqk", jnp.asarray(q).reshape(
        B_, S_, HKV, G, dh), jnp.asarray(k)) / np.sqrt(dh)
    i = np.arange(S_)
    live = (i[:, None] >= i[None, :]) & ((i[:, None] - i[None, :] < window)
                                         | (window == 0))
    want = jax.nn.logsumexp(jnp.where(live, s, -jnp.inf), axis=-1)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, window=window,
                                   return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(
        B_, HQ, S_), atol=1e-5, rtol=1e-5)
    o2, lse2 = kfa.flash_attention_with_lse(tq, tk, tv, window=window)
    assert torch.equal(out, flash_attention_ref(tq, tk, tv, window=window))
    assert torch.equal(o2, out) and torch.equal(lse2, lse)
    plain = flash_attention_bwd_ref(tq, tk, tv, tdo, window=window)
    for with_lse in (kfa.flash_attention_bwd(tq, tk, tv, out, tdo, lse,
                                             window=window),
                     kfa.flash_attention_bwd(tq, tk, tv, out, tdo,
                                             window=window)):
        assert all(torch.equal(a, b) for a, b in zip(with_lse, plain))


def test_flash_bwd_dispatches_on_the_device():
    """The backward's wrapper dispatches on the device like every kernel
    wrapper (CPU -> plain version) and names its limits: the head dim
    bound is ``MAX_BWD_HEAD_DIM`` (128, every config's dh)."""
    assert kfa.MAX_BWD_HEAD_DIM == 128
    q = torch.zeros(1, 3, 2, 8)
    k = torch.zeros(1, 3, 1, 8)
    dq, dk, dv = kfa.flash_attention_bwd(q, k, k, q, q)
    assert dq.shape == q.shape and dk.shape == k.shape
    assert not dq.any() and not dk.any() and not dv.any()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _to_jax(tree_):
    """A port tree (dicts and lists of tensors) as the same pytree of jax
    arrays: ``jax.tree`` visits it in ``repro_torch.tree``'s order."""
    return tree.tree_map(lambda t: jnp.asarray(t.detach().float().numpy()
                                               ).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree_)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    """``adamw.update`` against JAX's ``adamw.update`` on the same tree
    (the port's per-layer layout, so both see the same ``ndim``),
    identical params, moments and seeded gradients scaled so the global
    norm clips, three updates in a row: parameters within 1e-6 relative
    (1e-7 absolute; lr x 2^-7 with bf16 moments, where a moment one bf16
    rounding apart moves its parameter that far), fp32 moments the same,
    bf16 moments within one bf16 ulp, grad_norm and lr within 1e-6
    relative."""
    from repro.optim import adamw as jadamw
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moment_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]
    tp = _model("tinyllama-1.1b")[3]
    jo = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            moment_dtype=jdt)
    to = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            moment_dtype=tdt)
    jparams, tparams = _to_jax(tp), tp
    js, ts = jadamw.init(jo, jparams), tadamw.init(to, tparams)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = tree.tree_map(lambda t: torch.from_numpy(
            (rng.standard_normal(tuple(t.shape)) * 3).astype(np.float32)),
            tparams)
        jparams, js, jm = jadamw.update(jo, _to_jax(g), js, jparams)
        tparams, ts, tm = tadamw.update(to, g, ts, tparams)
        assert float(jm["grad_norm"]) > jo.grad_clip
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.count) == int(js.count) == 3

    def host(jtree):
        return tree.unflatten(tparams, [
            torch.from_numpy(np.asarray(a.astype(jnp.float32)))
            for a in jax.tree.leaves(jtree)])
    # a bf16 moment one rounding apart (fp32 sums differing at a tie)
    # moves its parameter by up to lr x 2^-7
    p_atol = 1e-7 if moment_dtype == "float32" else jo.lr * 2 ** -7
    _assert_tree_close(tparams, host(jparams), p_atol, 1e-6, "params")
    tol = 1e-6 if moment_dtype == "float32" else 8e-3
    for tmom, jmom in ((ts.mu, js.mu), (ts.nu, js.nu)):
        _assert_tree_close(tmom, host(jmom), 1e-9, tol, "moments")
        assert all(t.dtype == tdt for t in tree.leaves(tmom))


def test_adamw_schedule_and_decay_rules():
    """``schedule_lr`` equals JAX's over warmup and decay for all three
    schedules (1e-6 relative); weight decay moves matrices only (a zero
    gradient leaves a vector unchanged and shrinks a matrix); ``inplace``
    writes into the old tensors."""
    from repro.optim import adamw as jadamw
    for sched in ("cosine", "linear", "constant"):
        jo = jadamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                                schedule=sched)
        to = tadamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                                schedule=sched)
        for s in (0, 1, 4, 5, 6, 20, 39, 40, 55):
            np.testing.assert_allclose(
                float(tadamw.schedule_lr(to, torch.tensor(s))),
                float(jadamw.schedule_lr(jo, jnp.asarray(s))), rtol=1e-6)
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.1)
    params = {"m": torch.ones(3, 4), "v": torch.ones(4)}
    keep = {k: v.clone() for k, v in params.items()}
    st = tadamw.init(cfg, params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new, st2, _ = tadamw.update(cfg, grads, st, params, inplace=True)
    assert new["m"] is params["m"] and st2.mu["v"] is st.mu["v"]
    assert torch.equal(params["v"], keep["v"])
    assert (params["m"] < keep["m"]).all()


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------

#: train steps of both packages: lr 1e-3, 4 steps. AdamW's first steps
#: move each parameter by about lr x sign(g): a gradient of rounding-noise
#: size (1e-6 relative here) may take the other sign in the other
#: framework and move its parameter 2 lr the other way. So parameters are
#: held within 2 lr x steps (absolute) and losses within lr. Weight decay
#: is 0 on both sides: JAX stacks each block-pattern position's vectors
#: (norm scales, biases) into (num_blocks, D) arrays, which its
#: ``ndim >= 2`` rule then decays; the port keeps per-layer vectors and
#: decays matrices only (``test_adamw_update_matches_jax`` holds the rule
#: itself against JAX's on one layout)
STEP_LR, N_STEPS = 1e-3, 4


def test_train_steps_match_jax():
    """JAX's ``build_train_step`` (L1) and the port's, four steps from one
    ``TrainState`` (JAX's init through ``train_state_from_jax``) over the
    pipeline's batches (the same numpy): losses within lr, parameters
    within 2 lr x steps, step counters equal; the observed agreement is
    far tighter (~1e-6)."""
    from repro.configs import get_config
    from repro.core import LinkageConfig as JLink
    from repro.core import build_train_step as jbuild
    from repro.core import init_train_state as jinit
    from repro.data import DataConfig as JData, Pipeline as JPipe
    from repro.optim import AdamWConfig as JAdam
    jcfg = get_config("tinyllama-1.1b").smoke()
    tcfg = tget("tinyllama-1.1b").smoke()
    jo = JAdam(lr=STEP_LR, warmup_steps=2, total_steps=50, weight_decay=0.0)
    to = tadamw.AdamWConfig(lr=STEP_LR, warmup_steps=2, total_steps=50,
                            weight_decay=0.0)
    jstate = jinit(jax.random.PRNGKey(3), jcfg, jo)
    tstate = train_state_from_jax(jstate, "cpu")
    jstep = jbuild(jcfg, _jopts(), jo, JLink(level="L1_BASE"))
    tstep = build_train_step(tcfg, TOPTS, to, LinkageConfig(level=L1_BASE))
    pipe = JPipe(jcfg, JData(global_batch=B, seq_len=S))
    for i in range(N_STEPS):
        b = pipe.batch_at(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, stage(b, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=STEP_LR)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(tstate.step) == int(jstate.step) == N_STEPS
    _assert_tree_close(tstate.params, params_from_jax(_np(jstate.params),
                                                      "cpu"),
                       2 * STEP_LR * N_STEPS, 0, "params after 4 steps")


def test_train_state_from_jax_round_trip():
    """``train_state_from_jax`` carries params, both moments, the count
    and the step bit for bit, in their dtypes."""
    from repro.configs import get_config
    from repro.core import init_train_state as jinit
    from repro.optim import AdamWConfig as JAdam
    jcfg = get_config("rwkv6-7b").smoke()
    js = jinit(jax.random.PRNGKey(0), jcfg, JAdam(moment_dtype=jnp.bfloat16))
    js = js._replace(step=jnp.asarray(5, jnp.int32),
                     opt=js.opt._replace(count=jnp.asarray(5, jnp.int32)))
    ts = train_state_from_jax(js, "cpu")
    assert int(ts.step) == 5 and int(ts.opt.count) == 5
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(ts.opt.mu))
    _assert_tree_close(ts.params, params_from_jax(_np(js.params), "cpu"), 0,
                       0, "params")


# ---------------------------------------------------------------------------
# the linkage levels of the train step, inside the port
# ---------------------------------------------------------------------------

TCFG = tget("tinyllama-1.1b").smoke()
TOCFG = tadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def _tstate(seed=11):
    return init_train_state(TCFG, TOCFG,
                            torch.Generator().manual_seed(seed), "cpu")


def _pipe():
    return Pipeline(TCFG, DataConfig(global_batch=4, seq_len=32))


def _run(lk, steps=8):
    state = _tstate()
    step = build_train_step(TCFG, TOPTS, TOCFG, lk)
    pipe, k, s, metrics = _pipe(), lk.steps_per_call, 0, None
    while s < steps:
        raw = pipe.stacked_at(s, k) if lk.level == L3_NSS else pipe.batch_at(s)
        state, metrics = step.fn(state, stage(raw, "cpu"))
        s += k
    return state, metrics


def test_levels_semantically_equivalent():
    """L0 == L1 == L2 == L3 (4 steps a call) == L2 with ret_async, over 8
    steps: the last loss within 1e-6 relative and every parameter within
    1e-6 (the same eager arithmetic; L2+ writes in place)."""
    ref_state, ref_m = _run(LinkageConfig(level=L1_BASE))
    for lk in (LinkageConfig(level=L0_EAGER), LinkageConfig(level=L2_BYP),
               LinkageConfig(level=L3_NSS, nss_steps=4),
               LinkageConfig(level=L2_BYP, ret_async=True)):
        st, m = _run(lk)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-6)
        _assert_tree_close(st.params, ref_state.params, 1e-6, 1e-6,
                           lk.level)
        assert int(st.step) == 8


def test_l1_keeps_the_callers_state():
    state = _tstate()
    before = [t.clone() for t in tree.leaves(state)]
    step = build_train_step(TCFG, TOPTS, TOCFG, LinkageConfig(level=L1_BASE))
    new, _ = step(state, stage(_pipe().batch_at(0), "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves(state)))
    assert not torch.equal(tree.leaves(new.params)[0],
                           tree.leaves(state.params)[0])


def test_l2_updates_the_callers_state_in_place():
    """L2's counterpart of donation: the caller's tensors are the new
    state's, updated in place."""
    state = _tstate()
    before = tree.leaves(state.params)[0].clone()
    step = build_train_step(TCFG, TOPTS, TOCFG, LinkageConfig(level=L2_BYP))
    new, _ = step(state, stage(_pipe().batch_at(0), "cpu"))
    leaf = tree.leaves(state.params)[0]
    assert tree.leaves(new.params)[0] is leaf
    assert not torch.equal(leaf, before)
    assert int(state.step) == 1 and int(state.opt.count) == 1


def test_l3_call_never_syncs_with_the_host(monkeypatch):
    """An L3 call (4 microsteps over stacked batches) reads nothing back
    to the host: ``item``, ``cpu``, ``tolist`` and ``float()`` on a tensor
    raise inside it; the metrics come back as tensors."""
    lk = LinkageConfig(level=L3_NSS, nss_steps=4)
    state = _tstate()
    step = build_train_step(TCFG, TOPTS, TOCFG, lk)
    batch = stage(_pipe().stacked_at(0, 4), "cpu")

    def boom(*a, **k):
        raise AssertionError("host sync inside the L3 call")
    for name in ("item", "cpu", "tolist", "__float__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    state, m = step(state, batch)
    monkeypatch.undo()
    assert isinstance(m["loss"], torch.Tensor) and int(state.step) == 4


def test_ret_async_returns_none_until_sync():
    lk = LinkageConfig(level=L2_BYP, ret_async=True, sync_every=2)
    step = build_train_step(TCFG, TOPTS, TOCFG, lk)
    st, metrics = step(_tstate(), stage(_pipe().batch_at(0), "cpu"))
    assert metrics is None
    got = step.sync()
    assert got is not None and "loss" in got and isinstance(got["loss"],
                                                            float)
    assert step.sync() is None


def test_l0_rejects_shortcut_and_sharded_step_names_its_item():
    """L0 refuses the shortcut, and a mesh (``ValueError``, as JAX's
    eager level carries no shardings); at L2 the sharded step builds over
    a mesh's shape alone from ``meta`` tensors and returns JAX's specs:
    FSDP over "data" on the rule's dimension, Megatron over "model", the
    batch's rows over "data" (at L3 behind a microstep dimension)."""
    from repro_torch.launch.mesh import mesh_shape
    with pytest.raises(ValueError):
        build_train_step(TCFG, TOPTS, TOCFG,
                         LinkageConfig(level=L0_EAGER, shortcut=True))
    like = tree.tree_map(lambda t: t.to("meta"), _tstate())
    mesh = mesh_shape(2, 2)
    with pytest.raises(ValueError, match="jitted linkage"):
        build_sharded_train_step(TCFG, TOPTS, TOCFG,
                                 LinkageConfig(level=L0_EAGER), mesh, like, 4)
    fn, specs, bspecs = build_sharded_train_step(
        TCFG, TOPTS, TOCFG, LinkageConfig(level=L2_BYP), mesh, like, 4)
    mixer = specs.params["layers"][0]["mixer"]
    assert mixer["wq"] == ("data", "model") and mixer["wo"] == ("model",
                                                                 "data")
    assert specs.opt.mu is specs.params and specs.step == ()
    assert specs.params["embed"] == ("model", "data")
    assert bspecs["inputs"] == ("data", None) and callable(fn)
    _, _, b3 = build_sharded_train_step(
        TCFG, TOPTS, TOCFG, LinkageConfig(level=L3_NSS), mesh, like, 4)
    assert b3["labels"] == (None, "data", None)

"""The port's quantized paged KV (``kv_dtype`` int8 / fp8) on the CPU, at
smoke size.

Codecs: ``quantize``, ``dequantize``, ``block_scales`` and ``quant_insert``
of ``repro_torch.kernels.kv_quant`` against ``repro.kernels.kv_quant`` on
seeded numpy inputs, bit for bit (codes and scales).

Kernels: the fused-dequant kernels' plain versions and their ``ops``
wrappers against the JAX package's Pallas kernels (``interpret=True``) and
its oracles, over the sweep of tests/test_kernels.py:385-472, at its
tolerance (atol = rtol = 3e-5), and within the format's error bound of the
unquantized fp32 oracle (``_QTOL``); a bfloat16 query against the JAX
oracle at 2e-2.

Model: ``decode_step_paged`` and ``serve_chunk_step_paged`` on int8 caches,
teacher-forced against JAX's with the weights carried over by
``params_from_jax``. The two packages' f32 K/V can differ by an ulp, and
an ulp can move a value across a rounding boundary of the int8 grid: one
code, one quantization step (amax / 127) of that element. So the written
codes are held equal up to one-code flips of at most 0.1 % of the
elements. With these seeds no code flips and the logits agree to 1e-5;
they are held to 1e-4, the unquantized comparison's tolerance.

Engine: the fp32 control carries no scale tensors; slotted + int8 raises;
int8 and fp8 engines, two-phase and chunked, with shared prefixes, finish
every request; ``byp`` == ``nss_shortcut`` inside a quantized engine; a
second run after ``drop_prefix_cache`` replays the first (zero-on-alloc);
CoW forks copy codes and scales; int8 blocks are >= 1.9x smaller.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import preset  # noqa: E402
from repro_torch.kernels import kv_quant as tkq  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels import paged_decode as tpd  # noqa: E402
from repro_torch.kernels import paged_prefill as tpp  # noqa: E402
from repro_torch.models import (ModelOptions, decode_step_paged,  # noqa: E402
                                init_params, serve_chunk_step_paged)
from repro_torch.serve import ServeEngine, synthetic_requests  # noqa: E402
from repro_torch.serve.paging import copy_block, init_paged_cache  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48
KVDS = ("int8", "fp8")
# tests/test_kernels.py:382: attention outputs are convex combinations of
# ~N(0,1) values, so the output error tracks the format's step at amax
_QTOL = {"int8": 0.06, "fp8": 0.40}


def _torch_codes(a: np.ndarray) -> torch.Tensor:
    """A numpy code array (int8, or ml_dtypes float8_e4m3fn from JAX) as a
    torch tensor of the same bits."""
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def _bits(t: torch.Tensor) -> np.ndarray:
    return tkq.raw(t).numpy().view(np.uint8)


def _jquantize_pool(pool: np.ndarray, kvd: str):
    """Per-(block, head) quantization of an f32 pool by the JAX package
    (tests/test_kernels.py:370): its codes and scales, as numpy."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jkq
    dt = jkq.storage_dtype(kvd, jnp.float32)
    p = jnp.asarray(pool)
    s = jkq.block_scales(jnp.max(jnp.abs(p), axis=(1, 3)), dt)
    return np.asarray(jkq.quantize(p, s[:, None, :, None], dt)), np.asarray(s)


# ---------------------------------------------------------------------------
# codecs (repro/kernels/kv_quant.py:35-111)
# ---------------------------------------------------------------------------

def test_storage_dtypes_and_qmax():
    assert tkq.KV_DTYPES == ("bf16", "int8", "fp8")
    assert tkq.storage_dtype("bf16", torch.float32) == torch.float32
    assert tkq.storage_dtype("int8", torch.float32) == torch.int8
    assert tkq.storage_dtype("fp8", torch.bfloat16) == torch.float8_e4m3fn
    assert (tkq.qmax("int8"), tkq.qmax("fp8")) == (127.0, 448.0)
    assert tkq.qmax_of(torch.int8) == 127.0
    assert tkq.qmax_of(torch.float8_e4m3fn) == 448.0
    with pytest.raises(ValueError, match="kv_dtype"):
        tkq.storage_dtype("int4", torch.float32)


@pytest.mark.parametrize("kvd", KVDS)
def test_codecs_match_jax_bitwise(kvd):
    """block_scales (an all-zero block gets scale 1), quantize (int8 half to
    even, fp8 after the clip) and dequantize / dequantize_pool: the same
    bits as the JAX package's."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jkq
    rng = np.random.default_rng(1)
    pool = (rng.standard_normal((7, 8, 3, 16)) * 3).astype(np.float32)
    pool[2] = 0.0                                       # all-zero block
    pool[4, 0, 0, :4] = [0.5, 1.5, -2.5, 126.5]         # ties in the grid
    jdt = jkq.storage_dtype(kvd, jnp.float32)
    tdt = tkq.storage_dtype(kvd, torch.float32)
    amax = np.abs(pool).max(axis=(1, 3))
    js = np.asarray(jkq.block_scales(jnp.asarray(amax), jdt))
    ts = tkq.block_scales(torch.from_numpy(amax), tdt)
    assert ts.dtype == torch.float32 and np.array_equal(ts.numpy(), js)
    assert (ts[2] == 1.0).all()
    jq = np.asarray(jkq.quantize(jnp.asarray(pool), js[:, None, :, None],
                                 jdt))
    tq = tkq.quantize(torch.from_numpy(pool), ts[:, None, :, None], tdt)
    assert tq.dtype == tdt
    assert np.array_equal(_bits(tq), jq.view(np.uint8))
    # the int8 grid rounds half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    unit = torch.ones((), dtype=torch.float32)
    if kvd == "int8":
        assert tkq.quantize(torch.tensor([0.5, 1.5, -2.5]), unit,
                            tdt).tolist() == [0, 2, -2]
    jd = np.asarray(jkq.dequantize_pool(jnp.asarray(jq), jnp.asarray(js)))
    td = tkq.dequantize_pool(tq, ts)
    assert td.dtype == torch.float32 and np.array_equal(td.numpy(), jd)
    assert np.array_equal(tkq.dequantize(tq, ts[:, None, :, None]).numpy(),
                          jd)


@pytest.mark.parametrize("kvd", KVDS)
@pytest.mark.parametrize("shape", ["decode", "chunk", "admission"])
def test_quant_insert_matches_jax_bitwise(kvd, shape):
    """Writes through (B,) decode, (B, W) chunk and (S,) admission index
    shapes, in place: codes and scales equal the JAX ``quant_insert``'s.
    The destinations repeat only on the trash row, whose winner is
    unspecified; every other row is compared bit for bit."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jkq
    rng = np.random.default_rng(len(shape) + len(kvd))
    P1, bs, HKV, dh = 9, 8, 3, 16
    trash = P1 - 1
    codes, scales = _jquantize_pool(
        (rng.standard_normal((P1, bs, HKV, dh)) * 2).astype(np.float32), kvd)
    if shape == "decode":            # 4 slots, two of them dead (trash row)
        blk = np.array([1, trash, 5, trash], np.int32)
        off = np.array([3, 0, 7, 0], np.int32)
    elif shape == "chunk":           # 2 rows of W=6, one padded into trash
        blk = np.array([[2, 2, 2, 3, 3, 3], [6, 6, trash, trash, trash,
                                             trash]], np.int32)
        off = np.array([[5, 6, 7, 0, 1, 2], [0, 1, 2, 3, 4, 5]], np.int32)
    else:                            # a prefilled run of 11 over two blocks
        blk = np.array([4] * 8 + [7] * 3, np.int32)
        off = np.arange(11, dtype=np.int32) % bs
    vals = (rng.standard_normal(blk.shape + (HKV, dh)) * 5).astype(np.float32)
    jp, js = jkq.quant_insert(jnp.asarray(codes), jnp.asarray(scales),
                              jnp.asarray(blk), jnp.asarray(off),
                              jnp.asarray(vals))
    tp, ts = _torch_codes(codes), torch.from_numpy(scales.copy())
    assert tkq.quant_insert(tp, ts, torch.from_numpy(blk),
                            torch.from_numpy(off),
                            torch.from_numpy(vals)) is None
    jb = np.asarray(jp).view(np.uint8)
    assert np.array_equal(_bits(tp)[:trash], jb[:trash])
    assert np.array_equal(ts.numpy()[:trash], np.asarray(js)[:trash])
    touched = set(blk.ravel().tolist()) - {trash}
    for r in range(trash):
        if r not in touched:         # untouched rows keep their bytes
            assert np.array_equal(_bits(tp)[r], codes[r].view(np.uint8))


@pytest.mark.parametrize("kvd", KVDS)
def test_quant_insert_untouched_blocks_bitwise_stable(kvd):
    """tests/test_kernels.py:475: five writes into one block leave every
    other block's codes and scales exactly as they were, and the codes
    after each write equal JAX's."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jkq
    P1, bs, HKV, dh = 6, 8, 3, 16
    rng = np.random.default_rng(3)
    codes, scales = _jquantize_pool(
        rng.normal(size=(P1, bs, HKV, dh)).astype(np.float32), kvd)
    tp, ts = _torch_codes(codes), torch.from_numpy(scales.copy())
    jp, js = jnp.asarray(codes), jnp.asarray(scales)
    blk = np.array([2], np.int32)
    for step in range(5):
        off = np.array([step % bs], np.int32)
        vals = rng.normal(size=(1, HKV, dh)).astype(np.float32)
        jp, js = jkq.quant_insert(jp, js, jnp.asarray(blk), jnp.asarray(off),
                                  jnp.asarray(vals))
        tkq.quant_insert(tp, ts, torch.from_numpy(blk),
                         torch.from_numpy(off), torch.from_numpy(vals))
        assert np.array_equal(_bits(tp), np.asarray(jp).view(np.uint8))
        assert np.array_equal(ts.numpy(), np.asarray(js))
    untouched = [i for i in range(P1) if i != 2]
    assert np.array_equal(_bits(tp)[untouched],
                          codes[untouched].view(np.uint8))
    assert np.array_equal(ts.numpy()[untouched], scales[untouched])


# ---------------------------------------------------------------------------
# the fused-dequant kernels' plain versions (tests/test_kernels.py:385-472)
# ---------------------------------------------------------------------------

def _quant_inputs(seed, P1, bs, HKV, dh, kvd):
    """f32 pools, their JAX codes and scales, and the torch tensors of the
    same bits."""
    rng = np.random.default_rng(seed)
    kpf = rng.standard_normal((P1, bs, HKV, dh)).astype(np.float32)
    vpf = rng.standard_normal((P1, bs, HKV, dh)).astype(np.float32)
    kq, ks = _jquantize_pool(kpf, kvd)
    vq, vs = _jquantize_pool(vpf, kvd)
    torch_q = (_torch_codes(kq), _torch_codes(vq), torch.from_numpy(ks.copy()),
               torch.from_numpy(vs.copy()))
    return rng, (kpf, vpf), (kq, vq, ks, vs), torch_q


@pytest.mark.parametrize("P1,bs,nb,B,HQ,HKV,dh,lives,kvd", [
    (7, 8, 3, 2, 4, 2, 64, (13, 1), "int8"),        # mid-block boundary
    (9, 16, 2, 2, 6, 3, 64, (17, 32), "int8"),      # bs=16, HKV=3
    (5, 8, 2, 1, 8, 2, 80, (9,), "int8"),           # odd dh
    (9, 16, 2, 2, 6, 3, 64, (17, 32), "fp8"),
    (5, 8, 2, 1, 8, 2, 80, (9,), "fp8"),
    (11, 8, 3, 3, 6, 3, 33, (0, 13, 24), "int8"),   # HKV=3, dh 33, empty row
])
def test_paged_decode_quantized_matches_pallas(P1, bs, nb, B, HQ, HKV, dh,
                                               lives, kvd):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.paged_decode import paged_decode_attention as jpd
    rng, (kpf, vpf), (kq, vq, ks, vs), (tk, tv, tks, tvs) = _quant_inputs(
        P1 * bs + B, P1, bs, HKV, dh, kvd)
    q = rng.standard_normal((B, HQ, dh)).astype(np.float32)
    tables = np.stack([rng.permutation(P1)[:nb] for _ in range(B)]).astype(
        np.int32)
    valid = np.zeros((B, nb * bs), bool)
    for b, live in enumerate(lives):
        valid[b, :live] = True
    jin = [jnp.asarray(a) for a in (q, kq, vq, tables, valid, ks, vs)]
    want = np.asarray(jpd(*jin[:5], jin[5], jin[6], interpret=True))
    oracle = np.asarray(jref.paged_decode_attention_ref(*jin[:5], ks=jin[5],
                                                        vs=jin[6]))
    qt, tt, mt = (torch.from_numpy(a) for a in (q, tables, valid))
    got = tpd.paged_decode_attention(qt, tk, tv, tt, mt, tks, tvs)
    assert got.dtype == torch.float32
    live_rows = np.array([n > 0 for n in lives])    # JAX gives NaN on none
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy()[live_rows], w[live_rows],
                                   atol=3e-5, rtol=3e-5)
    assert (got.numpy()[~live_rows] == 0).all()
    if live_rows.all():
        pos = torch.tensor([n - 1 for n in lives], dtype=torch.int32)
        via_ops = tops.paged_decode_attention(qt[:, None], tk, tv, tt, pos,
                                              tks, tvs)[:, 0]
        np.testing.assert_allclose(via_ops.numpy(), want, atol=3e-5,
                                   rtol=3e-5)
    ref_f = tref.paged_decode_attention_ref(qt, *(torch.from_numpy(a) for a
                                                  in (kpf, vpf)), tt, mt)
    assert (got - ref_f).abs().max().item() <= _QTOL[kvd]


@pytest.mark.parametrize("P1,bs,nb,B,W,HQ,HKV,dh,starts,kvd", [
    (7, 8, 3, 2, 8, 4, 2, 64, (0, 13), "int8"),     # resident 0 + mid-block
    (9, 16, 2, 2, 7, 6, 3, 64, (5, 17), "int8"),    # bs=16, HKV=3
    (5, 8, 2, 1, 1, 8, 2, 80, (9,), "int8"),        # W=1 decode edge, odd dh
    (9, 16, 2, 2, 7, 6, 3, 64, (5, 17), "fp8"),
    (5, 8, 2, 1, 1, 8, 2, 80, (9,), "fp8"),
    (9, 8, 4, 2, 8, 6, 3, 33, (8, 16), "fp8"),      # chunk to a block edge
])
def test_paged_prefill_quantized_matches_pallas(P1, bs, nb, B, W, HQ, HKV,
                                                dh, starts, kvd):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.paged_prefill import paged_prefill_attention as jpp
    rng, (kpf, vpf), (kq, vq, ks, vs), (tk, tv, tks, tvs) = _quant_inputs(
        P1 * bs + B + W, P1, bs, HKV, dh, kvd)
    q = rng.standard_normal((B, W, HQ, dh)).astype(np.float32)
    tables = np.stack([rng.permutation(P1)[:nb] for _ in range(B)]).astype(
        np.int32)
    start = np.array(starts, np.int32)
    jin = [jnp.asarray(a) for a in (q, kq, vq, tables, start, ks, vs)]
    want = np.asarray(jpp(*jin[:5], jin[5], jin[6], interpret=True))
    oracle = np.asarray(jref.paged_prefill_attention_ref(
        *jin[:5], ks=jin[5], vs=jin[6]))
    qt, tt, st = (torch.from_numpy(a) for a in (q, tables, start))
    for got in (tpp.paged_prefill_attention(qt, tk, tv, tt, st, tks, tvs),
                tops.paged_prefill_attention(qt, tk, tv, tt, st, tks, tvs)):
        for w in (want, oracle):
            np.testing.assert_allclose(got.numpy(), w, atol=3e-5, rtol=3e-5)
    ref_f = tref.paged_prefill_attention_ref(
        qt, *(torch.from_numpy(a) for a in (kpf, vpf)), tt, st)
    assert (got - ref_f).abs().max().item() <= _QTOL[kvd]


@pytest.mark.parametrize("kvd", KVDS)
def test_paged_prefill_quantized_width_one_is_decode(kvd):
    """tests/test_kernels.py:452: a W=1 chunk at ``start`` is the decode
    row at ``pos = start`` on quantized pools too; the two plain versions
    agree bit for bit."""
    P1, bs, nb, B, HQ, HKV, dh = 7, 8, 3, 2, 6, 3, 64
    rng, _, _, (tk, tv, tks, tvs) = _quant_inputs(5, P1, bs, HKV, dh, kvd)
    q = torch.from_numpy(rng.standard_normal((B, 1, HQ, dh)).astype(
        np.float32))
    tables = torch.tensor([[0, 2, 5], [4, 1, 6]], dtype=torch.int32)
    pos = torch.tensor([12, 0], dtype=torch.int32)
    pre = tops.paged_prefill_attention(q, tk, tv, tables, pos, tks, tvs)
    dec = tops.paged_decode_attention(q, tk, tv, tables, pos, tks, tvs)
    assert torch.equal(pre, dec)


@pytest.mark.parametrize("kvd", KVDS)
def test_quantized_bf16_query_matches_jax(kvd):
    """A bfloat16 query over f32-decoded pools computes in f32 as JAX
    promotes (q widened, p rounded to bf16); the output is in q's dtype."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    P1, bs, nb, B, W, HQ, HKV, dh = 9, 8, 3, 2, 5, 4, 2, 32
    rng, _, (kq, vq, ks, vs), (tk, tv, tks, tvs) = _quant_inputs(
        11, P1, bs, HKV, dh, kvd)
    q = rng.standard_normal((B, W, HQ, dh)).astype(np.float32)
    tables = np.stack([rng.permutation(P1)[:nb] for _ in range(B)]).astype(
        np.int32)
    start = np.array([3, 12], np.int32)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    tt, st = torch.from_numpy(tables), torch.from_numpy(start)
    kw = dict(ks=jnp.asarray(ks), vs=jnp.asarray(vs))
    want = jref.paged_prefill_attention_ref(qj, jnp.asarray(kq),
                                            jnp.asarray(vq),
                                            jnp.asarray(tables),
                                            jnp.asarray(start), **kw)
    got = tpp.paged_prefill_attention(qt, tk, tv, tt, st, tks, tvs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    valid = np.arange(nb * bs)[None] <= start[:, None]
    want_d = jref.paged_decode_attention_ref(qj[:, 0], jnp.asarray(kq),
                                             jnp.asarray(vq),
                                             jnp.asarray(tables),
                                             jnp.asarray(valid), **kw)
    got_d = tpd.paged_decode_attention(qt[:, 0], tk, tv, tt,
                                       torch.from_numpy(valid), tks, tvs)
    assert got_d.dtype == torch.bfloat16
    np.testing.assert_allclose(got_d.float().numpy(),
                               np.asarray(want_d, np.float32),
                               atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the model against JAX on int8 caches, teacher-forced (attn_impl="ref")
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


def _int8_caches(jcfg, jp, toks, n_res, bs, nb, P, tables, pos):
    """JAX prefill of ``toks``; its first ``n_res[b]`` positions of each
    row scattered into f32 pools through ``tables``, then quantized per
    layer by the JAX package. Returns (prefill logits, the JAX paged cache
    (one stacked group), the port's (one dict per layer))."""
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
    layers = [_jquantize_pool(kp[l], "int8") + _jquantize_pool(vp[l], "int8")
              for l in range(L)]
    posv = np.asarray(pos, np.int32)
    jc = ({"kp": jnp.asarray(np.stack([g[0] for g in layers])),
           "ks": jnp.asarray(np.stack([g[1] for g in layers])),
           "vp": jnp.asarray(np.stack([g[2] for g in layers])),
           "vs": jnp.asarray(np.stack([g[3] for g in layers])),
           "pos": jnp.asarray(np.tile(posv, (L, 1)))},)
    tc = [{"kp": torch.from_numpy(g[0].copy()),
           "ks": torch.from_numpy(g[1].copy()),
           "vp": torch.from_numpy(g[2].copy()),
           "vs": torch.from_numpy(g[3].copy()),
           "pos": torch.from_numpy(posv.copy())} for g in layers]
    return lj, jc, tc


def _codes_close(got: torch.Tensor, want, rows=slice(None)):
    """int8 codes equal but for one-code flips of a few elements."""
    d = np.abs(got.numpy()[rows].astype(np.int32)
               - np.asarray(want)[rows].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_decode_step_paged_int8_matches_jax(model):
    """Prefill into int8 pools through permuted tables, then 6 paged decode
    steps (crossing a block boundary) in both packages, the port fed JAX's
    greedy tokens, plain and through the shortcut options."""
    import jax.numpy as jnp
    from repro.models import decode_step_paged as jdecode
    jcfg, jp, tp = model
    bs, nb, S = 8, MAX_LEN // 8, 13
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, S), dtype=np.int32)
    tables = rng.permutation(2 * nb + 1)[:2 * nb].reshape(2, nb).astype(
        np.int32)
    lj, jc, tc = _int8_caches(jcfg, jp, toks, (S, S), bs, nb, 2 * nb + 1,
                              tables, (S, S))
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
    for l in range(len(tc)):
        _codes_close(tc[l]["kp"], jc[0]["kp"][l])
        np.testing.assert_allclose(tc[l]["ks"].numpy(),
                                   np.asarray(jc[0]["ks"][l]), rtol=1e-5)
    assert tc[0]["kp"].dtype == torch.int8
    assert tc[0]["pos"].tolist() == [S + 6] * 2


def test_serve_chunk_step_paged_int8_matches_jax(model):
    """One chunk pass over int8 pools, three rows: a fresh 7-token chunk, a
    5-token chunk starting mid-block over 8 resident positions, and a row
    with no chunk. Logits, codes (the trash row aside) and positions agree
    with JAX's."""
    import jax.numpy as jnp
    from repro.models import serve_chunk_step_paged as jchunk
    jcfg, jp, tp = model
    bs, nb, W = 8, MAX_LEN // 8, 7
    rng = np.random.default_rng(6)
    full = rng.integers(0, 256, (3, 13), dtype=np.int32)
    P = 3 * nb + 1
    tables = rng.permutation(P)[:3 * nb].reshape(3, nb).astype(np.int32)
    _, jc, tc = _int8_caches(jcfg, jp, full, (0, 8, 10), bs, nb, P, tables,
                             (0, 8, 10))
    start = np.array([0, 8, 10], np.int32)
    clen = np.array([7, 5, 0], np.int32)
    chunk = np.zeros((3, W), np.int32)
    chunk[0, :7], chunk[1, :5] = full[0, :7], full[1, 8:13]
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
            _codes_close(g["kp"], jc[0]["kp"][l], slice(0, P))
            assert g["pos"].tolist() == [7, 13, 10]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _engine(params, linkage="byp", opts=OPTS, **kw):
    lk = preset(linkage) if isinstance(linkage, str) else linkage
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, kv="paged", block_size=8),
              **kw)
    return ServeEngine(CFG, params, opts, lk, **kw)


def _streams(eng, reqs):
    comps, _ = eng.run(reqs, load="closed")
    assert len(comps) == len(reqs)
    return {c.rid: c.tokens.tolist() for c in comps}


def test_fp32_control_has_no_scale_tensors(params):
    """``kv_dtype="bf16"`` (the default) is the uncompressed control: pools
    in the activation dtype and no ks/vs; int8 and fp8 pools carry them."""
    eng = _engine(params)
    assert all(set(g) == {"kp", "vp", "pos"} for g in eng.kv.cache)
    assert eng.kv.cache[0]["kp"].dtype == torch.float32
    for kvd, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        cache = _engine(params, kv_dtype=kvd).kv.cache
        assert all(g["kp"].dtype == g["vp"].dtype == dt for g in cache)
        assert all(g["ks"].shape == (g["kp"].shape[0], CFG.n_kv_heads)
                   and g["ks"].dtype == torch.float32 for g in cache)
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(params, kv_dtype="int4")


def test_slotted_int8_raises(params, capsys):
    with pytest.raises(ValueError, match="paged"):
        _engine(params, kv="slotted", kv_dtype="int8")
    from repro_torch.launch import serve as launch
    with pytest.raises(ValueError, match="paged"):
        launch.main(["--device", "cpu", "--requests", "1", "--kv-dtype",
                     "int8"])


@pytest.mark.parametrize("kvd", KVDS)
@pytest.mark.parametrize("chunked", [False, True])
def test_quantized_engine_serves_shared_prefixes(params, kvd, chunked):
    """int8 and fp8 engines, two-phase and chunked, with a shared 8-token
    prefix: every request finishes with its budget, the radix index shares
    blocks, and the report names the format."""
    reqs = synthetic_requests(4, prompt_len=12, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=7,
                              shared_prefix_len=8)
    eng = _engine(params, kv_dtype=kvd, chunked=chunked, chunk_budget=5)
    got = _streams(eng, reqs)
    assert all(len(t) == 6 for t in got.values())
    u = eng.utilization()
    assert u["kv_dtype"] == kvd and u["kv_prefix_shared_tokens"] > 0
    assert u["kv_bytes_per_shard"] > 0 and u["kv_bytes_per_block"] > 0


@pytest.mark.parametrize("kvd", KVDS)
def test_quantized_byp_equals_nss_shortcut(params, kvd):
    """Inside a quantized engine the linkage level changes nothing: byp
    (plain attention, one token per program) and nss_shortcut (L3
    microsteps, the kernels' plain versions) give the same streams, with
    max_len a multiple of the block size."""
    reqs = synthetic_requests(4, prompt_len=10, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=4,
                              shared_prefix_len=8)
    lk = dataclasses.replace(preset("nss_shortcut"), decode_steps=4)
    byp = _streams(_engine(params, kv_dtype=kvd, block_size=16), reqs)
    nss = _streams(_engine(params, lk, lk.model_options(OPTS), kv_dtype=kvd,
                           block_size=16), reqs)
    assert byp == nss


@pytest.mark.parametrize("chunked", [False, True])
def test_zero_on_alloc_replays(params, chunked):
    """A second run of the same workload on the same engine, after
    ``drop_prefix_cache``, reuses blocks the first run left dirty and
    equals the first: allocation clears a block's codes and scales."""
    reqs = synthetic_requests(4, prompt_len=12, max_new_tokens=6,
                              vocab_size=CFG.vocab_size, seed=5,
                              shared_prefix_len=8)
    eng = _engine(params, kv_dtype="int8", chunked=chunked, chunk_budget=5)
    first = _streams(eng, reqs)
    eng.kv.drop_prefix_cache()
    assert eng.kv.pool.n_resident == 0
    dirty = any(bool((g["ks"][:-1] != 1).any()) for g in eng.kv.cache)
    assert dirty                        # stale scales left in freed blocks
    assert _streams(eng, reqs) == first


def test_cow_fork_copies_codes_and_scales(params):
    """``copy_block`` copies a block's codes and its scales; in the engine,
    identical block-aligned prompts fork the shared tail block and every
    copy decodes the same stream."""
    rng = np.random.default_rng(2)
    cache = init_paged_cache(CFG, 5, 8, 2, torch.float32, "cpu",
                             kv_dtype="fp8")
    for g in cache:
        tkq.quant_insert(g["kp"], g["ks"], torch.tensor([1] * 8),
                         torch.arange(8), torch.from_numpy(
                             rng.standard_normal((8, CFG.n_kv_heads,
                                                  CFG.head_dim))
                             .astype(np.float32)))
    copy_block(cache, 1, 3)
    for g in cache:
        assert torch.equal(tkq.raw(g["kp"][3]), tkq.raw(g["kp"][1]))
        assert torch.equal(g["ks"][3], g["ks"][1]) and (g["ks"][1] != 1).any()
    base = synthetic_requests(1, prompt_len=16, max_new_tokens=4,
                              vocab_size=CFG.vocab_size, seed=9)[0]
    reqs = [dataclasses.replace(base, rid=i) for i in range(3)]
    eng = _engine(params, kv_dtype="int8")
    got = _streams(eng, reqs)
    assert eng.utilization()["kv_cow_forks"] >= 2
    assert got[0] == got[1] == got[2]


@pytest.mark.parametrize("kvd", KVDS)
def test_quantized_block_bytes_compression(params, kvd):
    """tests/test_paging.py:1124: quantized blocks hold >= 1.9x more tokens
    per byte than the fp32 control (codes 4x smaller; the scales are the
    overhead), and the report carries the format and its sizes."""
    b = _engine(params).utilization()
    q = _engine(params, kv_dtype=kvd).utilization()
    assert b["kv_dtype"] == "bf16" and q["kv_dtype"] == kvd
    L, HKV, dh, bs = CFG.num_blocks, CFG.n_kv_heads, CFG.head_dim, 8
    assert b["kv_bytes_per_block"] == L * 2 * bs * HKV * dh * 4
    assert q["kv_bytes_per_block"] == L * 2 * (bs * HKV * dh + HKV * 4)
    assert b["kv_bytes_per_block"] / q["kv_bytes_per_block"] >= 1.9
    assert b["kv_bytes_per_shard"] / q["kv_bytes_per_shard"] >= 1.9


@pytest.mark.parametrize("extra,mode", [
    (["--kv-dtype", "int8", "--shared-prefix-len", "4", "--block-size",
      "4"], "two_phase"),
    (["--kv-dtype", "fp8", "--chunked", "--budget", "6", "--chunk-width",
      "4"], "chunked"),
])
def test_launcher_quantized_prints_a_report(extra, mode, capsys):
    from repro_torch.launch import serve as launch
    rc = launch.main(["--device", "cpu", "--load", "closed", "--requests",
                      "2", "--prompt-len", "8", "--gen-len", "5", "--kv",
                      "paged", *extra])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["step_mode"] == mode and rep["total_tokens"] == 2 * 5
    assert rep["kv_dtype"] == extra[1]
    assert {"kv_bytes_per_block", "kv_bytes_per_shard"} <= set(rep)


# ---------------------------------------------------------------------------
# on the card: both fused-dequant kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kvd", KVDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quantized_paged_kernels_match_plain(kvd, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU "
                    "interpret mode)")
    from repro_torch.kernels import _build
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    store = tkq.storage_dtype(kvd, torch.float32)
    rng = np.random.default_rng(0)
    for B, nb, bs, HQ, HKV, dh, pos in ((3, 4, 8, 6, 3, 33, (0, 13, 31)),
                                        (4, 5, 16, 32, 4, 64,
                                         (32, 48, 71, 0))):
        P1 = B * nb + 2
        pools = []
        for _ in range(2):
            f = torch.from_numpy(rng.standard_normal(
                (P1, bs, HKV, dh)).astype(np.float32)).cuda()
            s = tkq.block_scales(f.abs().amax(dim=(1, 3)), store)
            pools += [tkq.quantize(f, s[:, None, :, None], store), s]
        kq, ks, vq, vs = pools
        tables = torch.from_numpy(np.stack(
            [rng.permutation(P1 - 1)[:nb] for _ in range(B)]).astype(
                np.int32)).cuda()
        q = torch.from_numpy(rng.standard_normal((B, 3, HQ, dh)).astype(
            np.float32)).cuda().to(dtype)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(nb * bs, device="cuda")[None] <= pt[:, None]
        _build.reset_launches()
        torch.testing.assert_close(
            tpd.paged_decode_attention(q[:, 0], kq, vq, tables, valid, ks,
                                       vs),
            tref.paged_decode_attention_ref(q[:, 0], kq, vq, tables, valid,
                                            ks=ks, vs=vs),
            atol=tol, rtol=tol)
        start = torch.clamp(pt - 2, min=0)
        torch.testing.assert_close(
            tpp.paged_prefill_attention(q, kq, vq, tables, start, ks, vs),
            tref.paged_prefill_attention_ref(q, kq, vq, tables, start, ks=ks,
                                             vs=vs),
            atol=tol, rtol=tol)
        assert _build.launches["paged_decode_quant"] == 1
        assert _build.launches["paged_prefill_quant"] == 1

"""The port's kernel modules against the JAX package's Pallas kernels.

The same inputs, drawn from seeded numpy, go through the JAX kernel (its
real Pallas body under ``interpret=True``, as tests/test_kernels.py runs it
on the CPU) and through the port's wrapper on CPU tensors, which runs the
kernel's plain PyTorch version. Tolerances: float32 atol = rtol = 1e-5,
bfloat16 atol = rtol = 2e-2 (the two frameworks round bf16 products at
different places). The sweeps follow tests/test_kernels.py: HKV=3, odd dh,
sliding windows, non-power-of-two lengths.

Tests marked ``cuda`` hold each Hopper kernel against its plain version on
the card; they skip without a GPU. On a machine with the card and without
JAX, run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py`` (JAX is imported only inside the tests that
compare against it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged_decode as tpd  # noqa: E402
from repro_torch.kernels import paged_prefill as tpp  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import slot_decode as tsd  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

F32, BF16 = "float32", "bfloat16"


def _tol(dt):
    return (dict(atol=2e-2, rtol=2e-2) if dt == BF16
            else dict(atol=1e-5, rtol=1e-5))


def _pair(a: np.ndarray, dt: str):
    """One numpy array as (jax array, torch tensor) of dtype ``dt`` —
    float32 -> bfloat16 rounds the same way in both."""
    import jax.numpy as jnp
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16 and a.dtype == np.float32:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got_t, want_j, dt):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **_tol(dt))


# ---------------------------------------------------------------------------
# rmsnorm (Pallas rmsnorm.py:36)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dt,br,sdt", [
    pytest.param((3, 40, 96), F32, 16, F32, id="shape0-float32-16"),
    pytest.param((2, 33, 256), BF16, 8, F32, id="shape1-bfloat16-8"),
    pytest.param((5, 7, 33), F32, 8, F32, id="shape2-float32-8"),   # odd D
    pytest.param((4, 1, 2048), F32, 4, F32,                # tinyllama decode
                 id="shape3-float32-4"),
    # a bf16 scale (bfloat16 parameters), and rows of 2-12 warps: jamba's D
    # 4096, kimi-k2's 7168, mistral-large's 12288
    pytest.param((4, 1, 2048), BF16, 4, BF16, id="bf16-scale"),
    pytest.param((2, 3, 4096), F32, 8, F32, id="d4096"),
    pytest.param((4, 1, 7168), BF16, 4, BF16, id="d7168-bf16-scale"),
    pytest.param((2, 1, 12288), F32, 2, F32, id="d12288"),
])
def test_rmsnorm_matches_pallas(shape, dt, br, sdt):
    from repro.kernels.rmsnorm import rmsnorm
    rng = np.random.default_rng(sum(shape))
    xj, xt = _pair(_randn(rng, *shape), dt)
    s = _randn(rng, shape[-1]) * 0.1 + 1.0
    sj, st = _pair(s, sdt)
    want = rmsnorm(xj, sj, block_rows=br, interpret=True)
    _close(trms.rmsnorm(xt, st), want, dt)
    _close(tops.rmsnorm(xt, st, eps=1e-5), want, dt)


# ---------------------------------------------------------------------------
# flash attention (Pallas flash_attention.py:164)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,HQ,HKV,dh,window,dt", [
    (2, 64, 4, 2, 64, 0, F32),
    (1, 50, 6, 3, 80, 0, F32),        # HKV=3, non-pow2 S
    (1, 77, 4, 2, 33, 16, F32),       # odd dh, sliding window
    (2, 40, 4, 1, 128, 8, BF16),      # MQA, window, bf16
    (1, 32, 32, 4, 64, 0, F32),       # tinyllama admission prefill shape
])
def test_flash_attention_matches_pallas(B, S, HQ, HKV, dh, window, dt):
    from repro.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(S * dh)
    qj, qt = _pair(_randn(rng, B, S, HQ, dh), dt)
    kj, kt = _pair(_randn(rng, B, S, HKV, dh), dt)
    vj, vt = _pair(_randn(rng, B, S, HKV, dh), dt)
    want = flash_attention(qj, kj, vj, causal=True, window=window,
                           block_q=32, block_k=32, interpret=True)
    _close(tfa.flash_attention(qt, kt, vt, causal=True, window=window),
           want, dt)
    _close(tops.flash_attention(qt, kt, vt, window=window), want, dt)


def test_flash_attention_plain_matches_jax_oracle_noncausal():
    """causal=False (the kernel takes it; serving never uses it) against
    the JAX oracle ``flash_attention_ref``."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    qj, qt = _pair(_randn(rng, 1, 24, 4, 16), F32)
    kj, kt = _pair(_randn(rng, 1, 24, 2, 16), F32)
    vj, vt = _pair(_randn(rng, 1, 24, 2, 16), F32)
    _close(tfa.flash_attention(qt, kt, vt, causal=False, window=6),
           jref.flash_attention_ref(qj, kj, vj, causal=False, window=6), F32)


# ---------------------------------------------------------------------------
# slot decode (Pallas slot_decode.py:52, body decode_attention.py:22)
# ---------------------------------------------------------------------------

def _valid(B, T, lives):
    valid = np.zeros((B, T), bool)
    for b, live in enumerate(lives):
        valid[b, :live] = True
    return valid


@pytest.mark.parametrize("B,T,HQ,HKV,dh,block_t,lives,dt", [
    (3, 32, 4, 2, 64, 16, (5, 20, 1), F32),     # mixed occupancy
    (2, 24, 6, 3, 64, 8, (24, 7), F32),         # non-pow2 heads (3)
    (2, 40, 8, 2, 80, 16, (33, 2), F32),        # dh=80, ragged T
    (2, 20, 4, 2, 33, 8, (20, 3), F32),         # odd dh
    (2, 32, 4, 1, 128, 16, (31, 16), BF16),     # MQA, bf16
    (2, 24, 4, 2, 16, 8, (9, 0), F32),          # a row with no valid key
    (4, 72, 32, 4, 64, 32, (33, 49, 64, 5), F32),  # tinyllama engine decode
])
def test_slot_decode_matches_pallas(B, T, HQ, HKV, dh, block_t, lives, dt):
    """Includes the zero-row rule: a slot with no valid key decodes to
    zeros in the Pallas kernel (l clamped at 1e-30) and in the plain
    version."""
    from repro.kernels.slot_decode import slot_decode_attention
    rng = np.random.default_rng(T * dh + B)
    qj, qt = _pair(_randn(rng, B, HQ, dh), dt)
    kj, kt = _pair(_randn(rng, B, T, HKV, dh), dt)
    vj, vt = _pair(_randn(rng, B, T, HKV, dh), dt)
    mj, mt = _pair(_valid(B, T, lives), dt)
    want = slot_decode_attention(qj, kj, vj, mj, block_t=block_t,
                                 interpret=True)
    got = tsd.slot_decode_attention(qt, kt, vt, mt)
    _close(got, want, dt)
    empty = [b for b, live in enumerate(lives) if live == 0]
    assert all(float(got[b].abs().max()) == 0.0 for b in empty)


@pytest.mark.parametrize("B,T,HQ,HKV,dh,live,dt", [
    (2, 100, 8, 2, 80, 77, F32),
    (1, 64, 4, 4, 64, 64, BF16),
    (3, 130, 6, 3, 33, 1, F32),          # single live slot, HKV=3, odd dh
])
def test_decode_attention_matches_pallas(B, T, HQ, HKV, dh, live, dt):
    from repro.kernels.decode_attention import decode_attention
    rng = np.random.default_rng(T + dh)
    qj, qt = _pair(_randn(rng, B, HQ, dh), dt)
    kj, kt = _pair(_randn(rng, B, T, HKV, dh), dt)
    vj, vt = _pair(_randn(rng, B, T, HKV, dh), dt)
    mj, mt = _pair(np.arange(T) < live, dt)
    want = decode_attention(qj, kj, vj, mj, block_t=32, interpret=True)
    _close(tdec.decode_attention(qt, kt, vt, mt), want, dt)


# ---------------------------------------------------------------------------
# ops: the mask construction (JAX ops.py:33-58) together with the kernels
# ---------------------------------------------------------------------------

def _slot_positions(rng, B, T):
    """Per-slot cache marks with empty (-1) entries and circular wrap: row b
    sits at position pos[b]; its entries hold the positions written last."""
    pos = rng.integers(0, 3 * T, size=B).astype(np.int32)
    slot_pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        for p in range(max(0, pos[b] - T + 1), pos[b] + 1):
            slot_pos[b, p % T] = p
    return slot_pos, pos


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("B,T,HQ,HKV,dh", [(3, 16, 6, 3, 16), (2, 24, 4, 2, 33)])
def test_ops_slot_decode_masks_match_jax(B, T, HQ, HKV, dh, window):
    from repro.kernels import ops as jops
    rng = np.random.default_rng(B * T + window)
    qj, qt = _pair(_randn(rng, B, 1, HQ, dh), F32)
    kj, kt = _pair(_randn(rng, B, T, HKV, dh), F32)
    vj, vt = _pair(_randn(rng, B, T, HKV, dh), F32)
    sp, pos = _slot_positions(rng, B, T)
    spj, spt = _pair(sp, F32)
    pj, pt = _pair(pos, F32)
    want = jops.slot_decode_attention(qj, kj, vj, spj, pj, window=window)
    got = tops.slot_decode_attention(qt, kt, vt, spt, pt, window=window)
    assert got.shape == (B, 1, HQ, dh)
    _close(got, want, F32)


@pytest.mark.parametrize("pos,window", [(9, 0), (30, 0), (30, 7)])
def test_ops_decode_masks_match_jax(pos, window):
    from repro.kernels import ops as jops
    B, T, HQ, HKV, dh = 2, 16, 4, 2, 16
    rng = np.random.default_rng(pos + window)
    qj, qt = _pair(_randn(rng, B, 1, HQ, dh), F32)
    kj, kt = _pair(_randn(rng, B, T, HKV, dh), F32)
    vj, vt = _pair(_randn(rng, B, T, HKV, dh), F32)
    sp = np.full((T,), -1, np.int32)
    for p in range(max(0, pos - T + 1), pos + 1):
        sp[p % T] = p
    spj, spt = _pair(sp, F32)
    want = jops.decode_attention(qj, kj, vj, spj, np.int32(pos),
                                 window=window)
    got = tops.decode_attention(qt, kt, vt, spt,
                                torch.tensor(pos, dtype=torch.int32),
                                window=window)
    _close(got, want, F32)


# ---------------------------------------------------------------------------
# dispatch: by tensor device, never a quiet fallback
# ---------------------------------------------------------------------------

def _meta_calls():
    m = dict(device="meta")
    q4, k4 = torch.empty(1, 8, 4, 16, **m), torch.empty(1, 8, 2, 16, **m)
    q3 = torch.empty(1, 4, 16, **m)
    valid = torch.empty(1, 8, dtype=torch.bool, **m)
    pool = torch.empty(3, 4, 2, 16, **m)
    tables = torch.empty(1, 2, dtype=torch.int32, **m)
    return {
        "rmsnorm": lambda: trms.rmsnorm(torch.empty(2, 16, **m),
                                        torch.empty(16, **m)),
        "flash_attention": lambda: tfa.flash_attention(q4, k4, k4),
        "slot_decode": lambda: tsd.slot_decode_attention(q3, k4, k4, valid),
        "decode_attention": lambda: tdec.decode_attention(q3, k4, k4,
                                                          valid[0]),
        "paged_decode": lambda: tpd.paged_decode_attention(q3, pool, pool,
                                                           tables, valid),
        "paged_prefill": lambda: tpp.paged_prefill_attention(
            q4[:, :2], pool, pool, tables,
            torch.empty(1, dtype=torch.int32, **m)),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "slot_decode",
                                  "decode_attention", "paged_decode",
                                  "paged_prefill"])
def test_non_cpu_tensors_never_reach_the_plain_version(name, monkeypatch):
    """Tensors off the CPU (here: meta tensors) go to the kernel or raise;
    the plain version is never called for them."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(trms, "rmsnorm_ref", boom)
    monkeypatch.setattr(tfa, "flash_attention_ref", boom)
    monkeypatch.setattr(tsd, "slot_decode_attention_ref", boom)
    monkeypatch.setattr(tpd, "paged_decode_attention_ref", boom)
    monkeypatch.setattr(tpp, "paged_prefill_attention_ref", boom)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        _meta_calls()[name]()


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        _build.on_cuda(torch.zeros(2), torch.zeros(2, device="meta"))
    assert _build.on_cuda(torch.zeros(1)) is False


def test_cpu_calls_launch_nothing():
    tops.reset_launch_counts()
    tops.rmsnorm(torch.ones(2, 8), torch.ones(8))
    q = torch.randn(1, 4, 2, 8)
    tops.flash_attention(q, q, q)
    assert tops.launch_counts() == {}


def test_build_fingerprint_tracks_sources(tmp_path):
    """The library is keyed by a hash of the sources and headers, so an
    edited kernel rebuilds."""
    a = tmp_path / "a.cu"
    a.write_text("// one")
    h1 = _build._fingerprint([a], [])
    a.write_text("// two")
    assert _build._fingerprint([a], []) != h1
    srcs = sorted(_build.CSRC.glob("*.cu"))
    assert {p.name for p in srcs} == {"rmsnorm.cu", "flash_attention.cu",
                                      "flash_attention_bwd.cu",
                                      "decode_attention.cu",
                                      "paged_prefill.cu", "moe_route.cu",
                                      "rwkv_scan.cu", "mamba_scan.cu"}


# ---------------------------------------------------------------------------
# on the card: each Hopper kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU "
                    "interpret mode)")
    return torch.device("cuda")


def _card_tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda, dtype):
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    tol = _card_tol(dtype)
    x, s = rn(5, 7, 33), torch.rand(33, generator=g, device=cuda) + 0.5
    torch.testing.assert_close(tops.rmsnorm(x, s), tref.rmsnorm_ref(x, s),
                               atol=tol, rtol=tol)
    sb = s.to(torch.bfloat16)               # bfloat16 parameters' scale
    torch.testing.assert_close(tops.rmsnorm(x, sb), tref.rmsnorm_ref(x, sb),
                               atol=tol, rtol=tol)
    q, k = rn(1, 77, 6, 33), rn(1, 77, 3, 33)
    v = rn(1, 77, 3, 33)
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, window=16),
        tref.flash_attention_ref(q, k, v, window=16), atol=tol, rtol=tol)
    # 300 positions (not whole row tiles), G 4, dh 128, with and without
    # a window: the register tiles' row limits
    q, k, v = rn(1, 300, 16, 128), rn(1, 300, 4, 128), rn(1, 300, 4, 128)
    for window in (0, 100):
        torch.testing.assert_close(
            tops.flash_attention(q, k, v, window=window),
            tref.flash_attention_ref(q, k, v, window=window), atol=tol,
            rtol=tol)
    # split over T with a combine pass (700 keys: 2 splits), an empty row
    q, k, v = rn(2, 8, 64), rn(2, 700, 2, 64), rn(2, 700, 2, 64)
    valid = torch.zeros(2, 700, dtype=torch.bool, device=cuda)
    valid[0, 3:650] = True                  # row 1 has no valid key
    assert tsd.num_splits(2, 2, 700) > 1
    got = tsd.slot_decode_attention(q, k, v, valid)
    torch.testing.assert_close(got, tref.slot_decode_attention_ref(
        q, k, v, valid), atol=tol, rtol=tol)
    assert float(got[1].abs().max()) == 0.0
    q, k, v = rn(2, 6, 80), rn(2, 40, 3, 80), rn(2, 40, 3, 80)
    valid = torch.zeros(2, 40, dtype=torch.bool, device=cuda)
    valid[0, :33] = True                    # row 1 has no valid key
    got = tsd.slot_decode_attention(q, k, v, valid)
    torch.testing.assert_close(got, tref.slot_decode_attention_ref(
        q, k, v, valid), atol=tol, rtol=tol)
    assert float(got[1].abs().max()) == 0.0
    # the uniform wrapper (--load seq): one (T,) mask built by ops from
    # slot_pos/pos, broadcast as a stride-0 view to the slot kernel
    q, k, v = rn(2, 32, 64), rn(2, 72, 4, 64), rn(2, 72, 4, 64)
    i = torch.arange(72, device=cuda)
    slot_pos = torch.where(i < 52, i, -1).to(torch.int32)
    pos = torch.tensor(49, dtype=torch.int32, device=cuda)
    got = tops.decode_attention(q[:, None], k, v, slot_pos, pos)[:, 0]
    torch.testing.assert_close(got, tref.decode_attention_ref(
        q, k, v, i < 50), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_launch_error_raises_not_falls_back(cuda, monkeypatch):
    """A failing launch raises; the plain version is never consulted."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(tsd, "slot_decode_attention_ref", boom)
    q = torch.zeros(1, 4, 300, device=cuda)          # dh > 256: refused
    k = torch.zeros(1, 8, 2, 300, device=cuda)
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="bad shapes"):
        tsd.slot_decode_attention(q, k, k, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_matches_plain(cuda, dtype, monkeypatch):
    """``flash_attention_bwd`` against the plain backward on the same
    values in float32 (max |d| within 1e-4 / 2e-2 of the largest |grad|:
    fp32 sums in another order; bf16 rounds P, dS and its outputs), two
    runs bit-identical, at a window with odd dh and G 2, 300 positions at
    dh 128 and G 4, S 1, dh 80 with a window and dh 112 at G 3; the
    forward's lse against the plain one (1e-4 / 2e-2 of max(1, |lse|)) and
    its output bit-identical with the lse pointer null or set; through the
    ``FlashAttention`` Function the same gradients without the plain
    version consulted; a call without lse and dh above 128 raise; a
    serving wrapper refuses a grad-requiring input."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    tol = _card_tol(dtype)
    for B, S, HQ, HKV, dh, window in ((1, 77, 6, 3, 33, 16),
                                      (2, 300, 16, 4, 128, 0),
                                      (1, 1, 4, 2, 64, 0),
                                      (2, 190, 8, 2, 80, 70),
                                      (1, 129, 6, 2, 112, 0)):
        q, k, v, do = (rn(B, S, HQ, dh), rn(B, S, HKV, dh),
                       rn(B, S, HKV, dh), rn(B, S, HQ, dh))
        with torch.no_grad():
            o_serve = tfa.flash_attention(q, k, v, window=window)
            o, lse = tfa.flash_attention_with_lse(q, k, v, window=window)
        _, lse_want = tref.flash_attention_ref(
            q.float(), k.float(), v.float(), window=window, return_lse=True)
        assert torch.equal(o, o_serve)
        assert float((lse - lse_want).abs().max()) <= tol * max(
            1.0, float(lse_want.abs().max()))
        got = tfa.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        again = tfa.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        want = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                            do.float(), window=window)
        top = max(max(float(w.abs().max()) for w in want), 1.0)
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, b) and a.dtype == dtype
            assert float((a.float() - w).abs().max()) <= tol * top
    with pytest.raises(ValueError, match="log-sum-exp"):
        tfa.flash_attention_bwd(q, k, v, o, do, window=window)
    monkeypatch.setattr(tfa, "flash_attention_bwd_ref",
                        lambda *a, **k: pytest.fail("plain backward called"))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(
        tfa.flash_attention(*leaves, window=window), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, got))
    big = torch.zeros(1, 4, 2, 136, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="128"):
        tfa.flash_attention_bwd(big, big[:, :, :1], big[:, :, :1], big, big)
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        tsd.slot_decode_attention(
            torch.zeros(1, 4, 64, device=cuda, requires_grad=True), kv, kv,
            torch.ones(1, 8, dtype=torch.bool, device=cuda))

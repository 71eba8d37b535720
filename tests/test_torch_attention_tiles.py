"""The numeric contracts of the flash and slot decode kernels, on the CPU.

The card alone can run ``csrc/flash_attention.cu`` and
``csrc/decode_attention.cu``, so these tests emulate their arithmetic in
plain PyTorch and hold the emulations against the JAX package (its Pallas
kernels in interpret mode and its oracles) and the port's plain versions.

Flash, bf16 (``flash_contract``): the register tiles of
``csrc/register_tiles.cuh`` (``TcTile``). The query rows of a (batch, KV
head) are packed G heads a position (row r: position r // G, head
hk*G + r % G), 64 rows a block; row r sees keys ``lo <= t < hi`` with
``hi = min(Sk, p + 1)`` when causal (else Sk) and
``lo = max(0, p - window + 1)`` with a window (else 0); a block walks the
64-key tiles from its least ``lo`` to its greatest ``hi`` with an online
softmax: bf16 operands, fp32 sums, P rounded to bf16 before P V, the row
sum over the unrounded P. Tolerance |emulation - reference| <=
2e-2 (1 + |reference|), bfloat16's: P and the output are rounded once, the
references round at other places.

Slot decode (``split_contract``): the cache cut into ``num_splits`` key
ranges ``[s*T//n, (s+1)*T//n)``; each split's unnormalised fp32 O, running
max m and sum l per query head (a split with no valid key: m = NEG_INF,
l = 0, O = 0), merged as ``O = sum_s e^(m_s - m*) O_s /
max(sum_s e^(m_s - m*) l_s, 1e-30)``, which writes zeros for a row with no
valid key. Tolerance 1e-5 in fp32 (sums in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import slot_decode as tsd  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ROWS, TILE_KEYS = 64, 64
NEG_INF = -1e30
BF16_TOL, F32_TOL = 2e-2, 1e-5


# ---------------------------------------------------------------------------
# flash attention, bf16 tensor-core tiles
# ---------------------------------------------------------------------------

def row_limits(pos, Sk, causal, window):
    """The key range [lo, hi) of a query at position ``pos``."""
    hi = torch.clamp(pos + 1, max=Sk) if causal else torch.full_like(pos, Sk)
    lo = torch.clamp(pos - window + 1, min=0) if window > 0 else \
        torch.zeros_like(pos)
    return lo, hi


def flash_contract(q, k, v, *, causal=True, window=0):
    """The bf16 flash kernel's arithmetic: q (B,Sq,HQ,dh), k/v (B,Sk,HKV,dh)
    bf16 -> (B,Sq,HQ,dh) bf16."""
    B, Sq, HQ, dh = q.shape
    Sk, HKV = k.shape[1], k.shape[2]
    G, rows = HQ // HKV, Sq * HQ // HKV
    scale = 1.0 / math.sqrt(dh)
    # (B, HKV, rows, dh): row r is position r // G of head hk*G + r % G
    qr = q.float().reshape(B, Sq, HKV, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, HKV, rows, dh)
    kf = k.float().transpose(1, 2)                          # (B, HKV, Sk, dh)
    vf = v.float().transpose(1, 2)
    pos = torch.arange(rows) // G
    lo, hi = row_limits(pos, Sk, causal, window)
    out = torch.zeros(B, HKV, rows, dh)
    for r0 in range(0, rows, ROWS):
        sl = slice(r0, min(r0 + ROWS, rows))
        k_lo, k_hi = int(lo[sl].min()), int(hi[sl].max())
        m = torch.full((B, HKV, sl.stop - r0, 1), NEG_INF)
        l = torch.zeros(B, HKV, sl.stop - r0, 1)
        o = torch.zeros(B, HKV, sl.stop - r0, dh)
        t_end = -(-k_hi // TILE_KEYS) if k_lo < k_hi else 0
        for t in range(k_lo // TILE_KEYS, t_end):
            keys = torch.arange(t * TILE_KEYS, (t + 1) * TILE_KEYS)
            ks = keys.clamp(max=Sk - 1)
            live = ((keys[None] >= lo[sl, None]) & (keys[None] < hi[sl, None])
                    & (keys[None] < k_hi))
            s = qr[:, :, sl] @ kf[:, :, ks].transpose(-1, -2)
            s = torch.where(live, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(scale * (m - m_new))
            p = torch.where(live, torch.exp(scale * (s - m_new)),
                            torch.zeros_like(s))
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + p.to(torch.bfloat16).float() @ vf[:, :, ks]
            m = m_new
        out[:, :, sl] = o / torch.clamp(l, min=1e-30)
    return out.reshape(B, HKV, Sq, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, HQ, dh).to(torch.bfloat16)


def _within(got, want, tol, what):
    got = got.float()
    want = torch.from_numpy(np.array(want, np.float32))
    err = (got - want).abs()
    lim = tol * (1 + want.abs())
    assert torch.isfinite(got).all() and (err <= lim).all(), (
        f"{what}: max |err| {err.max().item():.3e} beyond {tol} (1 + |o|)")


FLASH_SHAPES = {
    # B, S, HQ, HKV, dh, causal, window
    "causal G=4 S=130": (1, 130, 8, 2, 64, True, 0),
    "window=40 G=3 odd dh=33 S=100": (2, 100, 6, 2, 33, True, 40),
    "non-causal window=24 G=2 S=77": (1, 77, 4, 2, 16, False, 24),
    "window=8 G=8 dh=128 S=70": (1, 70, 8, 1, 128, True, 8),
}


@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
def test_flash_bf16_tile_contract_matches_pallas_and_references(shape):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as jflash
    B, S, HQ, HKV, dh, causal, window = FLASH_SHAPES[shape]
    rng = np.random.default_rng(S * dh + HQ)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, HQ, dh), (B, S, HKV, dh), (B, S, HKV, dh))]
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    got = flash_contract(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    _within(got, tref.flash_attention_ref(qt, kt, vt, causal=causal,
                                          window=window).float(),
            BF16_TOL, "plain version")
    _within(got, jref.flash_attention_ref(qj, kj, vj, causal=causal,
                                          window=window).astype(jnp.float32),
            BF16_TOL, "JAX oracle")
    _within(got, jflash(qj, kj, vj, causal=causal, window=window, block_q=32,
                        block_k=32, interpret=True).astype(jnp.float32),
            BF16_TOL, "Pallas kernel (interpret)")


def test_flash_row_limits_are_the_reference_mask():
    """[lo, hi) per row is the plain version's mask (qpos >= kpos,
    qpos - kpos < window) for every mode, and the block's tile range
    covers every row's keys."""
    Sq = Sk = 150
    q_pos, k_pos = torch.arange(Sq), torch.arange(Sk)
    for causal, window in ((True, 0), (True, 33), (False, 33), (False, 0)):
        lo, hi = row_limits(q_pos, Sk, causal, window)
        mask = torch.ones(Sq, Sk, dtype=torch.bool)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None]
        if window > 0:
            mask &= q_pos[:, None] - k_pos[None] < window
        rng_mask = (k_pos[None] >= lo[:, None]) & (k_pos[None] < hi[:, None])
        assert torch.equal(mask, rng_mask), (causal, window)
        for G in (1, 3, 8):
            pos = torch.arange(Sq * G) // G
            lo_r, hi_r = row_limits(pos, Sk, causal, window)
            for r0 in range(0, Sq * G, ROWS):
                blk = slice(r0, min(r0 + ROWS, Sq * G))
                # the kernel's block range from its first and last rows
                first, last = lo_r[blk][0], hi_r[blk][-1]
                assert first == lo_r[blk].min() and last == hi_r[blk].max()


# ---------------------------------------------------------------------------
# slot decode: split over T, then the combine pass
# ---------------------------------------------------------------------------

def split_bounds(T, n):
    """The key ranges ``[start, end)`` of the n splits of T keys, as the
    kernel computes them."""
    return [(s * T // n, (s + 1) * T // n) for s in range(n)]


def split_contract(q, k, v, valid, nsplit):
    """Slot decode as the kernel splits it: q (B,HQ,dh), k/v (B,T,HKV,dh),
    valid (B,T) bool -> (B,HQ,dh) in q's dtype. In bf16 (the tensor-core
    kernel) p is rounded to bf16 before P V, the row sum over the unrounded
    p."""
    B, HQ, dh = q.shape
    T, HKV = k.shape[1], k.shape[2]
    G = HQ // HKV
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(B, HKV, G, dh)
    ms, ls, os_ = [], [], []
    for ks, ke in split_bounds(T, nsplit):
        s = torch.einsum("bhgd,bkhd->bhgk", qg, k[:, ks:ke].float()) * scale
        live = valid[:, None, None, ks:ke]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1, keepdim=True) if ke > ks else torch.full(
            (B, HKV, G, 1), NEG_INF)
        m = torch.where(live.any(-1, keepdim=True), m,
                        torch.full_like(m, NEG_INF))
        p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        pv = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 else p
        os_.append(torch.einsum("bhgk,bkhd->bhgd", pv, v[:, ks:ke].float()))
    m_all = torch.stack(ms)                                 # (n, B, HKV, G, 1)
    w = torch.exp(m_all - m_all.amax(0))
    den = (w * torch.stack(ls)).sum(0)
    out = (w * torch.stack(os_)).sum(0) / torch.clamp(den, min=1e-30)
    return out.reshape(B, HQ, dh).to(q.dtype)


def _valid(B, T, ranges):
    valid = np.zeros((B, T), bool)
    for b, (a, e) in enumerate(ranges):
        valid[b, a:e] = True
    return valid


SPLIT_CASES = {
    # B, T, HQ, HKV, dh, nsplit ("T": one split a key), live ranges per row
    "nsplit=1": (2, 40, 8, 2, 32, 1, ((0, 33), (5, 40))),
    "nsplit=2 empty row": (3, 50, 6, 3, 33, 2, ((0, 50), (0, 0), (7, 9))),
    "nsplit=T": (2, 24, 4, 2, 16, "T", ((0, 24), (3, 20))),
    "a split all masked nsplit=4": (2, 80, 8, 1, 64, 4, ((0, 15), (50, 80))),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_slot_decode_split_contract_matches_pallas_and_references(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.slot_decode import slot_decode_attention as jslot
    B, T, HQ, HKV, dh, nsplit, ranges = SPLIT_CASES[case]
    nsplit = T if nsplit == "T" else nsplit
    rng = np.random.default_rng(T * dh + B)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, HQ, dh), (B, T, HKV, dh), (B, T, HKV, dh))]
    valid = _valid(B, T, ranges)
    qt, kt, vt = (torch.from_numpy(a) for a in arrs)
    mt = torch.from_numpy(valid)
    got = split_contract(qt, kt, vt, mt, nsplit)
    np.testing.assert_allclose(
        got.numpy(), tref.slot_decode_attention_ref(qt, kt, vt, mt).numpy(),
        atol=F32_TOL, rtol=F32_TOL)
    pallas = jslot(*(jnp.asarray(a) for a in arrs), jnp.asarray(valid),
                   block_t=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               atol=F32_TOL, rtol=F32_TOL)
    live = valid.any(-1)                 # the JAX oracle gives NaN elsewhere
    oracle = np.asarray(jref.slot_decode_attention_ref(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(valid)))
    np.testing.assert_allclose(got.numpy()[live], oracle[live],
                               atol=F32_TOL, rtol=F32_TOL)
    assert not got.numpy()[~live].any()  # a row with no valid key: zeros


def test_slot_decode_bf16_split_contract_matches_pallas():
    """The tensor-core kernel's bf16 contract, split in 3 with an empty row
    and HKV 3, against the Pallas kernel in interpret mode."""
    import jax.numpy as jnp
    from repro.kernels.slot_decode import slot_decode_attention as jslot
    B, T, HQ, HKV, dh = 3, 200, 6, 3, 64
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, HQ, dh), (B, T, HKV, dh), (B, T, HKV, dh))]
    valid = _valid(B, T, ((0, 200), (0, 0), (70, 140)))
    got = split_contract(*(torch.from_numpy(a).to(torch.bfloat16)
                           for a in arrs), torch.from_numpy(valid), 3)
    assert got.dtype == torch.bfloat16
    want = jslot(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrs),
                 jnp.asarray(valid), block_t=32, interpret=True)
    _within(got, want.astype(jnp.float32), BF16_TOL, "Pallas kernel")
    assert not got[1].float().abs().max()


def test_slot_decode_split_contract_uniform_stride0_mask():
    """The uniform wrapper's (T,) mask as a stride-0 (B,T) view, split in
    3, against the Pallas uniform kernel."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as jdec
    B, T, HQ, HKV, dh = 3, 90, 6, 3, 20
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, HQ, dh), (B, T, HKV, dh), (B, T, HKV, dh))]
    valid = (np.arange(T) % 7 != 3) & (np.arange(T) < 71)
    mt = torch.from_numpy(valid)[None].expand(B, T)
    assert mt.stride(0) == 0
    got = split_contract(*(torch.from_numpy(a) for a in arrs), mt, 3)
    want = jdec(*(jnp.asarray(a) for a in arrs), jnp.asarray(valid),
                block_t=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


# ---------------------------------------------------------------------------
# num_splits: the wrapper's choice of splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,HKV", [(1, 1), (4, 4), (32, 4), (32, 16),
                                   (3, 3), (256, 8)])
def test_num_splits_cover_T_with_non_empty_splits(B, HKV):
    for T in list(range(1, 200)) + [700, 2048, 4096, 4097, 10000, 100000]:
        n = tsd.num_splits(B, HKV, T)
        bounds = split_bounds(T, n)
        assert 1 <= n <= T
        assert bounds[0][0] == 0 and bounds[-1][1] == T
        assert all(a < e for a, e in bounds)                 # non-empty
        assert all(e == a2 for (_, e), (a2, _) in zip(bounds, bounds[1:]))
        assert max(e - a for a, e in bounds) <= tsd.MAX_SPLIT_KEYS
        if T >= tsd.MIN_SPLIT_KEYS:
            assert min(e - a for a, e in bounds) >= tsd.MIN_SPLIT_KEYS


def test_num_splits_at_the_path_and_large_shapes():
    assert tsd.num_splits(4, 4, 72) == 1         # tinyllama path: 16 blocks
    assert tsd.num_splits(32, 4, 2048) == 2      # 256 blocks of 1024 keys
    assert tsd.num_splits(32, 16, 2048) == 1     # already 512 blocks
    assert tsd.num_splits(1, 4, 2048) == 8       # 32 blocks of 256 keys
    assert tsd.num_splits(1, 1, 0) == 1          # an empty cache

"""The flash backward kernel's decomposition, emulated in plain PyTorch.

``csrc/flash_attention_bwd.cu`` runs on the card only. What decides its
result beyond the arithmetic of one tile is kept in Python that the CPU
reaches: ``bwd_geometry`` cuts each key tile's (head, query tile) steps
into chunks, a dkdv block runs one chunk, and a reduce sums a tile's
chunks in order. Here the same cut, step order, masks, P = 2^(s scale
log2e - lse log2e) from the forward's row log-sum-exp and (bf16) P and dS
rounded before they multiply are replayed over the plain version's
tensors and held against ``flash_attention_bwd_ref`` (fp32: 1e-5 of the
largest |grad|; bf16 rounding: 2e-2, the card's tolerance), with
``bwd_geometry``'s invariants: every step in exactly one chunk, no chunk
above ``chunk``, ``chunks`` the blocks a (batch, KV head), the reduce
launch exactly when a tile has several chunks.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

LOG2E = 1.4426950408889634
#: B, S, HQ, HKV, dh, window (all causal): HKV 3, odd dh (padded to 64),
#: a window inside one key tile and one across three, ragged S, S 1,
#: dh 80 and 112
CASES = [
    (2, 130, 6, 3, 33, 0),
    (1, 200, 4, 2, 80, 100),
    (2, 77, 4, 1, 112, 16),
    (1, 1, 4, 2, 64, 0),
    (1, 150, 8, 2, 128, 0),
]


def _live(S, causal, window):
    i = torch.arange(S)
    live = torch.ones(S, S, dtype=torch.bool)
    if causal:
        live &= i[:, None] >= i[None, :]
    if window:
        live &= i[:, None] - i[None, :] < window
    return live


def emulate_bwd(q, k, v, o, do, lse, *, causal, window, geo, bf16):
    """The kernel's launches over float32 copies: delta and dQ by
    query rows (the dq launch); dK, dV block by block in the dkdv launch's
    order, each block's steps in order, the partials of a tile of several
    chunks summed in chunk order (the reduce launch)."""
    B, S, HQ, dh = q.shape
    HKV = k.shape[2]
    G, scale = HQ // HKV, 1.0 / math.sqrt(dh)
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    live = _live(S, causal, window)
    delta = (do * o).sum(-1)                            # (B, S, HQ)

    def p_ds(b, h, rows, keys):
        hk = h // G
        s = q[b, rows, h] @ k[b, keys, hk].T
        p = torch.exp2(s * (scale * LOG2E) - lse[b, h, rows, None] * LOG2E)
        p = torch.where(live[rows][:, keys], p, torch.zeros(()))
        dp = do[b, rows, h] @ v[b, keys, hk].T
        return p, p * (dp - delta[b, rows, h, None])

    dq = torch.zeros_like(q)
    every = torch.arange(S)
    for b in range(B):
        for h in range(HQ):
            _, ds = p_ds(b, h, every, every)
            dq[b, :, h] = scale * (rnd(ds) @ k[b, :, h // G])

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    steps = kfa.bwd_steps(S, G, causal, window, geo.bqs)
    n_blocks = 0
    for b in range(B):
        for hk in range(HKV):
            for kt, n in enumerate(steps):
                x, y = kfa.bwd_query_tiles(kt, S, causal, window, geo.bqs)
                nq = y - x
                keys = torch.arange(kt * kfa.BWD_KEYS,
                                    min(S, (kt + 1) * kfa.BWD_KEYS))
                parts = []
                for c in range(max(1, -(-n // geo.chunk))):
                    n_blocks += 1
                    ak = torch.zeros(len(keys), dh)
                    av = torch.zeros(len(keys), dh)
                    for i in range(c * geo.chunk, min(n, (c + 1) * geo.chunk)):
                        h, qt = hk * G + i // nq, x + i % nq
                        rows = torch.arange(qt * geo.bqs,
                                            min(S, (qt + 1) * geo.bqs))
                        p, ds = p_ds(b, h, rows, keys)
                        av += rnd(p).T @ do[b, rows, h]
                        ak += rnd(ds).T @ q[b, rows, h]
                    parts.append((ak, av))
                sk, sv = parts[0]
                for ak, av in parts[1:]:
                    sk, sv = sk + ak, sv + av
                dk[b, keys, hk], dv[b, keys, hk] = sk * scale, sv
    assert n_blocks == geo.chunks * B * HKV
    return dq, dk, dv


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,HQ,HKV,dh,window", CASES)
def test_emulated_decomposition_matches_plain(B, S, HQ, HKV, dh, window,
                                              bf16):
    """The chunked dK/dV and the dq rows, from the forward's lse, against
    the plain backward on the same values, at a small slot count (several
    chunks a tile and the reduce) and a large one (one step a block)."""
    g = torch.Generator().manual_seed(B * 1000 + S + dh)
    q, do = (torch.randn(B, S, HQ, dh, generator=g) for _ in range(2))
    k, v = (torch.randn(B, S, HKV, dh, generator=g) for _ in range(2))
    o, lse = flash_attention_ref(q, k, v, window=window, return_lse=True)
    want = flash_attention_bwd_ref(q, k, v, do, window=window)
    top = max(max(float(w.abs().max()) for w in want), 1.0)
    tol = 2e-2 if bf16 else 1e-5
    dtype = torch.bfloat16 if bf16 else torch.float32
    for slots in (3, 10_000):
        geo = kfa.bwd_geometry(B, S, HQ, HKV, dh, True, window, dtype, slots)
        got = emulate_bwd(q, k, v, o, do, lse, causal=True, window=window,
                          geo=geo, bf16=bf16)
        for a, w, n in zip(got, want, ("dq", "dk", "dv")):
            err = float((a - w).abs().max())
            assert err <= tol * top, (n, slots, err, top)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [
    (4, 1024, 32, 4, 64, 0), (1, 1024, 28, 4, 128, 0),
    (1, 1024, 64, 8, 112, 0), (1, 4128, 32, 8, 80, 4096),
    (2, 333, 32, 8, 80, 100), (2, 1, 32, 4, 64, 0), (3, 70, 9, 3, 40, 0)])
def test_bwd_geometry_invariants(shape, dtype):
    """At the training path's, the zoo's and the ragged shapes, for a card
    of 132 SMs holding 1-4 dkdv blocks each and for a small and a huge
    slot count: the instantiation and query step, each tile's steps cut
    into chunks of at most ``chunk`` covering them once, ``chunks`` their
    count, ``split``/``launches`` exactly when a tile has several, and the
    step counts those of a brute-force mask."""
    B, S, HQ, HKV, dh, window = shape
    dp = kfa.bwd_head_dim(dh)
    assert dp in kfa.BWD_HEAD_DIMS and dh <= dp
    assert dp == min(d for d in kfa.BWD_HEAD_DIMS if d >= dh)
    bqs = kfa.bwd_query_step(dtype, dp)
    live = _live(S, True, window)
    for kt, n in enumerate(kfa.bwd_steps(S, HQ // HKV, True, window, bqs)):
        cols = live[:, kt * 64:(kt + 1) * 64].any(1)
        tiles = {int(p) // bqs for p in torch.nonzero(cols)}
        x, y = kfa.bwd_query_tiles(kt, S, True, window, bqs)
        assert tiles == set(range(x, y)) and n == HQ // HKV * (y - x)
    for slots in (1, 132, 264, 396, 528, 10 ** 6):
        geo = kfa.bwd_geometry(B, S, HQ, HKV, dh, True, window, dtype, slots)
        steps = kfa.bwd_steps(S, HQ // HKV, True, window, geo.bqs)
        assert (geo.dp, geo.bqs) == (dp, bqs) and geo.chunk >= 1
        per = [max(1, -(-n // geo.chunk)) for n in steps]
        assert geo.chunks == sum(per)
        assert all(n <= c * geo.chunk and (n > (c - 1) * geo.chunk or n == 0)
                   for n, c in zip(steps, per))
        assert geo.split == any(c > 1 for c in per)
        assert geo.launches == (3 if geo.split else 2)
    # a card that holds every step at once takes one step a block
    assert kfa.bwd_geometry(B, S, HQ, HKV, dh, True, window, dtype,
                            10 ** 6).chunk == 1

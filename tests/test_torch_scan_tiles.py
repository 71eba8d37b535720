"""The numeric contract of the scan kernels, on the CPU.

``csrc/rwkv_scan.cu`` splits a head's (hd, hd) state over lanes, as the
launch geometry (``kernels/rwkv6.py: rwkv_geometry``) lays it out: a lane
holds ``ti`` key rows of ``tj`` value columns, 16 lanes split the key
rows. Per token a lane forms ``Σ_{i in rows} r_i S_ij`` by fmaf over its
rows in order, adds ``v_j Σ_{i in rows} r_i (u_i k_i)`` by one fmaf, and
the 16 partials meet in an xor-shuffle tree (offsets 1, 2, 4, ...);
the state update is ``fmaf(w_i, S_ij, k_i v_j)``. ``csrc/mamba_scan.cu``
splits a channel's ds states over ``lanes`` lanes of ``ns`` states
(``kernels/mamba_ssm.py: mamba_geometry``): per token and state the gate
is ``2^(dt * (A log2 e))`` (``ex2.approx``, emulated as the exact power
of the rounded argument), ``h = fmaf(gate, h, (dt x) B)`` with ``dt x``
formed in the inputs' dtype, the lane sums ``h C`` over its states by
fmaf and the lanes meet in the same tree. ``rwkv_contract`` and ``mamba_contract``
emulate that in plain PyTorch (fmaf as a float64 product and sum rounded
once to float32), and the tests hold them against the port's plain
versions (``rwkv_scan_ref``, ``mamba_scan_ref``) and the JAX package's
Pallas kernels in interpret mode at the paths' widths (rwkv6-7b's 64
heads of 64; jamba's ds 16 over a few hundred of its 8192 channels), hd
100, 192 and 256, ds 5, 64 and 128, S 1, ragged tails, float32 and
bfloat16 inputs, within the tolerances of tests/test_torch_rwkv.py and
tests/test_torch_mamba.py. The final state does not depend on the split.

The geometries decide the launches alone; their invariants are checked
over every shape the sweeps reach: every state element and every output
has exactly one owner (the shuffle tree's scattering followed lane by
lane), every block has work, a lane's state stays within 64 floats, the
shared memory within the card's, and the instantiated tiles -- those of
the sources -- cover hd and ds.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mamba_ssm as tmamba  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6 as trwkv  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

F32, BF16 = "float32", "bfloat16"
CSRC = Path(trwkv.__file__).resolve().parent.parent / "csrc"
#: shared memory a block may take on the H100 (``MAX_SMEM`` in the sources)
MAX_SMEM = 227 * 1024
LOG2E = np.float32(1.4426950408889634)


def _fma(acc, a, b):
    """fmaf on float32 tensors: the exact product and sum, rounded once."""
    return (acc.double() + a.double() * b.double()).float()


def _xor_tree(vals):
    """The kernels' xor-shuffle sum over a list of 2^n lanes' values: at
    offset o every lane adds its partner's, so each level pairs the
    previous level's sums."""
    n = len(vals)
    o = 1
    while o < n:
        vals = [vals[j] + vals[j ^ o] for j in range(n)]
        o <<= 1
    return vals[0]


def scatter_owner(V: int, n: int, lane: int):
    """The sums a lane holds after ``rt::scatter_sum`` of V values over n
    lanes: (first, count) of the values first .. first + count - 1."""
    first, count, o = 0, V, 1
    while o < n and count > 1:
        count //= 2
        if lane & o:
            first += count
        o <<= 1
    return first, count


def _writes(V: int, n: int) -> np.ndarray:
    """How often each of V values is stored by the lanes of a group (those
    with lane < V store what they hold)."""
    hits = np.zeros(V, np.int64)
    for lane in range(min(n, V)):
        first, count = scatter_owner(V, n, lane)
        hits[first:first + count] += 1
    return hits


def rwkv_tokens_a_tree(ti: int, tj: int) -> int:
    """``tokens_a_tree`` of rwkv_scan.cu: 16 values a lane at most, and the
    loads of at most 4 tokens kept near 64 registers."""
    nt = 16 // tj
    while nt > 1 and nt * (3 * ti + tj) > 64:
        nt //= 2
    return min(nt, 4)


def mamba_tokens_a_tree(ns: int) -> int:
    """``tokens_a_tree`` of mamba_scan.cu: up to 4, the loads kept near 64
    registers."""
    nt = 4
    while nt > 1 and nt * (2 * ns + 2) > 64:
        nt //= 2
    return nt


def rwkv_contract(r, k, v, w, u, ti: int, ni: int):
    """The rwkv_scan kernel's arithmetic for a lane split of ti key rows
    over ni lanes: (y (B,S,nh,hd) f32, the final state (B,nh,hd,hd))."""
    B, S, nh, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    st = torch.zeros(B, nh, hd, hd)
    y = torch.zeros(B, S, nh, hd)
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        uk = uf[None] * kt                        # u_i k_i, rounded
        parts = []
        for ig in range(ni):
            ruk = torch.zeros(B, nh)
            acc = torch.zeros(B, nh, hd)
            for i in range(ig * ti, min(hd, ig * ti + ti)):
                ruk = _fma(ruk, rt[..., i], uk[..., i])
                acc = _fma(acc, rt[..., i, None], st[:, :, i, :])
            parts.append(_fma(acc, vt, ruk[..., None]))
        y[:, t] = _xor_tree(parts)
        kv = kt[..., :, None] * vt[..., None, :]  # k_i v_j, rounded
        st = _fma(kv, wt[..., :, None], st)       # fmaf(w_i, S_ij, k_i v_j)
    return y, st


def mamba_contract(x, dt, A, Bv, Cv, ns: int, lanes: int):
    """The mamba_scan kernel's arithmetic for ns states a lane over
    ``lanes`` lanes: (y (B,S,di) f32, the final state (B,di,ds))."""
    B, S, di = x.shape
    ds = A.shape[1]
    dtf = dt.float()
    dx = (dtf * x.float()).to(x.dtype).float()    # dt x in the inputs' dtype
    a2 = A.float() * LOG2E
    Bf, Cf = Bv.float(), Cv.float()
    h = torch.zeros(B, di, ds)
    y = torch.zeros(B, S, di)
    for t in range(S):
        arg = dtf[:, t, :, None] * a2[None]       # rounded to float32
        gate = torch.exp2(arg.double()).float()
        h = _fma(dx[:, t, :, None] * Bf[:, t, None, :], gate, h)
        parts = []
        for q in range(lanes):
            acc = torch.zeros(B, di)
            for n in range(q * ns, min(ds, q * ns + ns)):
                acc = _fma(acc, h[..., n], Cf[:, t, None, n])
            parts.append(acc)
        y[:, t] = _xor_tree(parts)
    return y, h


def _pair(a: np.ndarray, dt: str):
    import jax.numpy as jnp
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _rwkv_inputs(B, S, nh, hd, seed):
    """r, k, v unit normals, w = exp(-exp(n - 2)), u at 0.5, as
    tests/test_torch_rwkv.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    shape = (B, S, nh, hd)
    return (n(*shape), n(*shape), n(*shape),
            np.exp(-np.exp(n(*shape) - 2)).astype(np.float32),
            n(nh, hd) * np.float32(0.5))


def _mamba_inputs(B, S, di, ds, seed):
    """x at 0.5, dt = softplus(n - 1), A = -exp(0.3 n), B and C unit
    normals, as tests/test_torch_mamba.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(B, S, di) * np.float32(0.5),
            np.logaddexp(n(B, S, di) - 1, 0).astype(np.float32),
            -np.exp(n(di, ds) * np.float32(0.3)).astype(np.float32),
            n(B, S, ds), n(B, S, ds))


# ---------------------------------------------------------------------------
# rwkv_scan (Pallas rwkv6.py:75)
# ---------------------------------------------------------------------------

# rwkv6-7b's 64 heads of 64; S 1; hd 100 (8 key rows a lane, padded; a
# ragged column group), 33, 192 and 256 (16 key rows a lane)
RWKV_SHAPES = [(1, 3, 64, 64, F32), (1, 3, 64, 64, BF16), (2, 1, 3, 64, F32),
               (2, 7, 3, 100, F32), (2, 5, 3, 33, BF16), (1, 4, 2, 192, BF16),
               (1, 4, 2, 256, F32), (1, 3, 2, 256, BF16)]


@pytest.mark.parametrize("B,S,nh,hd,dt", RWKV_SHAPES)
def test_rwkv_contract_matches_reference_and_pallas(B, S, nh, hd, dt):
    from repro.kernels.rwkv6 import rwkv_scan
    arrs = _rwkv_inputs(B, S, nh, hd, seed=B * 100 + S + hd)
    pairs = [_pair(a, dt) for a in arrs]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    g = trwkv.rwkv_geometry(B, S, nh, hd, ts[0].element_size())
    y, st = rwkv_contract(*ts, g.ti, trwkv.LANES)
    wy, wst = tref.rwkv_scan_ref(*ts)
    pallas = np.asarray(rwkv_scan(*js, chunk=4, interpret=True), np.float32)
    np.testing.assert_allclose(y.numpy(), wy.numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), wst.numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), pallas, atol=5e-4, rtol=5e-3)


def test_rwkv_contract_state_does_not_depend_on_the_split():
    """Every lane split (4, 8 and 16 key rows a lane) stores the same state
    bit for bit; only the order of the read-out sum moves y."""
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(1, 6, 2, 64, seed=3)]
    runs = [rwkv_contract(*ts, ti, 64 // ti) for ti in (4, 8, 16)]
    for y, st in runs[1:]:
        assert torch.equal(st, runs[0][1])
        np.testing.assert_allclose(y.numpy(), runs[0][0].numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# mamba_scan (Pallas mamba_ssm.py:74)
# ---------------------------------------------------------------------------

# jamba's ds 16 over 256 and 266 of its channels (a ragged channel block
# at B 4); S 1; ds 5, 64, 128 and 256
MAMBA_SHAPES = [(1, 5, 256, 16), (4, 3, 266, 16), (2, 1, 96, 8),
                (2, 6, 70, 5), (1, 4, 40, 64), (1, 4, 24, 128),
                (1, 3, 8, 256)]


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("B,S,di,ds", MAMBA_SHAPES)
def test_mamba_contract_matches_reference_and_pallas(B, S, di, ds, dt):
    from repro.kernels.mamba_ssm import mamba_scan
    x, d, A, Bv, Cv = _mamba_inputs(B, S, di, ds, seed=B * 100 + S + ds)
    (xj, xt), (dj, dtt), (bj, bt), (cj, ct) = (_pair(a, dt)
                                               for a in (x, d, Bv, Cv))
    Aj, At = _pair(A, F32)
    g = tmamba.mamba_geometry(S, ds, xt.element_size())
    y, h = mamba_contract(xt, dtt, At, bt, ct, g.ns, g.lanes)
    wy, wh = tref.mamba_scan_ref(xt, dtt, At, bt, ct)
    tight = dict(atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), wy.numpy(), **tight)
    np.testing.assert_allclose(h.numpy(), wh.numpy(), **tight)
    # the Pallas kernel widens dt and x before their product
    pallas = np.asarray(mamba_scan(xj, dj, Aj, bj, cj, chunk=4, di_tile=di,
                                   interpret=True), np.float32)
    ptol = (dict(atol=5e-4, rtol=5e-3) if dt == F32
            else dict(atol=2e-2, rtol=2e-2))
    np.testing.assert_allclose(y.numpy(), pallas, **ptol)


def test_mamba_contract_state_does_not_depend_on_the_split():
    """4 lanes of 4 states, 2 of 8 and 1 of 16 store the same state bit for
    bit; only the order of the read-out sum moves y."""
    ts = [torch.from_numpy(a) for a in _mamba_inputs(2, 6, 32, 16, seed=4)]
    runs = [mamba_contract(*ts, ns, 16 // ns) for ns in (4, 8, 16)]
    for y, h in runs[1:]:
        assert torch.equal(h, runs[0][1])
        np.testing.assert_allclose(y.numpy(), runs[0][0].numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the launch geometries
# ---------------------------------------------------------------------------

def _source_tiles(name: str, *keys: str):
    text = (CSRC / name).read_text()
    get = lambda key: [int(v) for v in re.search(  # noqa: E731
        rf"{key}\[\] = \{{([^}}]*)\}}", text).group(1).split(",")]
    return tuple(zip(*map(get, keys)))


def test_the_sources_instantiate_the_geometries_tiles():
    """The tiles, lane counts and tokens a tree that the emulations and the
    geometry tests assume are the sources'."""
    assert _source_tiles("rwkv_scan.cu", "TILE_ROWS",
                         "TILE_COLS") == trwkv.TILES
    assert _source_tiles("mamba_scan.cu", "TILE_STATES",
                         "TILE_LANES") == tmamba.TILES
    for name, key, value in (("rwkv_scan.cu", "LANES", trwkv.LANES),
                             ("rwkv_scan.cu", "GROUPS", trwkv.GROUPS),
                             ("mamba_scan.cu", "THREADS", tmamba.THREADS)):
        text = (CSRC / name).read_text()
        assert f"constexpr int {key} = {value};" in text, (name, key)
    for name, body in (("rwkv_scan.cu", "int nt = 16 / tj;\n  while (nt > 1 "
                        "&& nt * (3 * ti + tj) > 64) nt /= 2;\n  return nt > 4 "
                        "? 4 : nt;"),
                       ("mamba_scan.cu", "int nt = 4;\n  while (nt > 1 && "
                        "nt * (2 * ns + 2) > 64) nt /= 2;\n  return nt;")):
        assert body in (CSRC / name).read_text(), name


HDS = (1, 2, 3, 4, 5, 8, 16, 31, 32, 33, 64, 65, 100, 128, 129, 192, 255,
       256, 257, 384, 512)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_rwkv_geometry_covers_every_state_element_and_output(itemsize):
    lanes, groups = trwkv.LANES, trwkv.GROUPS
    for B, nh in ((1, 1), (1, 3), (2, 3), (1, 64), (4, 64), (8, 40)):
        for hd in HDS:
            for S in (0, 1, 5, 32, 1024):
                g = trwkv.rwkv_geometry(B, S, nh, hd, itemsize)
                where = (B, S, nh, hd, itemsize, g)
                ti, tj = g.ti, g.tj
                assert ti * tj <= 64, where
                # the fewest key rows a lane that cover hd
                assert lanes * ti >= hd and (ti == 4 or lanes * ti < 2 * hd)
                jc = groups * tj
                # every block of a head has columns, and they cover hd
                assert (g.slices - 1) * jc < hd <= g.slices * jc, where
                assert 1 <= g.tc <= max(1, S) and g.tc <= trwkv.MAX_TC
                run = -(-g.tc * (3 * lanes * ti + jc) // 8) * 8
                assert 3 * run * itemsize <= MAX_SMEM, where
                # each state element (i, j) has one lane: i = ig ti + m,
                # j = slice jc + jg tj + c
                i = (np.arange(lanes)[:, None] * ti + np.arange(ti)).ravel()
                j = (np.arange(g.slices)[:, None, None] * jc
                     + np.arange(groups)[None, :, None] * tj
                     + np.arange(tj)[None, None, :]).ravel()
                assert (np.bincount(i[i < hd], minlength=hd) == 1).all()
                assert (np.bincount(j[j < hd], minlength=hd) == 1).all()
                # a wider tile was taken only with warps enough to spare
                warps = B * nh * g.slices * groups * lanes // 32
                if tj > 2:
                    assert warps >= trwkv.MIN_WARPS_PER_SM * trwkv.SMS, where
    # each output of a column group is stored once, in full batches of
    # tokens and in the tail (one token)
    for ti, tj in trwkv.TILES:
        nt = rwkv_tokens_a_tree(ti, tj)
        assert nt & (nt - 1) == 0 and nt * tj <= 16, (ti, tj)
        for V in (nt * tj, tj):
            assert (_writes(V, lanes) == 1).all(), (ti, tj, V)


DSS = (1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64, 65, 100, 128, 129, 256, 257,
       512)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_mamba_geometry_covers_every_state_and_output(itemsize):
    threads = tmamba.THREADS
    for di in (1, 5, 40, 70, 100, 266, 4098, 8192):
        for ds in DSS:
            for S in (0, 1, 5, 32, 1024):
                g = tmamba.mamba_geometry(S, ds, itemsize)
                where = (S, di, ds, itemsize, g)
                ns, lanes = g.ns, g.lanes
                # the first tile that holds ds
                assert lanes * ns >= ds, where
                assert all(n * l < ds for n, l in tmamba.TILES[:g.tile])
                # the source's grid: the blocks of ``channels`` over di
                ch = g.channels
                blocks = -(-di // ch)
                assert 1 <= g.tc <= max(1, S), where
                run = (2 * -(-g.tc * ch // 8) * 8
                       + 2 * -(-g.tc * lanes * ns // 8) * 8)
                assert 3 * run * itemsize <= MAX_SMEM, where
                # each (channel, state) has one lane
                d = (np.arange(blocks)[:, None] * ch
                     + np.arange(threads // lanes)[None, :]).ravel()
                n = (np.arange(lanes)[:, None] * ns + np.arange(ns)).ravel()
                assert (np.bincount(d[d < di], minlength=di) == 1).all()
                assert (np.bincount(n[n < ds], minlength=ds) == 1).all()
    # each token's y of a channel is stored once, in full batches of
    # tokens and in the tail (one token)
    for ns, lanes in tmamba.TILES:
        nt = mamba_tokens_a_tree(ns)
        assert nt & (nt - 1) == 0 and nt <= lanes, (ns, lanes)
        for V in (nt, 1):
            assert (_writes(V, lanes) == 1).all(), (ns, lanes, V)


def test_the_geometries_at_the_paths_shapes():
    """One rwkv6-7b admission: 4 x 4 tiles so that 512 warps share the
    SMs, each head in 2 blocks; at (4,1024,64,64) 8 columns a lane, a
    block a head. jamba: 4 lanes of 4 states a channel, 32 channels a
    block, 256 blocks a row."""
    g = trwkv.rwkv_geometry(1, 32, 64, 64)
    assert (g.ti, g.tj, g.slices, g.tc) == (4, 4, 2, 16)
    g = trwkv.rwkv_geometry(4, 1024, 64, 64)
    assert (g.ti, g.tj, g.slices) == (4, 8, 1)
    for S in (32, 1024):
        g = tmamba.mamba_geometry(S, 16)
        assert (g.ns, g.lanes, g.channels) == (4, 4, 32)
    with pytest.raises(ValueError, match="head dims 1..512"):
        trwkv.rwkv_geometry(1, 1, 1, 513)
    with pytest.raises(ValueError, match="state sizes 1..512"):
        tmamba.mamba_geometry(1, 513)

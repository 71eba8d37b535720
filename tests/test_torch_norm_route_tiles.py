"""The numeric contract of the rmsnorm and router kernels, on the CPU.

``csrc/moe_route.cu`` forms the logits of a token tile in pieces that the
launch geometry (``kernels/moe_route.py: route_geometry``) lays out: D is
cut into ``splits`` ranges of ``rows`` rows. At decode each block's 256
threads cover its range in residues — thread r of a column group sums rows
``d0 + r, d0 + r + rs, ...`` by fmaf, the residues of a warp are added in
an xor-shuffle tree and the 8 warps in order — and at prefill a thread sums
its range's rows in order. The block that arrives last adds the ranges'
partials in range order; S lanes take a token's softmax (a warp at
decode, 4 at prefill up to E 64), summing each lane's experts (lane l takes
l, l + S, ...) then the lanes in an xor tree; each of the k rounds takes
the largest ``bits(p / sum) + 1``, ties to the lowest expert. ``route_contract`` emulates that in plain PyTorch (fmaf as a
float64 product and sum rounded once to float32), and the tests hold it
against the port's plain version (``moe_route_ref``) and the JAX package's
Pallas ``moe_route`` in interpret mode at moonshot's, jamba's and kimi's
router widths, E 100 and k = E: gates within 1e-5, indices equal. An exact
tie case at E 384 checks that the lower expert wins each pair.

``kernels/rmsnorm.py: launch_geometry`` and ``route_geometry`` decide the
kernels' launches alone; their invariants are checked over every D and N
the sweeps reach: every element and every row has a thread, every block has
work, and the limits of the sources hold.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_route as troute  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

F32, BF16 = "float32", "bfloat16"
#: a decode block's warps (``DEC_WARPS`` in the source)
DEC_WARPS = 8


def _fma(acc, a, b):
    """fmaf on float32 tensors: the exact product and sum, rounded once."""
    return (acc.double() + a.double() * b.double()).float()


def _xor_tree(vals):
    """The kernel's xor-shuffle sum over a list of 2^n lanes' values: at
    offset o every lane adds its partner's, so each level pairs the
    previous level's sums."""
    n = len(vals)
    o = 1
    while o < n:
        vals = [vals[j] + vals[j ^ o] for j in range(n)]
        o <<= 1
    return vals[0]


def _split_partial(xf, wf, d0, d1, g):
    """One block's sums over rows d0..d1-1 of D, in the kernel's order."""
    N, E = xf.shape[0], wf.shape[1]
    if g.mode != "decode":                 # prefill: the rows in order
        acc = torch.zeros(N, E)
        for d in range(d0, d1):
            acc = _fma(acc, xf[:, d:d + 1], wf[d][None])
        return acc
    rs = troute.DEC_THREADS // g.cg        # residues of a column group
    per_warp = 32 // g.cg
    res = []
    for r in range(rs):
        acc = torch.zeros(N, E)
        for d in range(d0 + r, d1, rs):
            acc = _fma(acc, xf[:, d:d + 1], wf[d][None])
        res.append(acc)
    warps = [_xor_tree(res[w * per_warp:(w + 1) * per_warp])
             for w in range(DEC_WARPS)]
    s = torch.zeros(N, E)
    for v in warps:
        s = s + v
    return s


def route_contract(x, w, k):
    """The router kernel's arithmetic: (gates (N,k) f32, idx (N,k) int32)."""
    N, D = x.shape
    E = w.shape[1]
    g = troute.route_geometry(N, D, E, x.element_size(), True)
    xf, wf = x.float(), w.float()
    logits = torch.zeros(N, E)
    for sp in range(g.splits):             # the last block: in slice order
        logits = logits + _split_partial(xf, wf, sp * g.rows,
                                         min(D, (sp + 1) * g.rows), g)
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - m)
    S = 4 if g.mode != "decode" and E <= 64 else 32     # lanes a token
    lane_sums = []
    for lane in range(S):
        acc = torch.zeros(N)
        for e in range(lane, E, S):
            acc = acc + p[:, e]
        lane_sums.append(acc)
    total = _xor_tree(lane_sums)[:, None]
    probs = p / total
    key = torch.from_numpy(probs.numpy().view(np.int32).astype(np.int64) + 1)
    cand = (key << 32) | (0xFFFFFFFF - torch.arange(E, dtype=torch.int64))
    gates, idx = [], []
    for _ in range(k):                     # the largest key, lowest expert
        best = cand.max(dim=-1).values
        win = (0xFFFFFFFF - (best & 0xFFFFFFFF))
        bits = ((best >> 32) - 1).to(torch.int32).numpy()
        gates.append(torch.from_numpy(bits.view(np.float32).copy()))
        idx.append(win.to(torch.int32))
        cand = cand.scatter(-1, win[:, None], 0)
    return torch.stack(gates, -1), torch.stack(idx, -1)


def _pair(a: np.ndarray, dt: str):
    import jax.numpy as jnp
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dt == BF16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# moonshot decode and admission, jamba, kimi, E 100 (decode and prefill),
# k = E, and prefill tiles with D split
ROUTE_SHAPES = [(4, 2048, 64, 6), (32, 2048, 64, 6), (4, 4096, 16, 2),
                (4, 7168, 384, 8), (7, 300, 100, 6), (70, 99, 100, 6),
                (3, 96, 24, 24), (130, 200, 16, 4)]


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("N,D,E,K", ROUTE_SHAPES)
def test_route_contract_matches_reference_and_pallas(N, D, E, K, dt):
    from repro.kernels.moe_route import moe_route
    rng = np.random.default_rng(N * 31 + E)
    xj, xt = _pair(rng.standard_normal((N, D)).astype(np.float32), dt)
    wj, wt = _pair((rng.standard_normal((D, E)) * 0.02).astype(np.float32),
                   dt)
    gj, ij = moe_route(xj, wj, K, block_n=64, interpret=True)
    gr, ir = tref.moe_route_ref(xt, wt, K)
    gc, ic = route_contract(xt, wt, K)
    for name, (g, i) in (("contract", (gc, ic)), ("reference", (gr, ir))):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij),
                                      err_msg=name)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_route_exact_ties_at_kimi_width_go_to_the_lower_expert(dt):
    """Small integers in x and kimi's 384 experts in equal column pairs:
    every logit is exact in any order, every probability comes twice, and
    each pair goes lower expert first."""
    from repro.kernels.moe_route import moe_route
    rng = np.random.default_rng(5)
    N, D, E, K = 6, 512, 384, 8
    x = rng.integers(-2, 3, (N, D)).astype(np.float32)
    w = np.repeat(rng.integers(-2, 3, (D, E // 2)).astype(np.float32)
                  * 2.0 ** -5, 2, axis=1)
    xj, xt = _pair(x, dt)
    wj, wt = _pair(w, dt)
    gj, ij = moe_route(xj, wj, K, interpret=True)
    for g, i in (route_contract(xt, wt, K), tref.moe_route_ref(xt, wt, K)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-6,
                                   rtol=0)
        idx = i.numpy()
        assert (idx[:, 0::2] % 2 == 0).all()
        np.testing.assert_array_equal(idx[:, 1::2], idx[:, 0::2] + 1)


NS = (1, 2, 3, 4, 5, 8, 9, 32, 33, 64, 65, 100, 4096, 70000)
DS = (1, 7, 16, 99, 100, 128, 2048, 4096, 7168, 8192, 12288, 100000)
ES = (1, 2, 4, 8, 16, 24, 64, 100, 256, 384, 512, 1024, 2048)


@pytest.mark.parametrize("itemsize,wide", [(4, True), (4, False),
                                           (2, True), (2, False)])
def test_route_geometry_covers_every_token_expert_and_row(itemsize, wide):
    vec = 16 // itemsize
    for N in NS:
        for D in DS:
            for E in ES:
                g = troute.route_geometry(N, D, E, itemsize, wide)
                where = (N, D, E, itemsize, wide, g)
                # every token, expert and row of D has a block, and every
                # block has tokens, experts and rows
                assert (g.tiles - 1) * g.tn < N <= g.tiles * g.tn, where
                assert (g.slices - 1) * g.cw < E <= g.slices * g.cw, where
                assert (g.splits - 1) * g.rows < D <= g.splits * g.rows, where
                assert g.tiles <= 65535 and g.splits <= 65535, where
                if N <= troute.DECODE_MAX_N:
                    assert g.mode == "decode" and g.tn in (1, 2, 4, 8), where
                    assert g.tn >= min(N, 8), where
                    assert g.cg & (g.cg - 1) == 0 and g.cw == g.cg * vec
                    assert g.cw <= troute.SLICE and g.cw >= min(E, 64), where
                    assert g.rows <= troute.DEC_MAX_ROWS, where
                else:
                    assert g.mode == ("tc" if itemsize == 2 and wide
                                      else "tile"), where
                    assert g.tn == troute.TILE_N, where
                    assert g.cw == troute.SLICE, where
                    assert g.rows % troute.CHUNK[g.mode] == 0, where


def test_route_geometry_at_the_paths_shapes():
    """The moonshot decode streams its 256 KB bf16 router through 16
    blocks; kimi's 384 experts take 6 slices; N 4096 splits D in three,
    and the tensor cores take bf16."""
    g = troute.route_geometry(4, 2048, 64, 2, True)
    assert (g.mode, g.tn, g.slices, g.splits) == ("decode", 4, 1, 16)
    g = troute.route_geometry(4, 7168, 384, 2, True)
    assert (g.mode, g.slices) == ("decode", 6) and g.splits > 1
    assert troute.route_geometry(4096, 2048, 64, 2, True).mode == "tc"
    assert troute.route_geometry(4096, 2048, 64, 4, True).mode == "tile"
    assert troute.route_geometry(4096, 2048, 64, 2, True).splits == 3


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("vector", [True, False])
def test_rmsnorm_geometry_covers_every_row_and_element(itemsize, vector):
    vec = 16 // itemsize if vector else 1
    most = 64 if vector else 32
    for n_rows in (1, 3, 4, 32, 131, 132, 133, 4096, 16384):
        for D in range(1, 300, 7) if not vector else \
                (vec, 2 * vec, 96 * vec // 4, 1024, 2048, 4096, 7168, 8192,
                 12288, 16384, 32768, 65536, 70000 // vec * vec):
            g = trms.launch_geometry(n_rows, D, itemsize, vector)
            where = (n_rows, D, itemsize, vector, g)
            assert g.vec == vec and 1 <= g.warps <= trms.MAX_WARPS, where
            assert 32 * g.warps * g.rows <= 32 * trms.MAX_WARPS, where
            assert 1 <= g.grid <= -(-n_rows // g.rows), where
            if g.nv == 0:                  # streamed: too wide to hold
                assert -(-D // vec) > 32 * trms.MAX_WARPS * most // vec
                assert g.rows == 1, where
                continue
            assert g.nv & (g.nv - 1) == 0 and g.nv * vec <= most, where
            # the row's threads hold every element, and no warp is idle
            assert g.nv * vec * 32 * g.warps >= D, where
            assert g.nv * vec * 32 * (g.warps - 1) < D, where
            held = ((trms.ELEMS_FEW_ROWS if n_rows < trms.SMS
                     else trms.ELEMS_PREFERRED) // (1 if vector else 2))
            if D <= 32 * held:             # a warp owns a row that fits
                assert g.warps == 1, where
            if g.warps > 1:
                assert g.rows == 1 or g.rows * g.warps <= trms.BLOCK_WARPS


def test_rmsnorm_geometry_at_the_paths_shapes():
    """Decode rows each take their own block, over 8 warps at D 2048 (8
    elements a lane); wide rows many warps; a large N fills the SMs with
    several rows a block, 32 elements a lane."""
    g = trms.launch_geometry(4, 2048, 2, True)
    assert (g.warps, g.rows, g.grid, g.nv) == (8, 1, 4, 1)
    assert trms.launch_geometry(4, 12288, 4, True).warps == 12
    assert trms.launch_geometry(4096, 12288, 4, True).warps == 12
    g = trms.launch_geometry(4096, 2048, 2, True)
    assert g.rows * g.warps == trms.BLOCK_WARPS and g.grid == 4096 // g.rows
    assert trms.launch_geometry(2, 70001, 4, False).nv == 0

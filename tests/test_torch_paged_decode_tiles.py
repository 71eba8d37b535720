"""The numeric contract of the paged decode kernel, on the CPU.

``csrc/decode_attention.cu`` runs paged decode on slot decode's split core:
the slot's T = nb*bs logical keys are cut into ``nsplit`` ranges
``[s*T//n, (s+1)*T//n)``, key t of slot b lives at pool row
``tables[b, t // bs]``, offset ``t % bs``, a masked key is zero-filled and
never read (neither the trash row nor a chain's stale tail), and each split
walks only its key tiles that hold a valid key (32 keys a tile for fp32 at
dh <= 64, 16 at dh <= 128, 8 beyond; 64 for bf16) with an online softmax,
then a combine pass merges the splits (``O = sum_s e^(m_s - m*) O_s /
max(sum_s e^(m_s - m*) l_s, 1e-30)``, zeros for a row with no valid key).
fp32 queries: a quantized pool's codes become ``code * scale`` in fp32.
bf16 queries: bf16 operands, fp32 sums, p rounded to bf16 before P V (the
row sum over the unrounded p); a quantized pool's codes go in as bf16
(exact), the K scale multiplies the key's score and the V scale its
probability before the rounding. The card alone can run the kernel, so
``paged_contract`` emulates that arithmetic in plain PyTorch, and the tests
hold it against the port's plain version (``paged_decode_attention_ref``)
and the JAX package's Pallas kernel in interpret mode, over fp32, bf16,
int8 and fp8 pools.

Tolerances: fp32 |emulation - reference| <= 1e-5 (1 + |reference|) (sums
in another order); bf16 2e-2 (1 + |reference|) (P and the output rounded
once, the references round at other places). The fp32 decode of the codes
equals the plain version's ``gather_pool`` bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import kv_quant as tkq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import slot_decode as tsd  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

NEG_INF = -1e30
F32_TOL, BF16_TOL = 1e-5, 2e-2


def tile_keys(dtype, dh):
    """Keys a tile of the kernel: the fp32 FFMA core's by head dim, the
    bf16 tensor-core core's 64."""
    if dtype == torch.bfloat16:
        return 64
    return 32 if dh <= 64 else 16 if dh <= 128 else 8


def resolve(pool, tables, valid, scales=None):
    """The stager: each valid key's row of ``pool`` through the block table
    as (B, T, HKV, dh) raw values, masked keys zero and never read; with
    ``scales`` also each key's block scale, (B, T, HKV), masked keys 0."""
    B, nb = tables.shape
    bs = pool.shape[1]
    t = torch.arange(nb * bs)
    rows = tables.long()[:, t // bs]                          # (B, T)
    offs = (t % bs).expand(B, -1)
    src = tkq.raw(pool)
    vals = torch.zeros((B, nb * bs) + tuple(pool.shape[2:]), dtype=src.dtype)
    vals[valid] = src[rows[valid], offs[valid]]
    vals = vals.view(pool.dtype)
    if scales is None:
        return vals, None
    sc = torch.zeros(B, nb * bs, pool.shape[2])
    sc[valid] = scales[rows[valid]]
    return vals, sc


def paged_contract(q, kp, vp, tables, valid, nsplit, ks=None, vs=None):
    """The split kernel's arithmetic over a block pool: q (B,HQ,dh) fp32 or
    bf16; kp/vp (P+1,bs,HKV,dh) in q's dtype, or int8 / e4m3 codes with
    ks/vs (P+1,HKV) scales; tables (B,nb) int32; valid (B,nb*bs) bool ->
    (B,HQ,dh) in q's dtype."""
    B, HQ, dh = q.shape
    HKV = kp.shape[2]
    G, T = HQ // HKV, valid.shape[1]
    bf16 = q.dtype == torch.bfloat16
    quant = ks is not None
    kc, kscale = resolve(kp, tables, valid, ks)
    vc, vscale = resolve(vp, tables, valid, vs)
    kf, vf = kc.float(), vc.float()              # codes and bf16 exactly
    if quant and not bf16:                       # code * scale in fp32
        kf, vf = kf * kscale[..., None], vf * vscale[..., None]
    if not (quant and bf16):                     # no scale on score and p
        kscale = vscale = torch.ones(B, T, HKV)
    qg = q.float().reshape(B, HKV, G, dh)
    scale = 1.0 / math.sqrt(dh)
    BK = tile_keys(q.dtype, dh)
    ms, ls, os_ = [], [], []
    for s in range(nsplit):
        ks0, ke = s * T // nsplit, (s + 1) * T // nsplit
        m = torch.full((B, HKV, G, 1), NEG_INF)
        l = torch.zeros(B, HKV, G, 1)
        o = torch.zeros(B, HKV, G, dh)
        for k0 in range(ks0, ke, BK):
            sl = slice(k0, min(k0 + BK, ke))
            live = valid[:, None, None, sl]                  # (B,1,1,k)
            if not live.any():
                continue                        # not a live tile of any row
            sc = torch.einsum("bhgd,bkhd->bhgk", qg, kf[:, sl]) * (
                scale * kscale[:, sl].transpose(1, 2)[:, :, None])
            sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(sc - m_new), torch.zeros_like(sc))
            l = l * corr + p.sum(-1, keepdim=True)
            pv = p * vscale[:, sl].transpose(1, 2)[:, :, None]
            if bf16:
                pv = pv.to(torch.bfloat16).float()
            o = o * corr + torch.einsum("bhgk,bkhd->bhgd", pv, vf[:, sl])
            m = m_new
        # a split with no valid key adds nothing
        has = valid[:, ks0:ke].any(-1)[:, None, None, None]
        ms.append(torch.where(has, m, torch.full_like(m, NEG_INF)))
        ls.append(l)
        os_.append(o)
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(0))
    den = (w * torch.stack(ls)).sum(0)
    out = (w * torch.stack(os_)).sum(0) / torch.clamp(den, min=1e-30)
    return out.reshape(B, HQ, dh).to(q.dtype)


def _torch_codes(a: np.ndarray) -> torch.Tensor:
    """A numpy code array (int8, or ml_dtypes float8_e4m3fn from JAX) as a
    torch tensor of the same bits."""
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def _inputs(seed, B, nb, bs, HQ, HKV, dh, lives, pool, qdt, spare=2):
    """q, pools, a permuted block table (each row's first blocks a random
    choice of the pool's rows, the rest the trash row P) and the valid
    prefixes, from a numpy seed, as JAX arrays and torch tensors. A
    quantized pool is quantized per (block, KV head) by the JAX package."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jkq
    rng = np.random.default_rng(seed)
    P = B * nb + spare
    q = rng.standard_normal((B, HQ, dh)).astype(np.float32)
    kvf = [rng.standard_normal((P + 1, bs, HKV, dh)).astype(np.float32)
           for _ in range(2)]
    perm = rng.permutation(P)
    tables = np.full((B, nb), P, np.int32)
    for b, n in enumerate(lives):
        used = -(-n // bs)
        tables[b, :used] = perm[b * nb:b * nb + used]
    valid = np.arange(nb * bs)[None] < np.array(lives)[:, None]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if qdt == "bf16" else \
        (jnp.float32, torch.float32)
    jin = [jnp.asarray(q).astype(jdt)]
    tin = [torch.from_numpy(q).to(tdt)]
    scales_j, scales_t = [], []
    for a in kvf:
        if pool in ("f32", "bf16"):
            jin.append(jnp.asarray(a).astype(jdt))
            tin.append(torch.from_numpy(a).to(tdt))
            continue
        dt = jkq.storage_dtype(pool, jnp.float32)
        p = jnp.asarray(a)
        s = jkq.block_scales(jnp.max(jnp.abs(p), axis=(1, 3)), dt)
        c = np.asarray(jkq.quantize(p, s[:, None, :, None], dt))
        jin.append(jnp.asarray(c))
        tin.append(_torch_codes(c))
        scales_j.append(jnp.asarray(s))
        scales_t.append(torch.from_numpy(np.asarray(s).copy()))
    jin += [jnp.asarray(tables), jnp.asarray(valid)] + scales_j
    tin += [torch.from_numpy(tables), torch.from_numpy(valid)] + scales_t
    return jin, tin


def _within(got, want, tol, what):
    got = got.float()
    want = torch.as_tensor(np.array(want, np.float32))
    err = (got - want).abs()
    lim = tol * (1 + want.abs())
    assert torch.isfinite(got).all() and (err <= lim).all(), (
        f"{what}: max |err| {err.max().item():.3e} beyond {tol} (1 + |o|)")


SHAPES = {
    # B, nb, bs, HQ, HKV, dh, nsplit ("T": one split a key), live keys per
    # row (0: a row with no valid key)
    "nsplit=1 bs=8 HKV=3 dh=33": (3, 4, 8, 6, 3, 33, 1, (0, 13, 32)),
    "nsplit=2 all-masked split bs=16 MQA": (2, 4, 16, 4, 1, 64, 2, (20, 64)),
    "nsplit=T bs=24 HKV=3": (2, 2, 24, 6, 3, 64, "T", (30, 48)),
    "nsplit=3 bs=24 MQA dh=33 tiles across blocks": (2, 5, 24, 8, 1, 33, 3,
                                                     (100, 0)),
}
POOLS = [("f32", "f32"), ("bf16", "bf16"), ("int8", "f32"), ("int8", "bf16"),
         ("fp8", "f32"), ("fp8", "bf16")]
POOL_IDS = [f"{p}-q{q}" for p, q in POOLS]


@pytest.mark.parametrize("pool,qdt", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_paged_split_contract_matches_reference_and_pallas(shape, pool, qdt):
    from repro.kernels.paged_decode import paged_decode_attention as jpd
    B, nb, bs, HQ, HKV, dh, nsplit, lives = SHAPES[shape]
    nsplit = nb * bs if nsplit == "T" else nsplit
    jin, tin = _inputs(nb * bs + dh + B, B, nb, bs, HQ, HKV, dh, lives, pool,
                       qdt)
    q, kp, vp, tables, valid, *scales = tin
    ks, vs = scales if scales else (None, None)
    got = paged_contract(q, kp, vp, tables, valid, nsplit, ks, vs)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = BF16_TOL if qdt == "bf16" else F32_TOL
    _within(got, tref.paged_decode_attention_ref(
        q, kp, vp, tables, valid, ks=ks, vs=vs).float(), tol, "plain version")
    pallas = jpd(*jin, interpret=True)
    _within(got, np.asarray(pallas.astype(np.float32)), tol,
            "Pallas kernel (interpret)")
    empty = ~valid.any(-1)                    # a row with no valid key
    assert not got[empty].float().abs().sum()


@pytest.mark.parametrize("pool", ["int8", "fp8"])
def test_fp32_code_decode_is_gather_pools_bit_for_bit(pool):
    """The fp32 queries' decode, code * scale per valid key, is the plain
    version's gathered and decoded view exactly."""
    _, tin = _inputs(5, 3, 4, 8, 6, 3, 33, (0, 13, 32), pool, "f32")
    _, kp, _, tables, valid, ks, _ = tin
    codes, sc = resolve(kp, tables, valid, ks)
    mine = codes.float() * sc[..., None]
    want = tref.gather_pool(kp, tables, ks)
    assert torch.equal(mine[valid], want[valid])
    assert not mine[~valid].any()


def _poison(pool, scales, tables, lives, fill):
    """The pools with every position that holds no live key (the trash row,
    spare blocks, each chain's stale tail) set to ``fill`` (NaN, or for
    codes the byte 0x7f: NaN in e4m3), and the scales of blocks with no
    live key set to NaN; with fill 0, the same positions zeroed."""
    bs = pool.shape[1]
    dead = torch.ones(pool.shape[:2], dtype=torch.bool)
    for b, n in enumerate(lives):
        for i in range(-(-n // bs)):
            dead[tables[b, i], :min(bs, n - i * bs)] = False
    out = pool.clone()
    tkq.raw(out)[dead] = fill
    if scales is None:
        return out, None
    idle = dead.all(1)
    sc = scales.clone()
    sc[idle] = float("nan") if fill != 0 else 0.0
    return out, sc


@pytest.mark.parametrize("pool,qdt", POOLS, ids=POOL_IDS)
def test_trash_row_and_stale_tails_are_never_read(pool, qdt):
    """NaN in the trash row, the spare blocks and the chains' stale tails
    (and NaN scales on blocks with no live key): the emulation stays
    finite and equals the case with those positions zeroed."""
    B, nb, bs, HQ, HKV, dh, lives = 3, 4, 16, 8, 2, 64, (0, 21, 50)
    _, tin = _inputs(23, B, nb, bs, HQ, HKV, dh, lives, pool, qdt)
    q, kp, vp, tables, valid, *scales = tin
    ks, vs = scales if scales else (None, None)
    code = pool in ("int8", "fp8")
    bad = [_poison(p, s, tables, lives, 0x7F if code else float("nan"))
           for p, s in ((kp, ks), (vp, vs))]
    zero = [_poison(p, s, tables, lives, 0) for p, s in ((kp, ks), (vp, vs))]
    got = paged_contract(q, bad[0][0], bad[1][0], tables, valid, 2,
                         bad[0][1], bad[1][1])
    want = paged_contract(q, zero[0][0], zero[1][0], tables, valid, 2,
                          zero[0][1], zero[1][1])
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)
    tol = BF16_TOL if qdt == "bf16" else F32_TOL
    _within(got, tref.paged_decode_attention_ref(
        q, zero[0][0], zero[1][0], tables, valid, ks=zero[0][1],
        vs=zero[1][1]).float(), tol, "plain version on the zeroed pools")


def test_paged_split_count_is_slot_decodes_over_nb_times_bs():
    """The wrapper cuts a paged slot's nb*bs logical keys as slot decode
    cuts T: at the path shape one split, at 32 slots x 2048 keys two."""
    assert tsd.num_splits(4, 4, 5 * 16) == 1
    assert tsd.num_splits(32, 4, 128 * 16) == 2
    assert tsd.num_splits(32, 8, 128 * 16) == 1
    assert tsd.num_splits(1, 1, 128 * 8) == 4

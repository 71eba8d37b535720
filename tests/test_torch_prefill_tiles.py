"""The numeric contract of the paged prefill kernel's bf16 tensor-core tile,
on the CPU.

For bf16 queries ``csrc/paged_prefill.cu`` runs S = Q K^T and O += P V on
the tensor cores (``csrc/register_tiles.cuh``, ``TcTile``): bf16 operands,
fp32 sums. Over a quantized pool it never decodes a tile: the int8 / e4m3
codes go to the tensor cores as bf16 (exact for both formats), the K scale
multiplies score column j, the V scale multiplies probability column j
before P is rounded to bf16, and the row sum takes the unscaled
probabilities. Keys come in tiles of 64 with an online softmax. The card
alone can run the kernel, so ``tile_contract`` below emulates that
arithmetic in plain PyTorch, and the tests hold it against the port's
plain version (``paged_prefill_attention_ref``) and the JAX package's
Pallas kernel in interpret mode, over bf16, int8 and fp8 pools at the
sweep's shapes (HKV 3, dh 33, bs 8, W 7; dh 129, W 1; W to a block
boundary) and a chain of two key tiles.

Tolerance: |emulation - reference| <= 2e-2 (1 + |reference|), bfloat16's:
P is rounded to bf16 once (after the V scale), the output once, and the
reference rounds its probabilities (and, on bf16 pools, its scores) to
bf16 at other places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

TILE_KEYS = 64
NEG_INF = -1e30
TOL = 2e-2


def tile_contract(q, kp, vp, tables, start, ks=None, vs=None):
    """The bf16 tile's arithmetic: q (B,W,HQ,dh) bf16; kp/vp (P+1,bs,HKV,dh)
    bf16 values or int8 / e4m3 codes with ks/vs (P+1,HKV) scales ->
    (B,W,HQ,dh) bf16."""
    B, W, HQ, dh = q.shape
    bs, HKV = kp.shape[1], kp.shape[2]
    G, T = HQ // HKV, tables.shape[1] * bs
    idx = tables.long()

    def chain(pool, scales):
        # the codes (or bf16 values) as bf16 operands, (B, HKV, T, dh); the
        # block scales per key, (B, HKV, T)
        vals = tref.raw(pool)[idx].view(pool.dtype).float().to(torch.bfloat16)
        vals = vals.reshape(B, T, HKV, dh).transpose(1, 2).float()
        if scales is None:
            return vals, torch.ones(B, HKV, T)
        sc = scales[idx].repeat_interleave(bs, dim=1)          # (B, T, HKV)
        return vals, sc.transpose(1, 2)

    kc, ksk = chain(kp, ks)
    vc, vsk = chain(vp, vs)
    qg = q.float().reshape(B, W, HKV, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, HKV, W * G, dh)
    pos = (start[:, None].long() + torch.arange(W)[None]).repeat_interleave(
        G, dim=1)                                              # (B, W*G)
    live = torch.arange(T)[None, None] <= pos[:, :, None]     # (B, W*G, T)
    scale = 1.0 / np.sqrt(dh)
    m = torch.full((B, HKV, W * G, 1), NEG_INF)
    l = torch.zeros(B, HKV, W * G, 1)
    o = torch.zeros(B, HKV, W * G, dh)
    for k0 in range(0, T, TILE_KEYS):
        sl = slice(k0, k0 + TILE_KEYS)
        s = (qg @ kc[:, :, sl].transpose(-1, -2)) * (scale * ksk[:, :, None, sl])
        lv = live[:, None, :, sl]
        s = torch.where(lv, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(lv, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * corr + p.sum(-1, keepdim=True)
        pv = (p * vsk[:, :, None, sl]).to(torch.bfloat16).float()
        o = o * corr + pv @ vc[:, :, sl]
        m = m_new
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, HKV, W, G, dh).permute(0, 2, 1, 3, 4).reshape(
        B, W, HQ, dh).to(torch.bfloat16)


def _within(got, want, what):
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    err = (got - want).abs()
    lim = TOL * (1 + want.abs())
    assert torch.isfinite(got).all() and (err <= lim).all(), (
        f"{what}: max |err| {err.max().item():.3e} beyond {TOL} (1 + |o|)")


def _torch_codes(a: np.ndarray) -> torch.Tensor:
    """A numpy code array (int8, or ml_dtypes float8_e4m3fn from JAX) as a
    torch tensor of the same bits."""
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def _inputs(seed, B, W, nb, bs, HQ, HKV, dh, starts, pool):
    """q and pools from a numpy seed, the pools permuted through the table
    (the trash row P never named), as JAX arrays and torch tensors; a
    quantized pool is quantized per (block, KV head) by the JAX package."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jkq
    rng = np.random.default_rng(seed)
    P1 = B * nb + 1
    q = rng.standard_normal((B, W, HQ, dh)).astype(np.float32)
    kvf = [rng.standard_normal((P1, bs, HKV, dh)).astype(np.float32)
           for _ in range(2)]
    tables = np.stack([rng.permutation(P1 - 1)[:nb] for _ in range(B)]
                      ).astype(np.int32)
    start = np.array(starts, np.int32)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    common_j = (jnp.asarray(tables), jnp.asarray(start))
    common_t = (torch.from_numpy(tables), torch.from_numpy(start))
    if pool == "bf16":
        pj = [jnp.asarray(a).astype(jnp.bfloat16) for a in kvf]
        pt = [torch.from_numpy(a).to(torch.bfloat16) for a in kvf]
        return (qj, *pj, *common_j, None, None), (qt, *pt, *common_t, None,
                                                 None)
    dt = jkq.storage_dtype(pool, jnp.float32)
    codes, scales = [], []
    for a in kvf:
        p = jnp.asarray(a)
        s = jkq.block_scales(jnp.max(jnp.abs(p), axis=(1, 3)), dt)
        codes.append(np.asarray(jkq.quantize(p, s[:, None, :, None], dt)))
        scales.append(np.asarray(s))
    jin = (qj, *(jnp.asarray(c) for c in codes), *common_j,
           *(jnp.asarray(s) for s in scales))
    tin = (qt, *(_torch_codes(c) for c in codes), *common_t,
           *(torch.from_numpy(s.copy()) for s in scales))
    return jin, tin


SHAPES = {
    # B, W, nb, bs, HQ, HKV, dh, starts
    "HKV=3 dh=33 bs=8 W=7": (3, 7, 4, 8, 6, 3, 33, (0, 5, 25)),
    "dh=129 bs=16 W=1": (2, 1, 3, 16, 4, 1, 129, (0, 40)),
    "W to a block boundary bs=8 W=8": (2, 8, 4, 8, 6, 3, 64, (8, 16)),
    "two key tiles bs=16 W=24": (2, 24, 8, 16, 8, 2, 64, (0, 100)),
}


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_tile_contract_matches_reference_and_pallas(shape, pool):
    from repro.kernels.paged_prefill import paged_prefill_attention as jpp
    B, W, nb, bs, HQ, HKV, dh, starts = SHAPES[shape]
    jin, tin = _inputs(sum(starts) + dh + W, B, W, nb, bs, HQ, HKV, dh,
                       starts, pool)
    q, kp, vp, tables, start, ks, vs = tin
    got = tile_contract(q, kp, vp, tables, start, ks, vs)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _within(got, tref.paged_prefill_attention_ref(
        q, kp, vp, tables, start, ks=ks, vs=vs).float(), "plain version")
    if ks is None:
        pallas = jpp(*jin[:5], interpret=True)
    else:
        pallas = jpp(*jin[:5], jin[5], jin[6], interpret=True)
    _within(got, pallas, "Pallas kernel (interpret)")

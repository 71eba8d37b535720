"""Partition rules of the port (``src/repro/sharding/rules.py``): FSDP over
("pod", "data"), tensor parallelism over "model", the serving layouts.

The decisions and the spec trees are JAX's, line for line, so
``tp_report`` and every spec agree with the reference. A spec is a plain
tuple in place of a ``PartitionSpec``: one entry a dimension, each ``None``
(replicated), an axis name, or a tuple of axis names; a one-name tuple is
written as the name, as ``PartitionSpec`` normalises it. A spec may be
shorter than its leaf: the trailing dimensions are replicated.

The port keeps one parameter (and cache) dict per layer where JAX stacks
the layers of a block-pattern position, so a spec here has no leading
stacked dimension: JAX's spec of ``blocks[g]`` less its leading ``None``
is the spec of every port layer at pattern position ``g``. The swap block
and chain specs describe the host tier's per-group (L, ...) tensors, which
the port keeps in JAX's layout, and are JAX's exactly.

``shard`` cuts a full tree into one rank's pieces (JAX's ``named`` +
``jax.device_put``), ``unshard`` puts every rank's pieces back together
in one process, ``gather`` does so collectively inside the ranks, and
``host_to_mesh`` places a host tree on this rank's device, cut by its
specs. A mesh is anything with ``axis_names`` and a ``shape`` mapping
(``repro_torch.launch.mesh.Mesh``); ``shard`` also reads its ``coords``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

FSDP_AXES_MULTIPOD = ("pod", "data")
FSDP_AXES = ("data",)

Spec = Tuple[Any, ...]


def P(*dims) -> Spec:
    """A spec: ``PartitionSpec(*dims)`` as a tuple (a one-name tuple
    becomes the name)."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in dims)


class Halves(tuple):
    """A spec whose last dimension is two equal halves, each cut by the
    last entry: Mamba's ``in_proj`` (D, 2·di) = [xin | z], whose rank
    holds the same channels of both halves (a contiguous cut would give
    rank 0 of 2 all of ``xin`` and none of ``z``). Equal to the plain
    spec as a tuple; ``shard_leaf``, ``unshard`` and ``gather`` read it."""

    def halved(self) -> Spec:
        """The spec over the leaf viewed as (..., 2, n / 2)."""
        return tuple(self[:-1]) + (None, self[-1])


def _halve(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], 2, t.shape[-1] // 2)


def _unhalve(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(*t.shape[:-2], -1)


def fsdp_axes(mesh):
    return FSDP_AXES_MULTIPOD if "pod" in mesh.axis_names else FSDP_AXES


def dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in fsdp_axes(mesh)]))


def tp_size(mesh) -> int:
    return int(mesh.shape["model"]) if "model" in mesh.axis_names else 1


def _div(n: int, k: int) -> bool:
    return n > 0 and k > 0 and n % k == 0


def _map_with_path(fn, tree, path=()):
    """``jax.tree_util.tree_map_with_path`` over dicts (sorted keys), lists
    and tuples: ``fn(path, leaf)``, the path's entries the keys and the
    list indices as strings."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, x, path + (str(i),))
                          for i, x in enumerate(tree))
    return fn(path, tree)


class ArchSharding:
    """Resolved sharding decisions for one (arch, mesh) pair."""

    def __init__(self, cfg: ArchConfig, mesh, *, ep_resident: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.fsdp = fsdp_axes(mesh)
        # ep_resident: shard MoE experts over every mesh axis, resident
        self.ep_resident = ep_resident
        tp = tp_size(mesh)
        self.tp_heads = _div(cfg.n_heads, tp)          # q/o head-dim TP
        self.tp_kv = _div(cfg.n_kv_heads, tp)          # kv-head TP for caches
        self.tp_ff = _div(cfg.d_ff, tp)
        self.tp_vocab = _div(cfg.vocab_size, tp)
        self.tp_experts = cfg.moe is not None and _div(cfg.moe.num_experts,
                                                       tp)
        self.tp_dmodel = _div(cfg.d_model, tp)
        if cfg.mamba is not None:
            self.tp_di = _div(cfg.mamba.expand * cfg.d_model, tp)
        else:
            self.tp_di = False
        nh_rwkv = cfg.d_model // cfg.rwkv_head_dim if cfg.rwkv_head_dim else 0
        self.tp_rwkv = _div(nh_rwkv, tp)
        # projection-output TP: head-boundary TP for attention archs,
        # rwkv-head-boundary TP for attention-free archs
        self.tp_proj = self.tp_heads if cfg.n_heads > 0 else self.tp_rwkv

    # -- reporting ----------------------------------------------------------
    def tp_report(self) -> Dict[str, bool]:
        return {k: getattr(self, k) for k in
                ("tp_heads", "tp_kv", "tp_ff", "tp_vocab", "tp_experts",
                 "tp_di", "tp_rwkv")}

    # -- parameter specs ----------------------------------------------------
    def param_spec(self, path: Tuple[str, ...], leaf) -> Spec:
        """The spec of one parameter, by tree path and shape (JAX
        ``rules.py:88-166`` for an unstacked leaf)."""
        f = self.fsdp
        tp = "model"
        name = path[-1]
        ndim = len(leaf.shape)

        if name == "embed":
            return P(tp if self.tp_vocab else None, f)
        if name == "lm_head":
            return P(f, tp if self.tp_vocab else None)
        if path[-2:] == ("final_norm", "scale") or name in ("scale",):
            return P(None)

        # attention (and rwkv projections, which share names)
        if name in ("wq", "wk", "wv", "xq", "xk", "xv"):
            return P(f, tp if self.tp_proj else None)
        if name in ("wo", "xo") and ndim == 2:
            if path[-2] == "mlp":           # dense mlp out
                return P(tp if self.tp_ff else None, f)
            return P(tp if self.tp_proj else None, f)
        if name in ("bq", "bk", "bv"):
            return P(tp if self.tp_heads else None)
        if name == "xgate":
            return P(None)

        # moe
        if name == "router":
            return P(f, None)
        if path[-2] == "mlp" and name in ("wi", "wg") and ndim == 3:
            if self.ep_resident:
                return P(tuple(self.mesh.axis_names), None, None)
            return P(tp if self.tp_experts else None, f, None)
        if path[-2] == "mlp" and name == "wo" and ndim == 3:
            if self.ep_resident:
                return P(tuple(self.mesh.axis_names), None, None)
            return P(tp if self.tp_experts else None, None, f)
        # dense mlp
        if name in ("wi", "wg"):
            return P(f, tp if self.tp_ff else None)

        # mamba
        if name == "in_proj":
            return P(f, tp if self.tp_di else None)
        if name == "conv_w":
            return P(None, tp if self.tp_di else None)
        if name == "x_proj":
            return P(tp if self.tp_di else None, None)
        if name == "dt_proj":
            return P(None, tp if self.tp_di else None)
        if name == "A_log":
            return P(tp if self.tp_di else None, None)
        if name in ("D", "dt_bias"):
            return P(tp if self.tp_di else None)
        if name == "out_proj":
            return P(tp if self.tp_di else None, f)

        # rwkv time-mix / channel-mix
        if name in ("wr", "wk", "wv", "wg", "ww"):
            if leaf.shape[-1] == self.cfg.d_ff:
                return P(f, tp if self.tp_ff else None)
            return P(f, tp if self.tp_rwkv else None)
        if name == "u":
            return P(tp if self.tp_rwkv else None, None)
        if name in ("w_bias", "ln_scale") or name.startswith("mix_"):
            return P(None)

        # fallback: fsdp on the largest dim
        if ndim >= 2:
            dims = [None] * ndim
            dims[int(np.argmax(leaf.shape))] = f
            return P(*dims)
        return P(*([None] * ndim))

    def param_specs(self, params, *, replicate_fsdp: bool = False) -> Any:
        """Spec tree of ``params``. replicate_fsdp=True (serving): drop the
        FSDP axes from every spec, so weights stay resident; valid when
        the per-TP-shard weight bytes fit (``serving_replication_fits``)."""
        def walk(path, leaf):
            spec = self.param_spec(path, leaf)
            if replicate_fsdp:
                spec = P(*(None if dim == self.fsdp or dim in self.fsdp
                           else dim for dim in spec))
            return spec
        return _map_with_path(walk, params)

    def serving_replication_fits(self, param_bytes: float,
                                 budget: float = 4 * 2 ** 30) -> bool:
        """Can the model serve with weights replicated over the data axes
        (TP-sharded only)? param_bytes is the total weight footprint."""
        return param_bytes / max(tp_size(self.mesh), 1) <= budget

    # -- batch / activation specs -------------------------------------------
    def batch_spec(self, global_batch: int) -> Spec:
        """Batch dim sharding: over fsdp axes when divisible, else None."""
        if _div(global_batch, dp_size(self.mesh)):
            return P(self.fsdp)
        if _div(global_batch, int(self.mesh.shape[self.fsdp[-1]])):
            return P(self.fsdp[-1])
        return P(None)

    def train_batch_specs(self, global_batch: int) -> Dict[str, Spec]:
        b = self.batch_spec(global_batch)
        specs = {"inputs": P(*b, None) if not self.cfg.embeds_in
                 else P(*b, None, None),
                 "labels": P(*b, None)}
        if self.cfg.xattn_ctx_len:
            specs["xctx"] = P(*b, None, None)
        return specs

    def cache_specs(self, cache_tree, global_batch: int) -> Any:
        """Decode-cache specs of the port's uniform cache (one dict per
        layer): batch-sharded when possible; the time axis over every mesh
        axis not already used (JAX ``rules.py:211-254``)."""
        bspec = self.batch_spec(global_batch)
        batch_sharded = bspec != P(None)
        t_axes = []
        if not batch_sharded:
            t_axes.append("data")
        if not self.tp_kv:
            t_axes.append("model")
        seq_axis = tuple(t_axes) if t_axes else None
        kv = "model" if self.tp_kv else None

        def walk(path, leaf):
            name = path[-1] if path else ""
            if name in ("k", "v"):                     # (B,T,HKV,dh)
                return P(*bspec, seq_axis, kv, None)
            if name in ("xk", "xv"):
                return P(*bspec, None, kv, None)
            if name == "slot_pos":                     # (T,)
                return P(seq_axis)
            if name == "pos":
                return P()
            if name == "conv":                         # (B,dconv-1,di)
                return P(*bspec, None, "model" if self.tp_di else None)
            if name == "ssm":                          # (B,di,ds)
                return P(*bspec, "model" if self.tp_di else None, None)
            if name == "state":                        # (B,nh,hd,hd)
                return P(*bspec, "model" if self.tp_rwkv else None,
                         None, None)
            if name in ("shift", "shift_mlp"):         # (B,1,D)
                return P(*bspec, None, None)
            return P(*([None] * len(leaf.shape)))

        return _map_with_path(walk, cache_tree)

    # -- serving (engine-resident) specs ------------------------------------
    def serve_param_specs(self, params) -> Any:
        """Serving weights: tensor-parallel over "model" where head / expert
        / ff boundaries divide, replicated over the data axes."""
        return self.param_specs(params, replicate_fsdp=True)

    def serve_slot_axis(self, n_slots: int):
        """Slots shard over the data axes when they divide evenly (each
        shard owns whole sequences), else they are replicated."""
        if _div(n_slots, dp_size(self.mesh)):
            return self.fsdp
        return None

    def serve_slot_cache_specs(self, cache_tree, n_slots: int) -> Any:
        """Slot-layout engine cache: KV heads over "model" when divisible,
        slots over the data axes when divisible, the time axis never
        sharded (JAX ``rules.py:262-296``)."""
        b = self.serve_slot_axis(n_slots)
        kv = "model" if self.tp_kv else None

        def walk(path, leaf):
            name = path[-1] if path else ""
            if name in ("k", "v", "xk", "xv"):         # (B,T,HKV,dh)
                return P(b, None, kv, None)
            if name == "slot_pos":                     # (B,T)
                return P(b, None)
            if name == "pos":                          # (B,)
                return P(b)
            if name == "conv":                         # (B,dconv-1,di)
                return P(b, None, "model" if self.tp_di else None)
            if name == "ssm":                          # (B,di,ds)
                return P(b, "model" if self.tp_di else None, None)
            if name == "state":                        # (B,nh,hd,hd)
                return P(b, "model" if self.tp_rwkv else None, None, None)
            if name in ("shift", "shift_mlp"):         # (B,1,D)
                return P(b, None, None)
            return P(*([None] * len(leaf.shape)))

        return _map_with_path(walk, cache_tree)

    def serve_chunk_operand_specs(self, paged: bool) -> Tuple[Spec, ...]:
        """The chunk program's host-built operands (chunk tokens, lengths,
        starts, masks, keys and, paged, the two block tables): replicated."""
        return tuple(P() for _ in range(10 if paged else 8))

    def serve_verify_operand_specs(self, paged: bool) -> Tuple[Spec, ...]:
        """The verify program's host-built operands: replicated."""
        return tuple(P() for _ in range(6 if paged else 5))

    def serve_swap_block_specs(self, cache_tree) -> Any:
        """One exported block, (L, bs, HKV, dh) a layer group (the host
        tier's layout): the KV-head axis keeps the pool's "model" sharding,
        so every shard moves only its heads' slice. ``cache_tree`` is the
        paged cache (its first layer of each pattern position is read)."""
        kv = "model" if self.tp_kv else None
        out = []
        for g in cache_tree[:len(self.cfg.block_pattern)]:
            spec = {"k": P(None, None, kv, None), "v": P(None, None, kv, None)}
            if "ks" in g:              # quantized pool: (L, HKV) scales
                spec["ks"] = spec["vs"] = P(None, kv)
            out.append(spec)
        return tuple(out)

    def serve_swap_chain_specs(self, cache_tree) -> Any:
        """A whole exported chain, (L, n, bs, HKV, dh) a layer group: the
        block specs with a leading (replicated) chain axis."""
        kv = "model" if self.tp_kv else None
        out = []
        for g in cache_tree[:len(self.cfg.block_pattern)]:
            blk = P(None, None, None, kv, None)
            spec = {"k": blk, "v": blk}
            if "ks" in g:              # quantized pool: (L, n, HKV) scales
                spec["ks"] = spec["vs"] = P(None, None, kv)
            out.append(spec)
        return tuple(out)

    def serve_paged_cache_specs(self, cache_tree) -> Any:
        """Paged engine cache: the pools' KV-head axis over "model" (one
        logical block table, per-shard physical blocks); per-slot
        positions replicated."""
        kv = "model" if self.tp_kv else None

        def walk(path, leaf):
            name = path[-1] if path else ""
            if name in ("kp", "vp"):                   # (P+1,bs,HKV,dh)
                return P(None, None, kv, None)
            if name in ("ks", "vs"):                   # (P+1,HKV) scales
                return P(None, kv)
            return P(*([None] * len(leaf.shape)))

        return _map_with_path(walk, cache_tree)


# ---------------------------------------------------------------------------
# Placement: one rank's pieces of a full tree
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        d is None or isinstance(d, (str, tuple)) for d in x)


def _axes(dim) -> Tuple[str, ...]:
    if dim is None:
        return ()
    return (dim,) if isinstance(dim, str) else tuple(dim)


def _piece(mesh, coords: Dict[str, int], dim) -> Tuple[int, int]:
    """(pieces, index) of one spec entry: the entry's axes taken row-major
    over the mesh."""
    n, idx = 1, 0
    for a in _axes(dim):
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + coords[a]
    return n, idx


def _zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (specs are leaves
    of the spec tree; NamedTuples such as ``TrainState`` are nodes)."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        out = [_zip_specs(fn, x, s) for x, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    return fn(tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in the order ``repro_torch.tree.leaves``
    visits the leaves of its tree (dicts by sorted key)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if _is_spec(specs):
        return [specs]
    return [x for sub in specs for x in spec_leaves(sub)]


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec cuts over."""
    return tuple(a for dim in spec for a in _axes(dim))


def shard_leaf(leaf: torch.Tensor, spec: Spec, mesh,
               coords: Dict[str, int]) -> torch.Tensor:
    """This rank's piece of one full tensor: each dimension whose spec
    entry names axes is cut into as many equal pieces, row-major over
    them. A fresh tensor (the full one may be freed)."""
    if isinstance(spec, Halves):
        return _unhalve(shard_leaf(_halve(leaf), spec.halved(), mesh,
                                   coords))
    out = leaf
    for d, dim in enumerate(spec):
        n, idx = _piece(mesh, coords, dim)
        if n == 1:
            continue
        size = leaf.shape[d]
        if size % n:
            raise ValueError(f"dimension {d} of size {size} does not split "
                             f"into {n} pieces (spec {spec})")
        out = out.narrow(d, idx * (size // n), size // n)
    return out.clone() if out is leaf else out.contiguous().clone()


def shard(tree, specs, mesh):
    """``tree`` cut into the pieces this rank of ``mesh`` holds (JAX's
    ``device_put`` under ``named(mesh, specs)``)."""
    coords = mesh.coords
    return _zip_specs(lambda t, s: shard_leaf(t, s, mesh, coords), tree,
                      specs)


def unshard(pieces: Sequence[Any], specs, mesh):
    """The full tree from every rank's pieces (``pieces[r]`` rank ``r``'s,
    ranks row-major over the mesh axes): the inverse of ``shard``. Pieces
    of a replicated dimension must agree; the last rank's is kept."""
    def put(spec, *leaves):
        if isinstance(spec, Halves):
            return _unhalve(put(spec.halved(), *map(_halve, leaves)))
        shape = list(leaves[0].shape)
        for d, dim in enumerate(spec):
            shape[d] *= _piece(mesh, mesh.coords_of(0), dim)[0]
        full = torch.empty(shape, dtype=leaves[0].dtype)
        for r, leaf in enumerate(leaves):
            coords = mesh.coords_of(r)
            view = full
            for d, dim in enumerate(spec):
                n, idx = _piece(mesh, coords, dim)
                view = view.narrow(d, idx * leaf.shape[d], leaf.shape[d])
            view.copy_(leaf.cpu())
        return full

    def walk(spec_tree, *trees):
        if isinstance(spec_tree, dict):
            return {k: walk(spec_tree[k], *(t[k] for t in trees))
                    for k in spec_tree}
        if _is_spec(spec_tree):
            return put(spec_tree, *trees)
        out = [walk(s, *xs) for s, *xs in zip(spec_tree, *trees)]
        kind = type(trees[0])
        return kind(*out) if hasattr(trees[0], "_fields") else kind(out)
    return walk(specs, *pieces)


def gather(tree, specs, mesh):
    """The full tree from this rank's pieces, on every rank: each cut
    dimension gathered over its axes (a collective: every rank of the
    mesh calls it with the same specs), innermost axis first."""
    def full(leaf, spec):
        if isinstance(spec, Halves):
            return _unhalve(full(_halve(leaf), spec.halved()))
        for d, dim in enumerate(spec):
            for a in reversed(_axes(dim)):
                leaf = mesh.comm(a).all_gather(leaf, d)
        return leaf
    return _zip_specs(full, tree, specs)


def host_to_mesh(tree, specs=None, mesh=None, device="cpu"):
    """A host tree onto ``device``: with ``specs`` (and ``mesh``) this
    rank's pieces only, never the full arrays (the host→device path of the
    KV hierarchy: swap-in, promotion, warm-start restore); without, whole."""
    def put(leaf):
        return torch.as_tensor(np.asarray(leaf)).to(device)
    if specs is None:
        return _zip_specs(lambda t, s: put(t), tree, tree)
    return _zip_specs(lambda t, s: shard_leaf(torch.as_tensor(t), s, mesh,
                                              mesh.coords).to(device),
                      tree, specs)

"""Paged KV memory: virtual memory for the serving engine's cache — the
device side of ``src/repro/serve/paging.py``.

The dense ``SlottedKV`` backend reserves a ``max_len`` row per slot, so
admission capacity is bounded by *worst-case* sequence length; here it is
bounded by the tokens actually resident:

  BlockPool     ref-counted allocator over a fixed pool of physical KV
                blocks (``block_size`` token positions each). Row ``P`` of
                the device pool is the reserved *trash block* — the write
                target of empty and finished slots, so their garbage never
                touches a live sequence.
  BlockTable    one slot's chain: logical block index -> physical block,
                mirrored on the device as one (n_slots, nb) int32 table per
                program.
  PrefixIndex   radix tree over *full* blocks of prompt tokens: identical
                prompt prefixes (system prompts) resolve to the same
                physical blocks, prefilled once and shared copy-on-write.
                Index-only blocks are evicted LRU under pool pressure.
  PagedKV       the ``KVBackend`` tying these to the device pools: demand
                allocation at block boundaries, CoW forks before any write
                to a shared block, and recompute preemption under pool
                pressure (the engine's ``PreemptionPolicy``).

Quantized pools (``kv_dtype`` int8 / fp8, ``repro_torch.kernels.kv_quant``)
store per-(block, KV head) scales beside the pools; every write re-encodes
the blocks it touches, CoW copies the scales, and a block is cleared when
it is allocated. The host tier (``HostBlockStore``, swap, demotion,
persistence) and meshes of the JAX module are ROADMAP module items 8 and
13.

The pool operations (scatter a prefilled run, gather a slot's view, copy a
block) update the pools in place: the L2 analogue of JAX buffer donation.
The subsystem is invisible to the application: token streams are
bit-identical to the slotted backend and to sequential decode. Sharing is
capped at ``prompt_len - 1`` tokens so every request computes at least its
final prompt position, whose logits seed generation.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linkage import L3_NSS
from repro_torch.core.step import (build_paged_decode_step, build_prefill_fn,
                                   build_serve_step, build_verify_step,
                                   make_sampler)
from repro_torch.kernels import kv_quant
from repro_torch.kernels.kv_quant import quant_insert, raw
from repro_torch.kernels.ref import gather_pool
from repro_torch.models.transformer import (Cache, _check_pageable,
                                            layer_specs, prefill_suffix)
from repro_torch.serve.cache import tensor
from repro_torch.serve.telemetry import NULL_TELEMETRY


# ---------------------------------------------------------------------------
# Host-side allocator / page tables / prefix index
# ---------------------------------------------------------------------------

class BlockPool:
    """Ref-counted allocator over ``num_blocks`` physical KV blocks.

    Deterministic: free blocks are handed out lowest-id-first, so a fixed
    request schedule replays the exact same physical layout. Tracks the
    resident-block high-watermark (the paged analogue of peak RSS).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("BlockPool needs num_blocks, block_size >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks))
        heapq.heapify(self._free)
        self.refs = np.zeros(num_blocks, np.int32)
        self.hwm = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_resident(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        """Lowest free block with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        blk = heapq.heappop(self._free)
        self.refs[blk] = 1
        self.hwm = max(self.hwm, self.n_resident)
        return blk

    def retain(self, blk: int) -> None:
        if self.refs[blk] <= 0:
            raise ValueError(f"retain of unallocated block {blk}")
        self.refs[blk] += 1

    def free(self, blk: int) -> bool:
        """Drop one reference; returns True when the block went physically
        free. Freeing an unallocated block is a double-free: error."""
        if self.refs[blk] <= 0:
            raise ValueError(f"double free of block {blk}")
        self.refs[blk] -= 1
        if self.refs[blk] == 0:
            heapq.heappush(self._free, blk)
            return True
        return False


class BlockTable:
    """One slot's logical-block -> physical-block chain."""

    def __init__(self, blocks: Optional[List[int]] = None):
        self.blocks: List[int] = list(blocks or [])

    def __len__(self) -> int:
        return len(self.blocks)

    def __getitem__(self, i: int) -> int:
        return self.blocks[i]

    def append(self, blk: int) -> None:
        self.blocks.append(blk)

    def replace(self, i: int, blk: int) -> None:
        self.blocks[i] = blk


class _Node:
    __slots__ = ("key", "block", "children", "parent", "tick")

    def __init__(self, key, block, parent):
        self.key = key                  # tuple of block_size token ids
        self.block = block              # physical block id
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.tick = 0


class PrefixIndex:
    """Radix tree over full prompt blocks -> physical blocks.

    Each node covers exactly ``block_size`` tokens, keyed by their values,
    so a lookup is one dict probe per block. The index holds its own
    reference on every block it names; blocks whose only reference is the
    index are evictable (LRU, leaves first — evicting a leaf may expose its
    parent).
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _Node((), -1, None)
        self._by_block: Dict[int, _Node] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._by_block)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def _keys(self, tokens: np.ndarray):
        bs = self.block_size
        for i in range(len(tokens) // bs):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens: np.ndarray) -> List[int]:
        """Longest chain of full blocks whose token content prefixes
        ``tokens``; touched for LRU."""
        node, out = self.root, []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens: np.ndarray, blocks: List[int], n_full: int,
               pool: BlockPool) -> None:
        """Register the first ``n_full`` full blocks of ``tokens`` (their
        KV already written to ``blocks``). Existing nodes are kept — the
        caller matched them first, so a fresh node always carries a fresh
        block. The index retains each block it adopts."""
        node = self.root
        for i, key in enumerate(self._keys(tokens)):
            if i >= n_full:
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], node)
                node.children[key] = child
                self._by_block[blocks[i]] = child
                pool.retain(blocks[i])
            self._touch(child)
            node = child

    def n_evictable(self, pool: BlockPool) -> int:
        """Blocks freeable by cascading leaf eviction: nodes whose whole
        subtree is index-exclusive (refcount 1)."""
        def walk(node: _Node):
            count, all_ev = 0, True
            for c in node.children.values():
                n, ev = walk(c)
                count += n
                all_ev &= ev
            mine = all_ev and pool.refs[node.block] == 1
            return count + (1 if mine else 0), mine
        return sum(walk(c)[0] for c in self.root.children.values())

    def evict(self, pool: BlockPool, need: int) -> int:
        """Free up to ``need`` blocks, least-recently-touched leaves first
        (evicting a leaf may expose its parent). Returns how many were
        physically freed."""
        cands = [(n.tick, n.block) for n in self._by_block.values()
                 if not n.children and pool.refs[n.block] == 1]
        heapq.heapify(cands)
        freed = 0
        while freed < need and cands:
            tick, blk = heapq.heappop(cands)
            node = self._by_block.get(blk)
            if (node is None or node.children or node.tick != tick
                    or pool.refs[blk] != 1):
                continue                       # stale heap entry
            parent = node.parent
            del parent.children[node.key]
            del self._by_block[blk]
            pool.free(blk)
            freed += 1
            if (parent is not self.root and not parent.children
                    and pool.refs[parent.block] == 1):
                heapq.heappush(cands, (parent.tick, parent.block))
        return freed


# ---------------------------------------------------------------------------
# Device pools + in-place page operations
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int,
                     n_slots: int, dtype=torch.bfloat16, device="cuda",
                     kv_dtype: str = "bf16") -> Cache:
    """One dict per layer: {"kp","vp": (P+1, bs, HKV, dh) zeros (row P =
    trash block), "pos": (B,) int32}. JAX stacks the layers of a pattern
    position into (L, P+1, ...) pools; the port keeps its per-layer list.

    A quantized ``kv_dtype`` (int8 / fp8) stores the pools in its codes
    and adds the per-block scales {"ks","vs"}: (P+1, HKV) f32 ones
    (``paging.py:512-537``). ``kv_dtype="bf16"`` stores ``dtype`` and adds
    nothing."""
    store = kv_quant.storage_dtype(kv_dtype, dtype)
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    out = []
    for _ in layer_specs(cfg):
        g = {"kp": torch.zeros(shape, dtype=store, device=device),
             "vp": torch.zeros(shape, dtype=store, device=device),
             "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device)}
        if kv_dtype != "bf16":
            for name in ("ks", "vs"):
                g[name] = torch.ones((num_blocks + 1, cfg.n_kv_heads),
                                     dtype=torch.float32, device=device)
        out.append(g)
    return out


def scatter_kv(cache: Cache, kvs: Cache, blks: torch.Tensor,
               offs: torch.Tensor, slot: int, new_pos: int) -> None:
    """Write a prefilled K/V run (per layer {"k","v"}: (1, S, HKV, dh)) into
    pool destinations (blks[i], offs[i]) and set the slot's position, in
    place. Padding rows target the trash block. Quantized pools take the
    run through ``quant_insert`` (``paging.py:563-570``)."""
    for g, kv in zip(cache, kvs):
        if "ks" in g:
            quant_insert(g["kp"], g["ks"], blks, offs, kv["k"][0])
            quant_insert(g["vp"], g["vs"], blks, offs, kv["v"][0])
        else:
            g["kp"][blks, offs] = kv["k"][0].to(g["kp"].dtype)
            g["vp"][blks, offs] = kv["v"][0].to(g["vp"].dtype)
        g["pos"][slot] = new_pos


def gather_prefix(cache: Cache, row: torch.Tensor, max_len: int) -> Cache:
    """One slot's logical view, per layer {"k","v"}: (1, max_len, HKV, dh),
    gathered through its table row (nb,) — what the shared-prefix suffix
    prefill attends over. Quantized pools give their decoded f32 view
    (``paging.py:592-600``)."""
    return [{"k": gather_pool(g["kp"], row[None], g.get("ks"))[:, :max_len],
             "v": gather_pool(g["vp"], row[None], g.get("vs"))[:, :max_len]}
            for g in cache]


def copy_block(cache: Cache, src: int, dst: int) -> None:
    """Device-side block copy, in place: the copy half of copy-on-write.
    Quantized pools copy the block's scales with its codes."""
    for g in cache:
        for name in ("kp", "vp", "ks", "vs"):
            if name in g:
                raw(g[name])[dst].copy_(raw(g[name])[src])


def zero_block(cache: Cache, blk: int) -> None:
    """Clear one block's codes and reset its scales to 1, in place
    (``paging.py:627-651``). Run when a quantized pool allocates a block:
    ``quant_insert`` takes each touched block's amax over all its lanes, so
    a previous tenant's stale bytes would leak into the new scale and make
    token streams depend on allocation history. The unquantized control
    masks stale lanes at attention time and needs no clearing."""
    for g in cache:
        raw(g["kp"])[blk].zero_()
        raw(g["vp"])[blk].zero_()
        g["ks"][blk].fill_(1.0)
        g["vs"][blk].fill_(1.0)


# ---------------------------------------------------------------------------
# The KV backend
# ---------------------------------------------------------------------------

class PagedKV:
    """Block-table KV backend: the engine's ``--kv paged`` subsystem. The
    pools live on the parameters' device; the block tables are built on the
    host (numpy) and copied to the device once per program."""

    kind = "paged"
    #: telemetry hook bundle (the owning engine installs its own)
    tel = NULL_TELEMETRY

    def __init__(self, cfg: ArchConfig, params, opts, linkage, n_slots: int,
                 max_len: int, sampling=None, bucket_fn=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 chunked: bool = False, kv_dtype: str = "bf16",
                 spec: bool = False):
        _check_pageable(cfg, "PagedKV")
        self.cfg, self.params, self.opts = cfg, params, opts
        self.kv_dtype = kv_dtype
        self.n_slots, self.max_len = n_slots, max_len
        self.bs = block_size
        self.nb = -(-max_len // block_size)          # logical blocks per slot
        if num_blocks is None:
            # slotted-equivalent footprint, +1 so a lone worst-case request
            # always fits() (a CoW fork transiently holds old + new block)
            num_blocks = n_slots * self.nb + 1
        self.trash = num_blocks                      # reserved pool row
        self.K = linkage.decode_steps if linkage.level == L3_NSS else 1
        self.bucket_fn = bucket_fn
        self.device = params["embed"].device

        self.pool = BlockPool(num_blocks, block_size)
        self.index = PrefixIndex(block_size)
        self.chains: Dict[int, BlockTable] = {}
        self.tables_host = np.full((n_slots, self.nb), self.trash, np.int32)
        self.pos_host = np.zeros(n_slots, np.int64)
        self.cache = init_paged_cache(cfg, num_blocks, block_size, n_slots,
                                      opts.dtype, self.device, kv_dtype)
        self.cow_forks = 0
        self.prefix_shared_tokens = 0
        # one block across all layers: K and V codes plus, when quantized,
        # their (HKV,) f32 scales (``paging.py:783-793``)
        self._block_bytes = sum(
            2 * g["kp"][0].numel() * g["kp"].element_size()
            + (2 * g["ks"][0].numel() * g["ks"].element_size()
               if "ks" in g else 0)
            for g in self.cache)

        self.chunked = chunked
        # the decode program serves both step disciplines: two-phase decode
        # and the chunked engine's pure-decode steps
        self._dec = build_paged_decode_step(cfg, opts, linkage, max_len,
                                            sampling)
        if chunked:
            # the unified serve program replaces the blocking admission
            # prefill (full-prompt and shared-prefix suffix paths alike)
            self.prompts: Dict[int, np.ndarray] = {}
            self._serve = build_serve_step(cfg, opts, linkage, max_len,
                                           sampling, kv_kind="paged")
        else:
            self._sample = make_sampler(sampling)
            # full-prompt prefill (no sharing) — the slotted backend's own
            # program, so unshared admissions match it trivially
            self._prefill = build_prefill_fn(cfg, opts, max_len,
                                             bucket_fn=bucket_fn)
        if spec:
            # the verify window runs the chunk pass: the paged prefill
            # kernels under the shortcut
            self._verify = build_verify_step(cfg, opts, linkage, max_len,
                                             sampling, kv_kind="paged")
        self.keys = torch.zeros((n_slots, 2), dtype=torch.int64,
                                device=self.device)

    # -- allocation ---------------------------------------------------------

    def _alloc(self) -> Optional[int]:
        blk = self.pool.alloc()
        if blk is None and self.index.evict(self.pool, 1):
            blk = self.pool.alloc()
        if blk is not None and self.kv_dtype != "bf16":
            # quantized pools: scrub the previous tenant's bytes so block
            # scales stay a function of the sequence's own content
            zero_block(self.cache, blk)
        return blk

    def _cow(self, slot: int, chain: BlockTable, bi: int) -> bool:
        """Fork chain[bi] if shared: allocate, device-copy, swap, decref."""
        old = chain[bi]
        if self.pool.refs[old] <= 1:
            return True
        new = self._alloc()
        if new is None:
            return False
        copy_block(self.cache, old, new)
        self.pool.free(old)
        chain.replace(bi, new)
        self.tables_host[slot, bi] = new
        self.cow_forks += 1
        return True

    def _match_resident(self, prompt: np.ndarray) -> List[int]:
        """The resident prefix chain for a prompt: the device radix match
        (the host-tier promotion of the JAX module is item 8)."""
        return self.index.match(prompt)

    def _claim_prefix(self, slot: int, prompt: np.ndarray):
        """Radix-match the prompt and retain the shared blocks into a new
        chain for ``slot``. Returns (chain, shared tokens)."""
        P = int(prompt.shape[0])
        matched = self._match_resident(prompt)
        shared = min(len(matched) * self.bs, P - 1)
        chain = BlockTable()
        for b in matched[:-(-shared // self.bs)]:
            self.pool.retain(b)
            chain.append(b)
        self.tables_host[slot, :] = self.trash
        self.tables_host[slot, :len(chain)] = chain.blocks
        return chain, shared

    # -- KVBackend ----------------------------------------------------------

    def admit(self, slot: int, prompt: np.ndarray, key=None) -> torch.Tensor:
        P = int(prompt.shape[0])
        chain, shared = self._claim_prefix(slot, prompt)
        for _ in range(len(chain), -(-P // self.bs)):
            b = self._alloc()
            if b is None:
                raise RuntimeError("paged admit ran out of KV blocks "
                                   "(has_room gate should prevent this)")
            chain.append(b)
        self.tables_host[slot, :len(chain)] = chain.blocks
        if shared % self.bs:
            # a full-prefix hit was clipped to P-1: the final prompt token
            # lands inside the last shared block — fork it first
            if not self._cow(slot, chain, shared // self.bs):
                raise RuntimeError("paged admit ran out of KV blocks on "
                                   "CoW fork")

        d = self.device
        if shared == 0:
            Sb = P if self.bucket_fn is None else self.bucket_fn(P)
            logits, c1 = self._prefill(self.params, prompt)
            kvs = [{"k": g["k"][:, :Sb], "v": g["v"][:, :Sb]} for g in c1]
            logical = np.arange(Sb)
        else:
            Ls = P - shared
            Sb = Ls if self.bucket_fn is None else min(self.bucket_fn(Ls),
                                                       self.max_len - shared)
            padded = np.zeros((Sb,), np.int32)
            padded[:Ls] = prompt[shared:]
            pre = gather_prefix(self.cache, tensor(self.tables_host[slot], d),
                                self.max_len)
            logits, kvs = prefill_suffix(self.params,
                                         tensor(padded, d)[None], pre,
                                         shared, self.cfg, self.opts,
                                         true_len=Ls)
            logical = shared + np.arange(Sb)
            self.prefix_shared_tokens += shared

        blks = np.array([chain[p // self.bs] if p < P else self.trash
                         for p in logical], np.int64)
        offs = (logical % self.bs).astype(np.int64)
        scatter_kv(self.cache, kvs, tensor(blks, d), tensor(offs, d), slot, P)
        self.index.insert(prompt, chain.blocks, P // self.bs, self.pool)
        self.chains[slot] = chain
        self.pos_host[slot] = P
        if key is not None:
            self.keys[slot] = key
        first, krow = self._sample(logits, self.keys[slot:slot + 1])
        self.keys[slot] = krow[0]
        return first

    def decode(self, next_tokens: torch.Tensor) -> torch.Tensor:
        tables = tensor(self.tables_host, self.device)
        self.cache, toks, self.keys = self._dec(self.params, self.cache,
                                                next_tokens, self.keys,
                                                tables)
        self.pos_host += self.K
        return toks

    def reserve(self, slot: int, k: int) -> bool:
        """Demand-allocate (and CoW-fork) the blocks the next ``k`` writes
        will touch — K decode microsteps, or a verify row's whole draft
        span, so ``rollback`` never frees a shared block. False = pool
        dry: the engine preempts a slot."""
        chain = self.chains[slot]
        pos = int(self.pos_host[slot])
        last = min(pos + k - 1, self.nb * self.bs - 1)
        b0, b1 = pos // self.bs, last // self.bs
        while len(chain) <= b1:
            b = self._alloc()
            if b is None:
                return False
            chain.append(b)
            self.tables_host[slot, len(chain) - 1] = b
        for bi in range(b0, min(b1, len(chain) - 1) + 1):
            if not self._cow(slot, chain, bi):
                return False
        return True

    # -- chunked prefill ----------------------------------------------------

    def admit_chunked(self, slot: int, prompt: np.ndarray, key=None) -> int:
        """Begin a chunked admission: radix-match the prompt, retain the
        shared prefix blocks (resident already — a shared system prompt
        prefills once) and seed the slot's sampling chain. Blocks for the
        rest of the prompt are allocated chunk by chunk (``append_chunk``).
        Returns the shared token count."""
        chain, shared = self._claim_prefix(slot, prompt)
        self.chains[slot] = chain
        self.prompts[slot] = np.asarray(prompt, np.int32)
        self.pos_host[slot] = shared
        self.prefix_shared_tokens += shared
        if key is not None:
            self.keys[slot] = key
        return shared

    def append_chunk(self, slot: int, start: int, tokens: np.ndarray) -> bool:
        """Allocate (and CoW-fork) the blocks the chunk [start, start+len)
        will write, then register every prompt block the chunk *completes*
        in the prefix index — progressively, so an identical prompt admitted
        while this one is mid-prefill shares the blocks already landed.
        False = pool dry: the engine preempts a slot and replans (safe to
        retry: allocation and insertion are idempotent on an unchanged
        chain)."""
        n = int(np.asarray(tokens).shape[0])
        if n == 0:
            return True
        chain = self.chains[slot]
        b0, b1 = start // self.bs, (start + n - 1) // self.bs
        while len(chain) <= b1:
            b = self._alloc()
            if b is None:
                return False
            chain.append(b)
            self.tables_host[slot, len(chain) - 1] = b
        for bi in range(b0, b1 + 1):
            if not self._cow(slot, chain, bi):
                return False
        prompt = self.prompts[slot]
        n_full = min(start + n, int(prompt.shape[0])) // self.bs
        if n_full:
            self.index.insert(prompt, chain.blocks, n_full, self.pool)
        return True

    def serve_step(self, chunk_tokens, clen, start, reset, emit0, dec_mask,
                   dec_tok):
        """One unified serve program (``build_serve_step``). ``reset`` is
        the slotted backend's business: paged validity is positional."""
        dec_mask = np.asarray(dec_mask)
        # rows not in decode phase ride the scan against the trash block
        # only: their garbage microsteps never touch a live block (in
        # particular not a CoW-shared prefix block)
        scan_tables = np.where(dec_mask[:, None], self.tables_host,
                               self.trash).astype(np.int32)
        d = self.device
        self.cache, t0, seq, self.keys = self._serve(
            self.params, self.cache, tensor(chunk_tokens, d), tensor(clen, d),
            tensor(start, d), tensor(reset, d), tensor(emit0, d), dec_tok,
            tensor(dec_mask, d), self.keys, tensor(self.tables_host, d),
            tensor(scan_tables, d))
        self.pos_host[:] = (np.asarray(start, np.int64)
                            + np.asarray(clen, np.int64)
                            + self.K * dec_mask.astype(np.int64))
        return t0, seq

    # -- speculative decode -------------------------------------------------

    def verify_step(self, tokens, clen, start, vmask):
        """One draft-widened verify program over the pools. Host positions
        do not move here: the engine commits each row by ``rollback(slot,
        start + n_emit)`` once it has read the accept counts."""
        d = self.device
        self.cache, out, n_emit, self.keys = self._verify(
            self.params, self.cache, tensor(tokens, d), tensor(clen, d),
            tensor(start, d), tensor(vmask, d), self.keys,
            tensor(self.tables_host, d))
        return out, n_emit

    def rollback(self, slot: int, new_len: int) -> None:
        """Truncate ``slot``'s residency to ``new_len`` tokens
        (``paging.py:1555``): free the whole blocks past it and rewind the
        host position. A freed block lies wholly past ``new_len`` > the
        prompt, so it is neither radix-registered (the index covers prompt
        blocks) nor shared (``reserve`` forked the draft span). The device
        needs nothing: the verify program rewound ``pos``, position
        ``new_len`` is rewritten by the next program, and past it is
        causally masked."""
        chain = self.chains[slot]
        keep = -(-new_len // self.bs)
        for b in chain.blocks[keep:]:
            self.pool.free(b)
        if len(chain) > keep:
            self.tables_host[slot, keep:len(chain)] = self.trash
            del chain.blocks[keep:]
        self.pos_host[slot] = new_len

    def release(self, slot: int) -> None:
        for b in self.chains.pop(slot, BlockTable()).blocks:
            self.pool.free(b)
        if self.chunked:
            self.prompts.pop(slot, None)
        self.tables_host[slot, :] = self.trash
        self.pos_host[slot] = 0

    def fits(self, prompt_len: int, max_new: int) -> bool:
        worst_pos = prompt_len + -(-max_new // self.K) * self.K
        need = min(self.nb, -(-worst_pos // self.bs)) + 1
        return need <= self.pool.num_blocks

    def has_room(self, prompt_len: int) -> bool:
        # prompt + CoW fork + first decode block, capped at the pool size so
        # a request that fits() can always be admitted on an idle pool
        need = min(-(-prompt_len // self.bs) + 2, self.pool.num_blocks)
        if self.pool.n_free >= need:
            return True                       # skip the index walk
        return need <= self.pool.n_free + self.index.n_evictable(self.pool)

    def utilization(self) -> dict:
        return {
            "kv_blocks_total": self.pool.num_blocks,
            "kv_block_size": self.bs,
            "kv_blocks_resident": self.pool.n_resident,
            "kv_blocks_hwm": self.pool.hwm,
            "kv_cow_forks": self.cow_forks,
            "kv_prefix_shared_tokens": self.prefix_shared_tokens,
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_block": self._block_bytes,
        }

    def reset_counters(self) -> None:
        self.cow_forks = 0
        self.prefix_shared_tokens = 0
        self.pool.hwm = self.pool.n_resident

    def drop_prefix_cache(self) -> int:
        """Evict every index-only block (e.g. to shed warmup residue before
        a timed run). Returns how many blocks were freed."""
        freed = self.index.evict(self.pool, self.pool.num_blocks)
        self.pool.hwm = self.pool.n_resident
        return freed

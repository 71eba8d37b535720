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
  HostBlockStore  the second tier: host-memory tensors (pinned when the
                pools live on a GPU) with the device pool's block geometry,
                its own free list, refcounts and LRU ticks. Swapped-out
                victim chains (held until swap-in) and demoted prefix
                blocks (evictable LRU) spill here instead of dying, and it
                is what ``save``/``restore`` persist across restarts.
  PagedKV       the ``KVBackend`` tying these to the device pools: demand
                allocation at block boundaries, CoW forks before any write
                to a shared block, and under pool pressure either recompute
                or swap-out preemption (device→host chain copy, resumed by
                swap-in without re-prefill; the engine's
                ``PreemptionPolicy`` chooses).

The tiers talk through chain-at-once copies (``export_chain`` /
``import_chain``: one gather or scatter a layer for a whole chain). Under
async swap (the default) a device→host chain transfer is issued on a
``SwapStream``: on a GPU the exported chain (a fresh tensor) is copied into
pinned memory on a side CUDA stream, fenced by events, and the transfer
completes at the owning engine's step boundaries (``drain_swaps``), so the
device blocks recycle at once; the engine may also ``prefetch_swap_in`` the
resume-head victim, its host→device copy running on the side stream under
the current device step. Evicted shared prefixes demote device→host and
promote back on a radix hit; ``save``/``restore`` persist the host tier
plus the device radix index, keyed by prompt tokens and fingerprinted by
config, in the JAX package's npz layout (a file passes between the two).
A fleet of engine replicas shares one host tier (``SharedHostTier``): every
replica demotes into it, publishes freshly indexed prompt blocks through
it (``_publish``) and promotes from it by copy, and a prefill replica hands
finished chains to a decode replica over it. Under a serving mesh every
rank makes the same block decisions over one logical block table, its pools
and its host tier holding its KV heads' slice of every block.

Quantized pools (``kv_dtype`` int8 / fp8, ``repro_torch.kernels.kv_quant``)
store per-(block, KV head) scales beside the pools; every write re-encodes
the blocks it touches, CoW copies the scales, and a block is cleared when
it is allocated. Their blocks cross the tiers as raw codes with their
scales, bit for bit.

The pool operations (scatter a prefilled run, gather a slot's view, copy a
block) update the pools in place: the L2 analogue of JAX buffer donation.
The subsystem is invisible to the application: token streams are
bit-identical to the slotted backend and to sequential decode. Sharing is
capped at ``prompt_len - 1`` tokens so every request computes at least its
final prompt position, whose logits seed generation.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Any, Dict, List, Optional, Tuple

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
from repro_torch.serve.cache import operands, tensor
from repro_torch.serve.telemetry import NULL_TELEMETRY
from repro_torch.sharding.rules import host_to_mesh


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
               pool: BlockPool) -> List[_Node]:
        """Register the first ``n_full`` full blocks of ``tokens`` (their
        KV already written to ``blocks``). Existing nodes are kept — the
        caller matched them first, so a fresh node always carries a fresh
        block. The index retains each block it adopts. Returns the nodes
        this insert created (what a shared tier's write-through would
        publish, ``PagedKV._publish``)."""
        node = self.root
        created: List[_Node] = []
        for i, key in enumerate(self._keys(tokens)):
            if i >= n_full:
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], node)
                node.children[key] = child
                self._by_block[blocks[i]] = child
                pool.retain(blocks[i])
                created.append(child)
            self._touch(child)
            node = child
        return created

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

    def node_tokens(self, node: _Node) -> np.ndarray:
        """The full token prefix a node covers (root → node keys
        concatenated): the host-tier and persistence key of its block."""
        parts = []
        while node.parent is not None:
            parts.append(node.key)
            node = node.parent
        return np.array([t for key in reversed(parts) for t in key],
                        np.int32)

    def walk(self):
        """Every node, parents before children, in insertion order: the
        persistence export order."""
        stack = list(reversed(list(self.root.children.values())))
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(list(node.children.values())))

    def evict(self, pool: BlockPool, need: int, on_evict=None) -> int:
        """Free up to ``need`` blocks, least-recently-touched leaves first
        (evicting a leaf may expose its parent). Returns how many were
        physically freed. ``on_evict(node)`` runs before each block is
        freed, while its device content is intact: the host tier's
        demotion hook."""
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
            if on_evict is not None:
                on_evict(node)
            parent = node.parent
            del parent.children[node.key]
            del self._by_block[blk]
            pool.free(blk)
            freed += 1
            if (parent is not self.root and not parent.children
                    and pool.refs[parent.block] == 1):
                heapq.heappush(cands, (parent.tick, parent.block))
        return freed


class HostBlockStore(BlockPool):
    """The host tier of the two-tier KV hierarchy: the device ``BlockPool``'s
    ref-counted free-list allocator (alloc touches, for LRU), per-block LRU
    ticks and optional storage. Holds swapped-out sequence chains (held by
    their ``SwapHandle``s) and demoted prefix blocks (one reference from the
    owner's prefix map, evictable least-recently-touched when the tier
    fills).

    Without ``group_shapes`` it is allocator-only (the mode the differential
    tests drive). With shapes — (L, bs, HKV, dh) a pattern position, L the
    layers at that position — it stores each group as (L, num_blocks, bs,
    HKV, dh) CPU tensors in the pool's storage dtype, plus (L, num_blocks,
    HKV) f32 scales when quantized, pinned (page-locked) when ``pin``: the
    form a GPU's copy engines read and write without a bounce."""

    def __init__(self, num_blocks: int, block_size: int,
                 group_shapes: Optional[List[Tuple[int, ...]]] = None,
                 dtype=torch.float32, scale_shapes=None, pin: bool = False):
        super().__init__(num_blocks, block_size)
        self.tick = np.zeros(num_blocks, np.int64)
        self._tick = 0
        self.k = self.v = None
        self.ks = self.vs = None
        #: drain callbacks of every SwapStream writing into this store: all
        #: of them complete before a read or a free of a possibly-pending
        #: block (``PagedKV._drain_tier``)
        self.drains: List[Any] = []
        if group_shapes is not None:
            def buf(s, dt):
                t = torch.empty((s[0], num_blocks) + tuple(s[1:]), dtype=dt,
                                pin_memory=pin)
                raw(t).zero_()
                return t
            self.k = [buf(s, dtype) for s in group_shapes]
            self.v = [buf(s, dtype) for s in group_shapes]
            if scale_shapes is not None:
                self.ks = [buf(s, torch.float32).fill_(1.0)
                           for s in scale_shapes]
                self.vs = [buf(s, torch.float32).fill_(1.0)
                           for s in scale_shapes]

    def alloc(self) -> Optional[int]:
        blk = super().alloc()
        if blk is not None:
            self.touch(blk)
        return blk

    def touch(self, blk: int) -> None:
        self._tick += 1
        self.tick[blk] = self._tick

    def _fields(self):
        names = ("k", "v") if self.ks is None else ("k", "v", "ks", "vs")
        return [(n, getattr(self, n)) for n in names]

    def tensors(self) -> List[torch.Tensor]:
        return [t for _, ts in self._fields() for t in ts]

    def write(self, blk: int, kvs) -> None:
        """Store one block: a tuple of {"k","v"} (plus {"ks","vs"} when
        quantized) per group, leaves (L, bs, HKV, dh) / (L, HKV)."""
        for name, store in self._fields():
            for g, kv in enumerate(kvs):
                raw(store[g])[:, blk].copy_(raw(kv[name]))

    def read(self, blk: int):
        """One block's K/V, as copies (safe to free the block at once)."""
        return tuple({name: store[g][:, blk].clone()
                      for name, store in self._fields()}
                     for g in range(len(self.k)))

    def write_chain(self, blks: List[int], kvs) -> None:
        """Store a whole exported chain (leaves (L, n, ...)) at host blocks
        ``blks``: the host half of a swap-out and the ``SwapStream`` write
        callback."""
        idx = torch.as_tensor(blks, dtype=torch.long)
        for name, store in self._fields():
            for g, kv in enumerate(kvs):
                raw(store[g]).index_copy_(1, idx, raw(kv[name]))

    def read_chain(self, blks: List[int], pin: bool = False):
        """A whole chain's K/V (leaves (L, n, ...)), gathered into fresh
        tensors — pinned when ``pin``, so a host→device copy from them runs
        asynchronously. (Fancy indexing would give pageable memory, which
        a non-blocking copy silently waits on.)"""
        idx = torch.as_tensor(blks, dtype=torch.long)
        out = []
        for g in range(len(self.k)):
            kv = {}
            for name, store in self._fields():
                t = store[g]
                kv[name] = torch.empty((t.shape[0], len(blks)) + t.shape[2:],
                                       dtype=t.dtype, pin_memory=pin)
                torch.index_select(raw(t), 1, idx, out=raw(kv[name]))
            out.append(kv)
        return tuple(out)


def _leaves(kvs) -> List[torch.Tensor]:
    return [t for kv in kvs for t in kv.values()]


def _require_pinned(tensors, what: str) -> None:
    """The GPU tier path never copies through pageable memory: a
    non-blocking copy from it silently blocks, so its buffers must be
    pinned, and otherwise this raises."""
    if not all(t.is_pinned() for t in tensors):
        raise RuntimeError(f"{what}: host buffer is not pinned (the GPU "
                           "swap path copies only through page-locked "
                           "memory)")


@dataclasses.dataclass
class SwapHandle:
    """A swapped-out sequence: its KV blocks parked in the host tier plus
    the per-slot device state needed to resume without re-prefill."""
    hblks: List[int]                     # host-tier block ids (chain order)
    pos: int                             # sequence position at swap-out
    key: torch.Tensor                    # (2,) sampling-chain row (a copy)
    prompt: Optional[np.ndarray] = None  # chunked: prompt source for the
                                         # remaining (mid-prefill) chunks
    prefetch: Any = None                 # in-flight host→device copy of the
                                         # chain (per-group device tensors)
    prefetch_ready: Any = None           # its completion event (GPU)
    dropped: bool = False                # drop_swap'd: resuming is an error


class SwapStream:
    """Double-buffered asynchronous device→host transfer queue.

    ``issue`` starts the copy of an exported chain and parks (host block
    ids, staged data, bytes); the oldest transfer completes (``write``
    callback into the host store) whenever more than ``depth`` are in
    flight, and ``drain`` completes everything. On a GPU ``issue`` records
    an event on the current stream after the export gather, makes a side
    stream wait on it, copies the chain non-blocking into pinned staging
    on the side stream and records a completion event; the pending entry
    keeps the exported device tensors alive until then, and completion
    synchronizes on that event before ``write``. On the CPU the export is
    already host memory and completes at the drain. The exported chains are
    fresh tensors, so the device pool blocks may be freed and reused while
    the transfer is in flight; only the host destination blocks must stay
    allocated until the drain, which is why ``PagedKV`` drains before any
    host-tier read or free of a possibly-pending block.
    """

    def __init__(self, write, depth: int = 2, device="cpu"):
        self.write = write               # write(hblks, kvs) callback
        self.depth = depth
        self.device = torch.device(device)
        self.pending: List[tuple] = []
        self._side = None

    def __len__(self) -> int:
        return len(self.pending)

    def side_stream(self):
        """The side CUDA stream the tier's copies run on (made on first
        use)."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def issue(self, hblks: List[int], kvs, nbytes: int) -> None:
        """Start the copy and enqueue its completion."""
        done = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            side = self.side_stream()
            side.wait_event(ready)
            with torch.cuda.stream(side):
                staged = tuple({n: _pinned_copy(t, non_blocking=True)
                                for n, t in kv.items()} for kv in kvs)
                done = torch.cuda.Event()
                done.record(side)
            _require_pinned(_leaves(staged), "SwapStream.issue")
            self.pending.append((list(hblks), staged, nbytes, done, kvs))
        else:
            self.pending.append((list(hblks), kvs, nbytes, None, None))
        while len(self.pending) > self.depth:
            self._complete_one()

    def _complete_one(self) -> Tuple[int, int]:
        hblks, staged, nbytes, done, _held = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        self.write(hblks, staged)
        return len(hblks), nbytes

    def drain(self) -> Tuple[int, int, int]:
        """Complete every in-flight transfer; (transfers, blocks, bytes)."""
        t = b = n = 0
        while self.pending:
            blocks, nbytes = self._complete_one()
            t += 1
            b += blocks
            n += nbytes
        return t, b, n


def _host_store(cfg: ArchConfig, opts, block_size: int, host_blocks: int,
                kv_dtype: str, pin: bool) -> HostBlockStore:
    """A host tier with the block geometry of ``PagedKV``'s pools: one
    (L, bs, HKV, dh) group a pattern position in the pools' storage dtype,
    plus (L, HKV) f32 scales when quantized."""
    L, groups = cfg.num_blocks, len(cfg.block_pattern)
    return HostBlockStore(
        host_blocks, block_size,
        group_shapes=[(L, block_size, cfg.n_kv_heads, cfg.head_dim)] * groups,
        dtype=kv_quant.storage_dtype(kv_dtype, opts.dtype),
        scale_shapes=(None if kv_dtype == "bf16"
                      else [(L, cfg.n_kv_heads)] * groups),
        pin=pin)


@dataclasses.dataclass
class SharedHostTier:
    """One host tier shared by every replica of an engine fleet: the
    ``HostBlockStore`` plus the prompt-keyed prefix map all replicas demote
    into, publish through and promote from — a system prompt prefilled by
    any replica warms the whole fleet. Also the transfer lane of prefill→
    decode handoffs (a ``SwapHandle``'s host blocks are held here between
    the source replica's swap-out and the destination's swap-in).

    Coherence: the fleet's ticks are single-threaded, so map mutations are
    serialized; the async hazard is one replica's ``SwapStream`` writes
    still in flight when *another* replica reads or frees a host block —
    every replica registers its drain on ``store.drains`` and drains them
    all first (``PagedKV._drain_tier``)."""
    store: HostBlockStore
    prefix_map: Dict[bytes, int] = dataclasses.field(default_factory=dict)
    prefix_keys: Dict[int, Tuple[bytes, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    #: prefix key -> replica that wrote it (write-through publish / demote)
    writer: Dict[bytes, Any] = dataclasses.field(default_factory=dict)
    #: promotions of a prefix some *other* replica wrote: the cross-replica
    #: warm hits the shared store exists for
    cross_hits: int = 0

    @classmethod
    def build(cls, cfg: ArchConfig, opts, block_size: int, host_blocks: int,
              kv_dtype: str = "bf16", *, device) -> "SharedHostTier":
        """A store with the geometry ``PagedKV`` would build for itself, so
        replicas made from the same (cfg, opts, block_size, kv_dtype)
        attach to it interchangeably; pinned when ``device`` is a GPU (the
        replicas' tier copies run only through page-locked memory)."""
        pin = torch.device(device).type == "cuda"
        return cls(store=_host_store(cfg, opts, block_size, host_blocks,
                                     kv_dtype, pin))


def _pinned_copy(t: torch.Tensor, non_blocking: bool) -> torch.Tensor:
    """A device tensor's copy in fresh pinned host memory (raw bytes, so
    fp8 codes move exactly)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    raw(out).copy_(raw(t), non_blocking=non_blocking)
    return out


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


def _groups(cache: Cache, n_groups: int) -> List[Cache]:
    """The layers of each pattern position: port layer ``i`` is group
    ``i % n_groups``, row ``i // n_groups`` of JAX's stacked (L, ...)
    pools."""
    return [cache[g::n_groups] for g in range(n_groups)]


def export_chain(cache: Cache, blks: torch.Tensor, n_groups: int):
    """Gather a block chain out of the device pools in one pass: a tuple of
    {"k","v"} per pattern position, (L, n, bs, HKV, dh), plus {"ks","vs"}
    (L, n, HKV) when quantized — JAX's ``build_chain_export_fn``. The
    result is *fresh* tensors (the pools may be overwritten at once), the
    codes of quantized pools moved as raw bytes."""
    idx = blks.long()
    out = []
    for layers in _groups(cache, n_groups):
        kv = {}
        for name, src in (("k", "kp"), ("v", "vp"), ("ks", "ks"),
                          ("vs", "vs")):
            if src not in layers[0]:
                continue
            p = layers[0][src]
            t = torch.empty((len(layers), idx.numel()) + p.shape[1:],
                            dtype=p.dtype, device=p.device)
            for i, g in enumerate(layers):
                torch.index_select(raw(g[src]), 0, idx, out=raw(t)[i])
            kv[name] = t
        out.append(kv)
    return tuple(out)


def import_chain(cache: Cache, kvs, blks: torch.Tensor) -> None:
    """Scatter a chain (``export_chain``'s form) into the pools at ``blks``,
    in place: the host→device half of swap-in, promotion and warm start
    (JAX's ``build_chain_import_fn``). Codes and scales are overwritten
    whole, so a resumed quantized block is bit-exact."""
    idx = blks.long()
    n_groups = len(kvs)
    for layers, kv in zip(_groups(cache, n_groups), kvs):
        for name, dst in (("k", "kp"), ("v", "vp"), ("ks", "ks"),
                          ("vs", "vs")):
            if dst not in layers[0]:
                continue
            for i, g in enumerate(layers):
                src = kv[name][i]
                if src.dtype != g[dst].dtype:
                    src = src.to(g[dst].dtype)
                raw(g[dst]).index_copy_(0, idx, raw(src))


def set_pos(cache: Cache, slot: int, pos: int) -> None:
    """Restore one slot's device position after a swap-in (the scatter sets
    it at admission; a swap-in bypasses admission)."""
    for g in cache:
        g["pos"][slot] = pos


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
                 spec: bool = False, host_blocks: Optional[int] = 0,
                 warm_start: Optional[str] = None, async_swap: bool = True,
                 shared_host: Optional[SharedHostTier] = None, shard=None):
        _check_pageable(cfg, "PagedKV")
        self.cfg, self.params, self.opts = cfg, params, opts
        # under a mesh (a ServeShard): cfg and params are this rank's; the
        # pools and the host tier hold its KV heads, every slot is computed
        # on every data rank (the block axis is not split), and every rank
        # takes the same block decisions over one logical block table
        self.shard = shard
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
        self.swap_out_blocks = 0
        self.swap_in_blocks = 0
        self.bytes_moved = 0          # every block crossing the tier boundary
        self.prefix_demotions = 0
        self.prefix_promotions = 0
        self.restored_entries = 0
        self.swap_fails = 0           # tier moves that fell back to recompute
        self.stream_transfers = 0     # async transfers completed at drains
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.prefetch_cancels = 0
        self.prefix_publishes = 0     # write-through copies to a shared tier
        # chunked: nodes whose blocks the next serve program writes, to be
        # published once it is dispatched
        self._pending_publish: List[_Node] = []
        #: fleet replica id (the fleet stamps it); feeds the shared tier's
        #: writer map so cross-replica warm hits are countable
        self.owner: Any = None
        # one block across all layers: K and V codes plus, when quantized,
        # their (HKV,) f32 scales (``paging.py:783-793``); the raw bytes are
        # what it decodes to in the activation dtype
        self._block_bytes = sum(
            2 * g["kp"][0].numel() * g["kp"].element_size()
            + (2 * g["ks"][0].numel() * g["ks"].element_size()
               if "ks" in g else 0)
            for g in self.cache)
        act_size = torch.empty((), dtype=opts.dtype).element_size()
        self._raw_block_bytes = sum(2 * g["kp"][0].numel() * act_size
                                    for g in self.cache)

        # -- the host tier ---------------------------------------------------
        # host_blocks: 0 disables it; None sizes it like the device pool
        # (the swap-preemption default); warm_start grows it to fit the
        # file. On a GPU its tensors are pinned. A SharedHostTier overrides
        # all of that: the store and the prefix maps are the fleet's.
        self.groups = len(cfg.block_pattern)
        self.shared = shared_host
        if shared_host is not None:
            st = shared_host.store
            group = (cfg.num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
            if (st.block_size != block_size or st.k is None
                    or len(st.k) != self.groups
                    or tuple(st.k[0].shape[:1] + st.k[0].shape[2:]) != group
                    or st.k[0].dtype != self.cache[0]["kp"].dtype
                    or (st.ks is None) != (kv_dtype == "bf16")):
                raise ValueError(
                    "shared host tier geometry does not match this replica "
                    "(build it via SharedHostTier.build from the same cfg/"
                    "opts/block_size/kv_dtype)")
            self.host: Optional[HostBlockStore] = st
            self.host_map: Dict[bytes, int] = shared_host.prefix_map
            self.host_keys: Dict[int, Tuple[bytes, np.ndarray]] = \
                shared_host.prefix_keys
        else:
            if host_blocks is None:
                host_blocks = num_blocks
            if warm_start:
                with np.load(warm_start) as data:
                    host_blocks = max(host_blocks, int(data["n"]))
            self.host = None
            if host_blocks > 0:
                self.host = _host_store(cfg, opts, block_size, host_blocks,
                                        kv_dtype,
                                        pin=self.device.type == "cuda")
            self.host_map = {}        # token-prefix key -> hblk
            self.host_keys = {}
        # the async swap stream: device→host chain transfers issued at
        # swap-out/demote time, completed at the engine's step boundaries
        # (``drain_swaps``); None = fully synchronous tier moves
        self.async_swap = bool(async_swap)
        self.stream: Optional[SwapStream] = None
        if self.host is not None:
            if self.device.type == "cuda":
                _require_pinned(self.host.tensors(), "PagedKV host tier")
            if self.async_swap:
                self.stream = SwapStream(self.host.write_chain,
                                         device=self.device)
                self.host.drains.append(self.drain_swaps)

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
        if warm_start:
            self.restored_entries = self.restore(warm_start)

    # -- allocation ---------------------------------------------------------

    def _alloc(self, zero: bool = True) -> Optional[int]:
        """A free device block, evicting (and demoting) LRU index blocks
        when the pool is dry. ``zero=False`` skips the quantized pools'
        scrub for a block an ``import_chain`` overwrites whole (codes and
        scales) before anything reads it: swap-in and promotion."""
        blk = self.pool.alloc()
        if blk is None and self.index.evict(self.pool, 1,
                                            on_evict=self._demote):
            blk = self.pool.alloc()
        if blk is not None and zero and self.kv_dtype != "bf16":
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

    # -- the host tier: demotion / promotion / swap -------------------------

    def _blk_tensor(self, blks: List[int]) -> torch.Tensor:
        return torch.as_tensor(blks, dtype=torch.long).to(self.device)

    def _export(self, blks: List[int]):
        return export_chain(self.cache, self._blk_tensor(blks), self.groups)

    def _to_host(self, kvs):
        """An exported chain in host memory, synchronously: pinned on a GPU
        (the synchronous tier path), the export itself on the CPU."""
        if self.device.type != "cuda":
            return kvs
        return tuple({n: _pinned_copy(t, non_blocking=False)
                      for n, t in kv.items()} for kv in kvs)

    def _read_host(self, hblks: List[int]):
        """Host blocks as staging for a host→device copy (pinned on a
        GPU)."""
        return self.host.read_chain(hblks, pin=self.device.type == "cuda")

    def _to_device(self, kvs):
        """Staged host blocks onto the device, non-blocking, in the
        current stream's order."""
        if self.device.type != "cuda":
            return kvs
        _require_pinned(_leaves(kvs), "host→device copy")
        return tuple({n: t.to(self.device, non_blocking=True)
                      for n, t in kv.items()} for kv in kvs)

    def _write_host(self, hblks: List[int], kvs, nbytes: int) -> None:
        """Send an exported chain to host blocks ``hblks``: issued on the
        swap stream (async), or copied and stored now (sync)."""
        if self.stream is not None:
            self.stream.issue(hblks, kvs, nbytes)
        else:
            self.host.write_chain(hblks, self._to_host(kvs))

    def _host_alloc(self) -> Optional[int]:
        """A free host block, evicting least-recently-touched *prefix map*
        entries to make room (swapped chains are held by their handles)."""
        if self.host is None:
            return None
        h = self.host.alloc()
        while h is None and self._host_evict_lru():
            h = self.host.alloc()
        return h

    def _drain_tier(self) -> None:
        """Complete every in-flight write into this host tier (every stream
        registered on ``host.drains``): the guard before any host-tier read
        and any free of a possibly-pending host block."""
        if self.host is None:
            return
        for drain in self.host.drains:
            drain()

    def _host_evict_lru(self) -> bool:
        # drain first: an entry picked here may still have its demote write
        # in flight — freeing (and reallocating) it before the deferred
        # write lands would corrupt the new owner's data
        self._drain_tier()
        cands = [(self.host.tick[h], h) for h in self.host_map.values()
                 if self.host.refs[h] == 1]
        if not cands:
            return False
        _, h = min(cands)
        key, _ = self.host_keys.pop(h)
        del self.host_map[key]
        if self.shared is not None:
            self.shared.writer.pop(key, None)
        self.host.free(h)
        return True

    def _raw_bytes_of(self, blocks: int):
        """``raw_bytes`` telemetry arg for a tier move of ``blocks`` blocks:
        None for the uncompressed control (wire bytes == logical bytes),
        else what the compressed blocks decode to."""
        if self.kv_dtype == "bf16":
            return None
        return blocks * self._raw_block_bytes

    def drain_swaps(self) -> int:
        """Complete every in-flight async device→host transfer (no-op when
        the stream is empty or the backend is synchronous). The engine
        calls this at step boundaries; internally it guards every host-tier
        read and every free of a possibly-pending host block. Returns the
        number of transfers completed."""
        if self.stream is None or not len(self.stream):
            return 0
        t, b, n = self.stream.drain()
        self.stream_transfers += t
        self.tel.swap_stream(t, b, n, self._raw_bytes_of(b))
        return t

    def _demote(self, node) -> None:
        """Device index eviction hook: copy the block's K/V into the host
        tier (keyed by its full token prefix) before the device block is
        freed, so an evicted shared prefix spills instead of dying. The
        export is a fresh tensor, so under async swap the device→host copy
        completes at the next drain and the device block is reusable at
        once."""
        if self.host is None:
            return
        h = self._host_alloc()
        if h is None:
            return                    # host tier held full: drop as before
        self._write_host([h], self._export([node.block]), self._block_bytes)
        tokens = self.index.node_tokens(node)
        key = tokens.tobytes()
        old = self.host_map.pop(key, None)
        if old is not None:           # stale duplicate: keep the fresh copy
            del self.host_keys[old]
            self.host.free(old)
        self.host_map[key] = h
        self.host_keys[h] = (key, tokens)
        self.host.touch(h)
        if self.shared is not None:
            self.shared.writer[key] = self.owner
        self.prefix_demotions += 1
        self.bytes_moved += self._block_bytes
        self.tel.demote(self._block_bytes, self._raw_bytes_of(1))

    def _publish(self, nodes: List[_Node]) -> None:
        """Write-through to a fleet-shared tier: copy freshly indexed prompt
        blocks host-side now (not only at eviction), so a prefix THIS
        replica prefilled warms every other replica's next admission. A
        prompt block's content is final once the index adopts it (decode
        writes land past the prompt; CoW forks shared blocks before any
        write), so the copy never goes stale. One chain export for all new
        blocks, issued on the swap stream (or copied now, synchronously).
        Keys another replica already published are skipped, and a tier
        held full publishes what fits. A private tier publishes nothing."""
        if self.shared is None or not nodes:
            return
        hblks: List[int] = []
        todo: List[Tuple[bytes, np.ndarray, _Node]] = []
        for node in nodes:
            tokens = self.index.node_tokens(node)
            key = tokens.tobytes()
            if key in self.host_map:  # another replica already published it
                continue
            h = self._host_alloc()
            if h is None:
                break                 # tier held full: publish what fits
            hblks.append(h)
            todo.append((key, tokens, node))
        if not hblks:
            return
        nbytes = len(hblks) * self._block_bytes
        self._write_host(hblks, self._export([n.block for _, _, n in todo]),
                         nbytes)
        for h, (key, tokens, _) in zip(hblks, todo):
            self.host_map[key] = h
            self.host_keys[h] = (key, tokens)
            self.host.touch(h)
            self.shared.writer[key] = self.owner
        self.prefix_publishes += len(hblks)
        self.bytes_moved += nbytes
        for _ in hblks:
            self.tel.demote(self._block_bytes, self._raw_bytes_of(1))

    def _promote(self, prompt: np.ndarray, matched: List[int]) -> List[int]:
        """Extend a device radix match with host-tier hits: take each
        matching host entry, copy the chain back into fresh device blocks
        in one import, and adopt it into the device index (so later
        admissions share on-device). Returns the promoted blocks,
        index-owned like ``PrefixIndex.match`` results.

        On a private tier the hits MOVE (the host entry is consumed); on a
        fleet-shared tier they COPY: the entry stays in the shared map for
        every other replica, held (``retain``) against LRU eviction by the
        allocations below, and a hit on a prefix another replica wrote
        counts as a cross hit."""
        if self.host is None or not self.host_map:
            return []
        for b in matched:             # pin against demote-eviction below
            self.pool.retain(b)
        P = int(prompt.shape[0])
        move = self.shared is None
        # take every consecutive host hit first, then allocate device
        # blocks in chain order, then move the whole chain in ONE import
        hits: List[Tuple[bytes, int]] = []     # (key, hblk), chain order
        i = len(matched)
        while (i + 1) * self.bs <= P:
            key = prompt[:(i + 1) * self.bs].tobytes()
            h = self.host_map.get(key)
            if h is None:
                break
            if move:
                del self.host_map[key]
                del self.host_keys[h]
            else:
                self.host.retain(h)   # a second ref: LRU eviction skips it
            hits.append((key, h))
            i += 1
        out: List[int] = []
        for j, (key, h) in enumerate(hits):
            b = self._alloc(zero=False)       # the import overwrites it
            if b is None:             # device dry: put unplaced entries back
                for key2, h2 in hits[j:]:
                    if move:
                        ntok = len(key2) // prompt.itemsize
                        self.host_map[key2] = h2
                        self.host_keys[h2] = (key2, prompt[:ntok].copy())
                    else:
                        self.host.free(h2)       # just drop the hold
                del hits[j:]
                break
            out.append(b)
        if out:
            # pending demote / publish writes may target hits — on a shared
            # tier, on another replica's stream
            self._drain_tier()
            kvs = self._to_device(self._read_host([h for _, h in hits]))
            import_chain(self.cache, kvs, self._blk_tensor(out))
            for key, h in hits:
                self.host.free(h)     # move: releases; copy: drops the hold
                if not move:
                    self.host.touch(h)
                    if self.shared.writer.get(key, self.owner) != self.owner:
                        self.shared.cross_hits += 1
            self.prefix_promotions += len(out)
            self.bytes_moved += len(out) * self._block_bytes
            for _ in out:
                self.tel.promote(self._block_bytes, self._raw_bytes_of(1))
            self.index.insert(prompt, matched + out,
                              len(matched) + len(out), self.pool)
            for b in out:             # hand ownership to the index
                self.pool.free(b)
        for b in matched:             # drop the pins
            self.pool.free(b)
        return out

    def _match_resident(self, prompt: np.ndarray) -> List[int]:
        """The full resident prefix chain for a prompt: the device radix
        match extended by host-tier promotion."""
        matched = self.index.match(prompt)
        return matched + self._promote(prompt, matched)

    def swap_out(self, slot: int) -> Optional[SwapHandle]:
        """Copy the slot's chain into the host tier and release its device
        memory; the returned handle resumes it via ``swap_in`` without
        re-prefill. None when there is no host tier or it is held full —
        the engine falls back to recompute (``swap_fail``).

        The whole chain moves as ONE export; under async swap its copy is
        issued on the stream (the export is a fresh tensor, so the device
        blocks are released at once) and completes at the next drain. Host
        blocks are allocated here either way, so refcounts are those of
        the synchronous path."""
        if self.host is None:
            return None
        chain = self.chains.get(slot)
        if chain is None:
            return None
        hblks: List[int] = []
        for _ in chain.blocks:
            h = self._host_alloc()
            if h is None:
                for hb in hblks:
                    self.host.free(hb)
                self.swap_fails += 1
                self.tel.swap_fail(slot, len(chain.blocks), "swap_out")
                return None
            hblks.append(h)
        nbytes = len(hblks) * self._block_bytes
        if hblks:
            self._write_host(hblks, self._export(chain.blocks), nbytes)
        # copies: the keys row and the prompt map are updated in place by
        # every later program and admission
        handle = SwapHandle(
            hblks=hblks, pos=int(self.pos_host[slot]),
            key=self.keys[slot].clone(),
            prompt=self.prompts.get(slot) if self.chunked else None)
        self.swap_out_blocks += len(hblks)
        self.bytes_moved += nbytes
        self.tel.swap_out(slot, len(hblks), nbytes,
                          self._raw_bytes_of(len(hblks)))
        self.release(slot)
        return handle

    def drop_swap(self, handle: SwapHandle) -> None:
        """Abandon a swapped-out sequence (its request will recompute):
        release the handle's host blocks, cancel any prefetched copy, and
        mark the handle unresumable — a later ``swap_in`` raises."""
        # drain first: the chain's own swap-out may still be in flight
        self._drain_tier()
        if handle.prefetch is not None:
            handle.prefetch = handle.prefetch_ready = None
            self.prefetch_cancels += 1
            self.tel.prefetch(len(handle.hblks), "cancel")
        for h in handle.hblks:
            self.host.free(h)
        handle.hblks = []
        handle.dropped = True

    def can_swap_in(self, handle: SwapHandle) -> bool:
        """Is there device memory to resume this chain now? (As
        ``has_room``: +1 for the next demand block, free blocks plus what
        LRU index eviction can reclaim.)"""
        need = min(len(handle.hblks) + 1, self.pool.num_blocks)
        if self.pool.n_free >= need:
            return True
        return need <= self.pool.n_free + self.index.n_evictable(self.pool)

    def prefetch_swap_in(self, handle: SwapHandle) -> bool:
        """Start the host→device copy of a swapped chain ahead of its
        swap-in (the engine calls this for the resume-head victim while the
        device runs the current step). On a GPU the copy runs on the swap
        stream's side stream and records an event that ``swap_in`` makes
        the current stream wait on. The handle keeps its host blocks, so no
        refcount moves: pure staging, a no-op on the synchronous path."""
        if (self.stream is None or handle.dropped or not handle.hblks
                or handle.prefetch is not None):
            return False
        self._drain_tier()            # its swap-out may be in flight
        staged = self._read_host(handle.hblks)
        if self.device.type == "cuda":
            side = self.stream.side_stream()
            with torch.cuda.stream(side):
                handle.prefetch = self._to_device(staged)
                handle.prefetch_ready = torch.cuda.Event()
                handle.prefetch_ready.record(side)
        else:
            handle.prefetch = staged
        self.prefetch_issued += 1
        self.tel.prefetch(len(handle.hblks), "issued")
        return True

    def swap_in(self, slot: int, handle: SwapHandle) -> bool:
        """Restore a swapped-out chain into ``slot``: one host→device chain
        copy into fresh blocks (or the handle's prefetched copy), then the
        slot's table, position and sampling-chain row. False = device pool
        dry (the caller gates with ``can_swap_in``; ``swap_fail`` fires).
        Raises on a handle that ``drop_swap`` already released."""
        if handle.dropped:
            raise RuntimeError(
                "swap_in on a dropped SwapHandle: drop_swap already "
                "released its host blocks (the request must recompute)")
        dblks: List[int] = []
        for _ in handle.hblks:
            b = self._alloc(zero=False)       # the import overwrites it
            if b is None:
                for db in dblks:
                    self.pool.free(db)
                self.swap_fails += 1
                self.tel.swap_fail(slot, len(handle.hblks), "swap_in")
                return False
            dblks.append(b)
        if dblks:
            kvs = handle.prefetch
            if kvs is not None:
                if handle.prefetch_ready is not None:
                    # fence: the import reads what the side stream wrote,
                    # and the side stream's memory must outlive the import
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(handle.prefetch_ready)
                    for t in _leaves(kvs):
                        t.record_stream(cur)
                handle.prefetch = handle.prefetch_ready = None
                self.prefetch_hits += 1
                self.tel.prefetch(len(dblks), "hit")
            else:
                self._drain_tier()    # its swap-out may be in flight
                kvs = self._to_device(self._read_host(handle.hblks))
            import_chain(self.cache, kvs, self._blk_tensor(dblks))
        for h in handle.hblks:
            self.host.free(h)
        handle.hblks = []
        handle.dropped = True         # consumed: a second resume is a bug
        self.chains[slot] = BlockTable(dblks)
        self.tables_host[slot, :] = self.trash
        self.tables_host[slot, :len(dblks)] = dblks
        self.pos_host[slot] = handle.pos
        set_pos(self.cache, slot, handle.pos)
        self.keys[slot] = handle.key
        if self.chunked and handle.prompt is not None:
            self.prompts[slot] = handle.prompt
        self.swap_in_blocks += len(dblks)
        self.bytes_moved += len(dblks) * self._block_bytes
        self.tel.swap_in(slot, len(dblks), len(dblks) * self._block_bytes,
                         self._raw_bytes_of(len(dblks)))
        return True

    # -- persistence --------------------------------------------------------

    def _fingerprint(self) -> str:
        """The cache-compatibility key: KV geometry only, byte for byte the
        JAX package's string. Parameter values are not covered: pair a
        cache file with the weights it was built from."""
        cfg = self.cfg if self.shard is None else self.shard.cfg
        return json.dumps({
            "arch": cfg.name, "layers": cfg.num_blocks,
            "groups": len(cfg.block_pattern),
            "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "block_size": self.bs,
            "dtype": str(self.opts.dtype).removeprefix("torch."),
            "kv_dtype": self.kv_dtype}, sort_keys=True)

    def save(self, path: str) -> int:
        """Persist every prefix block the hierarchy knows — host-tier
        entries plus the device radix index — keyed by prompt tokens and
        fingerprinted by config, in the JAX package's npz layout:
        ``tok_i`` and ``k_i_g``/``v_i_g`` of (L, bs, HKV, dh) per group,
        float32 for unquantized pools (lossless for fp32 and bf16); int8
        codes as int8 and fp8 codes as a uint8 view, with ``ks_i_g`` /
        ``vs_i_g`` beside them. Returns the number of entries written.
        Under a mesh every rank's heads are gathered into the file (its
        layout is the unsharded one), which rank 0 writes."""
        self._drain_tier()             # pending demote writes must land
        entries = []                   # (tokens, kvs)
        seen = set()
        for key, h in self.host_map.items():
            entries.append((self.host_keys[h][1], self.host.read(h)))
            seen.add(key)
        nodes = [n for n in self.index.walk()
                 if self.index.node_tokens(n).tobytes() not in seen]
        if nodes:
            chain = self._to_host(self._export([n.block for n in nodes]))
            for j, node in enumerate(nodes):
                entries.append((self.index.node_tokens(node),
                                tuple({n: t[:, j] for n, t in kv.items()}
                                      for kv in chain)))
        payload: Dict[str, Any] = {
            "fingerprint": np.array(self._fingerprint()),
            "n": np.int64(len(entries)),
        }
        specs = self._block_specs()
        for i, (tokens, kvs) in enumerate(entries):
            payload[f"tok_{i}"] = np.asarray(tokens, np.int32)
            if specs is not None:
                kvs = self._gather_heads(kvs, specs)
            for g, kv in enumerate(kvs):
                for name in ("k", "v"):
                    t = kv[name].cpu()
                    payload[f"{name}_{i}_{g}"] = (
                        t.float().numpy() if self.kv_dtype == "bf16"
                        else raw(t).numpy())
                if self.kv_dtype != "bf16":
                    for name in ("ks", "vs"):
                        payload[f"{name}_{i}_{g}"] = \
                            kv[name].cpu().float().numpy()
        if self.shard is None or self.shard.mesh.rank == 0:
            with open(path, "wb") as f:
                np.savez(f, **payload)
        if self.shard is not None:
            # no rank reads the file before rank 0 has written it
            self.shard.mesh.agree([len(entries)])
        return len(entries)

    def _block_specs(self):
        """The host tier's block specs when its heads are split over the
        model axis (``serve_swap_block_specs``), else None."""
        if self.shard is None or self.shard.tp.comm.size == 1:
            return None
        return self.shard.sharding.serve_swap_block_specs(self.cache)

    def _gather_heads(self, kvs, specs):
        """One block's per-group tensors with every rank's KV heads."""
        comm = self.shard.tp.comm
        out = []
        for kv, spec in zip(kvs, specs):
            g = {}
            for name, t in kv.items():
                if "model" not in spec[name]:
                    g[name] = t
                    continue
                # as raw bytes: exact for every storage type (codes too)
                dim = list(spec[name]).index("model")
                b = t.contiguous().view(torch.uint8).to(self.device)
                g[name] = comm.place(b, b.shape[dim] * comm.size,
                                     dim).cpu().view(t.dtype)
            out.append(g)
        return tuple(out)

    def restore(self, path: str) -> int:
        """Load persisted prefix blocks into the host tier (they promote to
        the device on the first radix hit — no re-prefill). Raises
        ``ValueError`` on a fingerprint mismatch; keeps what fits when the
        tier is smaller than the file. Returns the entries restored."""
        store = kv_quant.storage_dtype(self.kv_dtype, self.opts.dtype)
        specs = self._block_specs()
        with np.load(path) as data:
            fp = str(data["fingerprint"])
            if fp != self._fingerprint():
                raise ValueError(
                    f"prefix cache at {path!r} was saved under a different "
                    f"config: {fp} != {self._fingerprint()}")
            restored = 0
            for i in range(int(data["n"])):
                tokens = data[f"tok_{i}"].astype(np.int32)
                key = tokens.tobytes()
                if key in self.host_map:
                    continue
                # plain alloc: evicting earlier restored entries to admit
                # later ones would churn; a full tier keeps what fits
                h = self.host.alloc()
                if h is None:
                    break
                kvs = []
                for g in range(self.groups):
                    kv = {}
                    for name in ("k", "v"):
                        t = torch.from_numpy(np.ascontiguousarray(
                            data[f"{name}_{i}_{g}"]))
                        kv[name] = (t.view(store) if store ==
                                    torch.float8_e4m3fn else t.to(store))
                    if self.kv_dtype != "bf16":
                        for name in ("ks", "vs"):
                            kv[name] = torch.from_numpy(
                                data[f"{name}_{i}_{g}"].astype(np.float32))
                    kvs.append(kv)
                if specs is not None:   # this rank's heads of the file's
                    kvs = host_to_mesh(kvs, specs, self.shard.mesh)
                self.host.write(h, tuple(kvs))
                self.host_map[key] = h
                self.host_keys[h] = (key, tokens)
                self.host.touch(h)
                restored += 1
        return restored

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
        self._publish(self.index.insert(prompt, chain.blocks, P // self.bs,
                                        self.pool))
        self.chains[slot] = chain
        self.pos_host[slot] = P
        if key is not None:
            self.keys[slot] = key
        first, krow = self._sample(logits, self.keys[slot:slot + 1])
        self.keys[slot] = krow[0]
        return self._agree(first)

    def _agree(self, t: torch.Tensor) -> torch.Tensor:
        """A program output, data rank 0's on every rank (every data rank
        computed every slot)."""
        return t if self.shard is None else self.shard.merge_slots(t, False)

    def decode(self, next_tokens: torch.Tensor) -> torch.Tensor:
        tables = tensor(self.tables_host, self.device)
        self.cache, toks, self.keys = self._dec(self.params, self.cache,
                                                next_tokens, self.keys,
                                                tables)
        self.pos_host += self.K
        return self._agree(toks)

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
            # publish deferred until serve_step has dispatched the program
            # that writes these blocks: the insert runs at plan time
            self._pending_publish.extend(
                self.index.insert(prompt, chain.blocks, n_full, self.pool))
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
        toks, clen_t, start_t, reset, emit0, dec_mask_t, tables, scan = \
            operands((chunk_tokens, clen, start, reset, emit0, dec_mask,
                      self.tables_host, scan_tables), self.device, self.shard)
        self.cache, t0, seq, self.keys = self._serve(
            self.params, self.cache, toks, clen_t, start_t, reset, emit0,
            dec_tok, dec_mask_t, self.keys, tables, scan)
        t0, seq = self._agree(t0), self._agree(seq)
        self.pos_host[:] = (np.asarray(start, np.int64)
                            + np.asarray(clen, np.int64)
                            + self.K * dec_mask.astype(np.int64))
        if self._pending_publish:
            # enqueued after the program, the export reads what it wrote;
            # skip nodes a preemption or eviction replan removed meanwhile
            nodes, self._pending_publish = self._pending_publish, []
            self._publish([nd for nd in nodes
                           if self.index._by_block.get(nd.block) is nd])
        return t0, seq

    # -- speculative decode -------------------------------------------------

    def verify_step(self, tokens, clen, start, vmask):
        """One draft-widened verify program over the pools. Host positions
        do not move here: the engine commits each row by ``rollback(slot,
        start + n_emit)`` once it has read the accept counts."""
        toks, clen, start, vmask, tables = operands(
            (tokens, clen, start, vmask, self.tables_host), self.device,
            self.shard)
        self.cache, out, n_emit, self.keys = self._verify(
            self.params, self.cache, toks, clen, start, vmask, self.keys,
            tables)
        return self._agree(out), self._agree(n_emit)

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
        u = {
            "kv_blocks_total": self.pool.num_blocks,
            "kv_block_size": self.bs,
            "kv_blocks_resident": self.pool.n_resident,
            "kv_blocks_hwm": self.pool.hwm,
            "kv_cow_forks": self.cow_forks,
            "kv_prefix_shared_tokens": self.prefix_shared_tokens,
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_block": self._block_bytes,
        }
        if self.host is not None:
            u.update({
                "kv_host_blocks_total": self.host.num_blocks,
                "kv_host_blocks_resident": self.host.n_resident,
                "kv_host_blocks_hwm": self.host.hwm,
                "kv_swap_out_blocks": self.swap_out_blocks,
                "kv_swap_in_blocks": self.swap_in_blocks,
                "kv_host_bytes_moved": self.bytes_moved,
                # uncompressed-equivalent traffic: every increment is a
                # whole-block multiple, so the ratio recovers the blocks
                "kv_host_bytes_moved_raw": (
                    (self.bytes_moved // self._block_bytes)
                    * self._raw_block_bytes if self._block_bytes else 0),
                "kv_prefix_demotions": self.prefix_demotions,
                "kv_prefix_promotions": self.prefix_promotions,
                "kv_prefix_publishes": self.prefix_publishes,
                "kv_host_shared": int(self.shared is not None),
                "kv_swap_fails": self.swap_fails,
                "kv_async_swap": int(self.stream is not None),
                "kv_stream_transfers": self.stream_transfers,
                "kv_prefetch_issued": self.prefetch_issued,
                "kv_prefetch_hits": self.prefetch_hits,
                "kv_prefetch_cancels": self.prefetch_cancels,
            })
        return u

    def reset_counters(self) -> None:
        self.cow_forks = 0
        self.prefix_shared_tokens = 0
        self.pool.hwm = self.pool.n_resident
        self.swap_out_blocks = 0
        self.swap_in_blocks = 0
        self.bytes_moved = 0
        self.prefix_demotions = 0
        self.prefix_promotions = 0
        self.prefix_publishes = 0
        self.swap_fails = 0
        self.stream_transfers = 0
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.prefetch_cancels = 0
        if self.host is not None:
            self.host.hwm = self.host.n_resident

    def drop_prefix_cache(self) -> int:
        """Evict every index-only block (e.g. to shed warmup residue before
        a timed run). Returns how many blocks were freed. A shared tier's
        prefix map is the fleet's to drop
        (``FleetEngine.drop_prefix_cache``)."""
        freed = self.index.evict(self.pool, self.pool.num_blocks)
        self.pool.hwm = self.pool.n_resident
        return freed

"""Device meshes of the port (``src/repro/launch/mesh.py``) over the
``torch.distributed`` world, and the rank launcher.

A ``Mesh`` has JAX's ``axis_names`` and ``shape`` mapping (so
``ArchSharding`` reads it unchanged), this rank's ``coords``, and one
process group per axis: the ranks that share every other coordinate
(each data row's model group, each model column's data group). Ranks are
laid out row-major over the axes: rank = data * model_size + model.
``mesh_shape`` makes a mesh of the shape alone (no process), which the
partition rules and their tests use; ``make_host_mesh`` and
``make_serve_mesh`` need ``torch.distributed`` initialised with one rank
a mesh position, which ``spawn`` does.

``spawn(entry, "data,model", device, ...)`` starts ``data * model`` rank
processes (``torch.multiprocessing``, start method ``spawn``) over a
``FileStore``, calls ``entry(mesh, *args)`` in each and returns every
rank's result (``out[r]`` rank ``r``'s). The backend is chosen, never
tried: NCCL when the ranks run on CUDA and each owns its own card, gloo
otherwise (ranks on the CPU, or sharing one card: with a single card
every rank runs on ``cuda:0``). The process group has a timeout, so a
rank whose collectives diverge fails with an error instead of hanging,
and a rank that fails ends the others and raises in the caller.
"""
from __future__ import annotations

import datetime
import itertools
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.comm import AxisComm


def parse_mesh_spec(spec) -> Optional[Tuple[int, int]]:
    """``"data,model"`` string (e.g. ``"1,2"``) -> (data, model) ints.
    None for None/empty/"1,1": the single-device path."""
    if not spec:
        return None
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) != 2:
        raise ValueError(f"--mesh wants 'data,model' (got {spec!r})")
    data, model = int(parts[0]), int(parts[1])
    if data < 1 or model < 1:
        raise ValueError(f"--mesh axes must be >= 1 (got {spec!r})")
    if data == model == 1:
        return None
    return data, model


def mesh_device_count(spec) -> int:
    """Ranks a ``--mesh data,model`` spec needs (1 for the single-device
    path). Pure string parsing."""
    parsed = parse_mesh_spec(spec)
    if parsed is None:
        return 1
    data, model = parsed
    return data * model


class Mesh:
    """A (pod,) data, model mesh: ``axis_names``, ``shape`` (axis -> size),
    this rank's ``coords`` (axis -> index) and, over a live world, one
    ``AxisComm`` per axis and the ``device`` the rank computes on."""

    def __init__(self, shape: Dict[str, int], coords=None, comms=None,
                 world: Optional[AxisComm] = None, device="cpu",
                 backend: str = ""):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.coords = dict(coords) if coords else self.coords_of(0)
        self._comms = comms or {}
        self._world = world or AxisComm()
        self.device = torch.device(device)
        self.backend = backend

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    @property
    def rank(self) -> int:
        return self.rank_of(self.coords)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` (row-major over the axes)."""
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def at(self, rank: int) -> "Mesh":
        """The same shape seen from ``rank`` (no processes: for cutting a
        tree into every rank's pieces in one process)."""
        return Mesh(self.shape, self.coords_of(rank))

    def comm(self, axis: str) -> AxisComm:
        """Collectives over ``axis`` (the identity when its size is 1 or
        there is no live world)."""
        return self._comms.get(axis, AxisComm())

    @property
    def world(self) -> AxisComm:
        """Collectives over every rank (the broadcast root: rank 0)."""
        return self._world

    def agree(self, values: Sequence[int]) -> list:
        """Rank 0's integers on every rank (one broadcast over the world):
        how a decision that reads a clock reaches every rank."""
        if self.world.size == 1:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        return self.world.broadcast_(t).tolist()

    @property
    def shares_card(self) -> bool:
        """Whether every rank computes on one card: CUDA over gloo
        (``spawn`` puts every gloo rank on the card it is given; NCCL
        takes a card a rank)."""
        return self.device.type == "cuda" and self.backend == "gloo"

    def in_turn(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` on this rank. Where the ranks share a card
        (``shares_card``), in its turn, rank 0 first, each rank once the
        one before has returned (a world barrier a turn), so they build
        full weights and cut them to their pieces one at a time: the card
        holds one full copy at once. ``fn`` must issue no collective: the
        other ranks wait at a barrier meanwhile."""
        if not self.shares_card:
            return fn()
        out = None
        for r in range(self.size):
            if r == self.rank:
                out = fn()
            self.world.barrier()
        return out

    def describe(self) -> str:
        """"1x2", as the JAX engine reports a mesh."""
        return "x".join(str(self.shape[a]) for a in self.axis_names)


def mesh_shape(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """A mesh of this shape alone, seen from rank 0 (no processes)."""
    shape = {"pod": pod} if pod else {}
    shape.update(data=data, model=model)
    return Mesh(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (256 chips) or 2x16x16 (512 chips): the shape only."""
    return mesh_shape(16, 16, 2 if multi_pod else 0)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device="cuda") -> Mesh:
    """The mesh over the initialised ``torch.distributed`` world (one rank
    a position), with one process group per axis line, computing on
    ``device`` (``cuda`` unless the caller asks for the CPU). Every rank
    calls this, in the same order, since every rank takes part in making
    each group."""
    import torch.distributed as dist
    from repro_torch import resolve_device
    device = resolve_device(device)
    shape = mesh_shape(data, model, pod).shape
    probe = Mesh(shape)
    if not dist.is_initialized() or dist.get_world_size() != probe.size:
        raise ValueError(
            f"a {probe.describe()} mesh needs torch.distributed initialised "
            f"with {probe.size} ranks (repro_torch.launch.mesh.spawn)")
    rank = dist.get_rank()
    coords = probe.coords_of(rank)
    comms = {}
    for axis in probe.axis_names:
        if shape[axis] == 1:
            continue
        others = [a for a in probe.axis_names if a != axis]
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            line = [probe.rank_of({**dict(zip(others, fixed)), axis: i})
                    for i in range(shape[axis])]
            group = dist.new_group(line)
            if rank in line:
                comms[axis] = AxisComm(group, shape[axis], coords[axis],
                                       line[0], line)
    world = AxisComm(dist.group.WORLD, probe.size, rank, 0)
    return Mesh(shape, coords, comms, world, device=device,
                backend=dist.get_backend())


def make_serve_mesh(spec, device="cuda") -> Optional[Mesh]:
    """The serving mesh of a ``--mesh data,model`` flag over the live
    world; None when the spec is single-device."""
    parsed = parse_mesh_spec(spec)
    if parsed is None:
        return None
    return make_host_mesh(*parsed, device=device)


# The host→device placement of the KV tier's blocks, beside the mesh
# constructors as in JAX; it lives with the partition rules.
from repro_torch.sharding.rules import host_to_mesh  # noqa: E402,F401


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------

def choose_backend(device, world: int) -> str:
    """NCCL when the ranks run on CUDA and each owns a card; else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, entry: Callable, shape: Tuple[int, int],
               device: str, backend: str, tmp: str, timeout_s: float,
               args: Sequence[Any]) -> None:
    import torch.distributed as dist
    from repro_torch import resolve_device
    # one intra-op thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    data, model = shape
    world = data * model
    dev = torch.device(device)
    if dev.type == "cuda":
        # NCCL: a card a rank; gloo: every rank on the one card given
        resolve_device(dev)
        dev = torch.device("cuda", rank if backend == "nccl"
                           else dev.index or 0)
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_host_mesh(data, model, device=dev)
        out = entry(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(entry: Callable, mesh_spec, device="cuda", args: Sequence = (),
          *, timeout_s: float = 120.0,
          deadline_s: Optional[float] = None) -> list:
    """Run ``entry(mesh, *args)`` on every rank of a ``data,model`` mesh
    on ``device`` (``cuda`` unless the caller asks for the CPU; ``cuda``
    without a GPU raises here, before any rank starts) and return the
    ranks' results in rank order. ``entry`` and ``args`` must pickle (a
    module-level function). ``timeout_s`` bounds each collective; past
    ``deadline_s`` (None: no bound) the ranks are killed and this raises
    ``TimeoutError``. A rank that raises ends the others and re-raises
    here."""
    import torch.multiprocessing as mp
    from repro_torch import resolve_device
    parsed = parse_mesh_spec(mesh_spec)
    if parsed is None:
        raise ValueError(f"spawn needs a mesh of more than one rank (got "
                         f"{mesh_spec!r})")
    device = resolve_device(device)
    world = parsed[0] * parsed[1]
    backend = choose_backend(device, world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(entry, parsed, str(device), backend, tmp,
                              timeout_s, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        start = time.monotonic()
        try:
            while not ctx.join(timeout=0.5):
                if (deadline_s is not None
                        and time.monotonic() - start > deadline_s):
                    raise TimeoutError(f"mesh {mesh_spec} ranks ran past "
                                       f"{deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

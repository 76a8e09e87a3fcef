"""Device meshes over torch devices and torch.distributed ranks.

The port of plutracer_tpu/parallel/mesh.py. A mesh is a (tiles, spp) grid
of positions; a position is (rank, device): the process that computes it
and the torch device it computes on. The grid lists every process's
devices in rank order (rank-major, as jax.devices() orders the devices of
a multi-process job), so every process of a job builds the same mesh and
knows which positions are its own. A device may repeat: ``[cpu] * 8`` is
eight positions on the CPU (the counterpart of JAX's virtual CPU
devices), ``[cuda:0] * 4`` four on one card.

``gather`` is the one collective: each process hands in its own
positions' partial results, and every process gets back every position's
partial, in mesh order. Reducing them in that order on every process
makes a result independent of how the positions are split over
processes: one process holding a (2, 2) mesh and two processes holding a
row each give the same bits.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("tiles", "spp")


class Position(NamedTuple):
    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tiles, spp) grid of positions, as built by the process `rank` of
    a job of `world` processes. `distributed`: built under an initialised
    process group, whose processes all-gather their partials (``gather``);
    otherwise this process holds every position."""

    grid: Tuple[Tuple[Position, ...], ...]
    rank: int = 0
    world: int = 1
    distributed: bool = False
    axis_names: Tuple[str, str] = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"tiles": len(self.grid), "spp": len(self.grid[0])}

    def local(self) -> List[Tuple[int, int, torch.device]]:
        """(ti, si, device) of every position this process computes, in
        mesh order."""
        return [(ti, si, pos.device) for ti, row in enumerate(self.grid)
                for si, pos in enumerate(row) if pos.rank == self.rank]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(caller: str) -> List[torch.device]:
    """Every visible CUDA device; raises without one (the CPU is used only
    when the caller lists it)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device is available; pass "
                           "devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def single(device) -> Mesh:
    """The 1x1 mesh of one device in this process, with no collective."""
    return spp_row([device])


def spp_row(devices: Sequence) -> Mesh:
    """The (1, len(devices)) mesh of this process's devices, with no
    collective: the JAX package's ("spp",) mesh of local devices that
    render_elastic spreads its passes over."""
    return Mesh((tuple(Position(0, _device(d)) for d in devices),))


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = AXES,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (tiles, spp) mesh over every process's devices: the JAX
    package's make_mesh(shape, axis_names, devices).

    `axis_names`: the mesh's axes, which must be ("tiles", "spp") (the
    port's meshes have only those); anything else, a list of devices
    passed in its place included, raises ValueError.
    `devices`: this process's devices, the same list on every process of
    the job (default: every visible card in a job of one process, the
    card of the rank's own index modulo the card count in a larger one:
    NCCL's one rank a card). The positions are every rank's devices in
    rank order, and the grid takes the first tiles * spp of them. The
    default shape puts every position on `tiles`. Raises ValueError when
    the shape needs more positions than there are, and RuntimeError
    without a card when no devices are given."""
    if not isinstance(axis_names, (tuple, list)) or tuple(axis_names) != AXES:
        raise ValueError(f"make_mesh: axis_names must be {AXES}, got {axis_names!r} "
                         "(pass the devices as devices=)")
    distributed = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed else (1, 0)
    if devices is not None:
        own = [_device(d) for d in devices]
        per_rank = [own] * world
    else:
        cards = visible_devices("make_mesh")
        per_rank = [cards] if world == 1 else [[cards[r % len(cards)]] for r in range(world)]
    positions = [Position(r, d) for r in range(world) for d in per_rank[r]]
    if shape is None:
        shape = (len(positions), 1)
    tiles, spp = (int(x) for x in shape)
    if tiles < 1 or spp < 1:
        raise ValueError(f"mesh shape {shape} must be positive")
    if tiles * spp > len(positions):
        raise ValueError(f"mesh shape {shape} needs {tiles * spp} devices, have {len(positions)}")
    grid = tuple(tuple(positions[t * spp:(t + 1) * spp]) for t in range(tiles))
    return Mesh(grid, rank, world, distributed)


# torch.distributed's own environment (env:// rendezvous, as torchrun sets it)
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator: Optional[str] = None, **kw) -> None:
    """Join a torch.distributed job: the JAX package's
    initialize_distributed(coordinator=None, **kw), call once a process.

    `coordinator`: "host:port" (a TCP rendezvous, tcp://host:port) or a
    URL that torch.distributed takes ("file://<path>", "tcp://host:port").
    Keywords: `num_processes` and `process_id` (jax.distributed's names)
    are the world size and this process's rank, taken from WORLD_SIZE and
    RANK when not given; the port's own `backend` ("gloo", the default:
    the CPU, or ranks sharing a card; "nccl": one rank a card, the rank's
    card becomes its current device) and `timeout` (seconds, default 120)
    on the rendezvous and on every collective, so a lost peer fails the
    job instead of hanging it. Any other keyword raises TypeError.

    Without a coordinator the rendezvous is torch.distributed's
    environment (env://) when MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
    RANK are all set; otherwise the call does nothing, as the JAX
    package's does on one host with no cluster."""
    unknown = set(kw) - {"num_processes", "process_id", "backend", "timeout"}
    if unknown:
        raise TypeError(f"initialize_distributed: unexpected keyword(s) {sorted(unknown)}")
    if coordinator is None:
        if not all(os.environ.get(v) for v in DIST_ENV):
            return
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    world, rank = kw.get("num_processes"), kw.get("process_id")
    world = os.environ.get("WORLD_SIZE") if world is None else world
    rank = os.environ.get("RANK") if rank is None else rank
    if world is None or rank is None:
        raise ValueError("initialize_distributed: a coordinator needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK in the environment)")
    world, rank = int(world), int(rank)
    backend = kw.get("backend", "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=kw.get("timeout", 120.0)))


def scene_replicas(scene, devices: Sequence) -> list:
    """The scene on each listed device, one copy a distinct device (the
    scene itself where it already lives there)."""
    copies, out = {}, []
    for d in devices:
        d = _device(d)
        if d not in copies:
            copies[d] = scene if scene.device == d else scene.to(d)
        out.append(copies[d])
    return out


def gather(mesh: Mesh, partials: Dict[Tuple[int, int], torch.Tensor], shape: Sequence[int],
           device) -> List[torch.Tensor]:
    """Every position's float32 partial of the given shape, in mesh order
    (ti-major), on `device`. `partials` holds this process's own positions
    by (ti, si). Under a process group every process all-gathers them:
    gloo through host tensors (its CUDA support is broadcast and all_reduce
    only), NCCL on `device`, which must be the rank's card."""
    order = [(ti, si) for ti in range(mesh.shape["tiles"]) for si in range(mesh.shape["spp"])]
    if not mesh.distributed:
        return [partials[p].to(device) for p in order]
    if dist.get_world_size() != mesh.world:
        raise RuntimeError(f"the mesh was built in a world of {mesh.world} processes, "
                           f"the process group has {dist.get_world_size()}")
    held = [[p for p in order if mesh.grid[p[0]][p[1]].rank == r] for r in range(mesh.world)]
    via = torch.device("cpu") if dist.get_backend() == "gloo" else torch.device(device)
    mine = torch.zeros((max(map(len, held)), *shape), dtype=torch.float32, device=via)
    for k, p in enumerate(held[mesh.rank]):
        mine[k] = partials[p]
    bufs = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(bufs, mine)
    where = {p: (r, k) for r in range(mesh.world) for k, p in enumerate(held[r])}
    return [bufs[where[p][0]][where[p][1]].to(device) for p in order]

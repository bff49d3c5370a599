"""Session-pool placement: a slot pool's rows split over device shards.

The serving pools shard their slot rows over a 1-D mesh, the logical
``"data"`` axis: B slots on D shards = B/D resident sessions per shard,
every slot row whole on exactly one shard.  Slot rows are independent, so
the placement is pure data parallelism with no cross-shard traffic in the
hot path.  The JAX package lays such a pool out with ``NamedSharding``
and runs it under ``shard_map``; the port keeps each shard's rows as a
tensor of their own on the shard's device (`Sharded`) and launches the
same kernels once per shard (`core.engine.fleet_spmd`).

  * `fleet_mesh` — the mesh: the first n visible cards, or an explicit
    device list in which a device may repeat (several shards on one card,
    or on the CPU).
  * `slot_pspec` / `pool_shardings` — a leaf's placement from its slot
    axis: an int splits the leaf along that axis, `SHARED` (any non-int)
    keeps it whole (pool-global state such as the fleet clock).  Slot s
    lives on shard ``s * D // B``, the contiguous blocks ``NamedSharding``
    gives.
  * `shard` / `gather` — a tree onto a mesh and back.  Only host
    boundaries gather: outputs to the host, `save_pool`, store round trips.

A replicated leaf is one tensor on the mesh's first device; `fleet_spmd`
hands each shard a copy on its own device (none where they share it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.checkpoint import manager as _ckpt

DATA = "data"


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D device mesh over the logical ``"data"`` axis: shard d lives
    on ``devices[d]`` (a device may hold several shards)."""

    devices: tuple

    axis_names = (DATA,)

    @property
    def shape(self) -> dict:
        return {DATA: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def fleet_mesh(num_devices: Optional[int] = None, device=None,
               devices=None) -> FleetMesh:
    """A 1-D mesh over the ``"data"`` axis for session pools.

    ``fleet_mesh(n)`` takes the first n visible cards (every card where
    ``n`` is None) and raises ValueError outside ``1 <= n <= visible``;
    ``device`` names the device type, the card where None (which raises
    where there is none; ``"cpu"`` has one device).

    ``fleet_mesh(devices=[...])`` takes an explicit list in which a device
    may repeat: several shards then sit on one device and share it.  That
    is how a CPU test runs D = 2 or 4 shards (the counterpart of XLA's
    forced host devices) and how one card holds a D = 4 pool.  Each device
    must exist: a card index past the visible ones raises.
    """
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("fleet_mesh needs at least one device")
        if num_devices is not None and int(num_devices) != len(devs):
            raise ValueError(f"fleet_mesh got {len(devs)} devices and "
                             f"num_devices={num_devices}")
        for d in devs:
            if d.type == "cuda":
                n_cards = (torch.cuda.device_count()
                           if torch.cuda.is_available() else 0)
                if (d.index or 0) >= n_cards:
                    raise ValueError(f"fleet_mesh: {d} is not visible "
                                     f"({n_cards} cards)")
        return FleetMesh(devs)
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fleet_mesh places shards on CUDA devices by default and "
                "none is available; pass device='cpu' or devices=[...]")
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device(kind)]
    n = len(visible) if num_devices is None else int(num_devices)
    if n < 1 or n > len(visible):
        raise ValueError(
            f"fleet_mesh needs 1 <= num_devices <= {len(visible)} (visible "
            f"devices), got {num_devices}")
    return FleetMesh(tuple(visible[:n]))


def slot_pspec(axis, name: str = DATA) -> tuple:
    """The partition spec placing a pool leaf's slot ``axis`` on mesh axis
    ``name``: ``(None,) * axis + (name,)``, or ``()`` (replicated) for any
    non-int (`serving.scheduler.SHARED`, None; a bool is never an axis)."""
    if isinstance(axis, bool) or not isinstance(axis, int):
        return ()
    return (None,) * axis + (name,)


class Sharded:
    """A tensor split along its slot ``axis`` into one piece per shard:
    piece d holds rows ``[d B/D, (d+1) B/D)`` on its shard's device.

    It stands for the whole tensor where a pool reads it as a leaf:
    ``shape`` (the whole shape), ``dtype``, ``device`` (the pieces'),
    ``numel``/``element_size``, and `select` / indexing along the slot axis,
    which return a view into the piece that holds the row, so the pools'
    in-place slot copies work on it unchanged.  `gather` concatenates it
    on one device."""

    __slots__ = ("pieces", "axis")

    def __init__(self, pieces, axis: int):
        self.pieces = list(pieces)
        self.axis = int(axis)
        first = self.pieces[0]
        for p in self.pieces:
            if p.shape != first.shape or p.dtype != first.dtype:
                raise ValueError("the pieces of a Sharded tensor must share "
                                 "their shape and dtype")

    @property
    def shape(self) -> torch.Size:
        s = list(self.pieces[0].shape)
        s[self.axis] *= len(self.pieces)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def device(self) -> tuple:
        return tuple(p.device for p in self.pieces)

    def numel(self) -> int:
        return sum(p.numel() for p in self.pieces)

    def element_size(self) -> int:
        return self.pieces[0].element_size()

    def select(self, dim: int, index: int) -> torch.Tensor:
        """Slot row ``index`` (a view into the piece that holds it)."""
        if dim != self.axis:
            raise ValueError(f"a Sharded tensor selects along its slot axis "
                             f"{self.axis}, not {dim}")
        per, index = self.pieces[0].shape[dim], int(index)
        if not 0 <= index < per * len(self.pieces):
            raise IndexError(f"row {index} out of range "
                             f"[0, {per * len(self.pieces)})")
        return self.pieces[index // per].select(dim, index % per)

    def __getitem__(self, index):
        if not isinstance(index, int) or self.axis != 0:
            raise TypeError("a Sharded tensor is indexed by one slot row "
                            "along a leading slot axis")
        return self.select(0, index)

    def gather(self, device="cpu") -> torch.Tensor:
        return torch.cat([p.to(device) for p in self.pieces], dim=self.axis)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"axis={self.axis}, shards={len(self.pieces)})")


class SlotSharding:
    """One pool leaf's placement on ``mesh``: its partition ``spec``
    (`slot_pspec`).  A leaf of a placement tree (not a dataclass, which
    `checkpoint.manager.flatten` would walk into)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: FleetMesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SlotSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        return f"SlotSharding(spec={self.spec}, shards={self.mesh.size})"

    @property
    def axis(self) -> Optional[int]:
        """The slot axis, or None for a replicated leaf."""
        return self.spec.index(DATA) if DATA in self.spec else None

    def place(self, x: torch.Tensor):
        """``x`` (a whole tensor on any device) split onto the mesh: a
        `Sharded` of contiguous pieces, or the tensor on the first device
        where replicated."""
        ax = self.axis
        if ax is None:
            return x.to(self.mesh.devices[0])
        return Sharded([local(x, ax, d, self.mesh).contiguous()
                        for d in range(self.mesh.size)], ax)


def pool_shardings(mesh: FleetMesh, axes, name: str = DATA):
    """`SlotSharding` tree for a slot pool, from its slot-axes tree (the
    tree `serving.scheduler.make_slot_ops` consumes: int leaves name the
    slot axis, anything else marks replicated pool-global state).  The
    one source of slot -> shard placement: slot s on shard ``s * D // B``.
    """
    return _ckpt.tree_map(lambda ax: SlotSharding(mesh, slot_pspec(ax, name)),
                          axes)


def shard(tree, shardings):
    """``tree`` (whole tensors) placed leaf by leaf by ``shardings``."""
    return _ckpt.unflatten(tree, [
        s.place(x) for x, s in zip(_ckpt.flatten(tree)[1],
                                   _ckpt.flatten(shardings)[1])])


def host(x, device="cpu"):
    """One leaf whole on ``device``: a `Sharded` gathered, a tensor
    moved."""
    return x.gather(device) if isinstance(x, Sharded) else x.to(device)


def gather(tree, device="cpu"):
    """``tree`` with every leaf whole on ``device`` (the host by
    default)."""
    return _ckpt.tree_map(lambda x: host(x, device), tree)


def local(x, axis, d: int, mesh: FleetMesh):
    """Shard ``d``'s part of one leaf: a `Sharded` leaf's piece; a whole
    tensor's ``d``-th block along ``axis`` (None: all of it) on the
    shard's device; anything else as it is."""
    if isinstance(x, Sharded):
        if axis is not None and x.axis != axis:
            raise ValueError(f"a leaf sharded along axis {x.axis} was "
                             f"mapped along axis {axis}")
        if len(x.pieces) != mesh.size:
            raise ValueError(f"a leaf of {len(x.pieces)} shards on a mesh "
                             f"of {mesh.size}")
        return x.pieces[d]
    if not isinstance(x, torch.Tensor):
        return x
    dev = mesh.devices[d]
    if axis is None:
        return x.to(dev)
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"{n} rows on axis {axis} do not divide over "
                         f"{mesh.size} shards")
    per = n // mesh.size
    return x.narrow(axis, d * per, per).to(dev)

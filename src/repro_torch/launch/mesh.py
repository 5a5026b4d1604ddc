"""Device meshes: a grid of torch devices with named axes.

Counterpart of `repro.launch.mesh`. The reference is single-controller:
one process drives `shard_map` over the local devices it sees. The port
keeps that model: one process holds a `Mesh` of ``torch.device`` entries,
each shard's block lives on its entry, and what crosses shards is a copy
between devices (a peer copy over NVLink when two entries differ). So a
node-sharded or seed-sharded run returns the same global state, and
checkpoints cross device counts, as the reference's do.

"Visible" devices: on CUDA, ``torch.cuda.device_count()``; an int asks for
that many distinct cards. The CPU counts as one device, and an int D builds
D shards on ``cpu`` — the counterpart of the reference's fake host devices
(``--xla_force_host_platform_device_count``), which the CPU tests need. A
prebuilt `Mesh` may repeat a device: a mesh of four shards on one card runs
the four-shard program (partition, padding, halo copies, the kernels per
shard) on that card.

The LM stack's production meshes (256 and 512 positions) cannot be held on
the one or four cards a machine here has: they are built of ``meta``
positions, which can be counted (shapes, `repro_torch.sharding` specs) but
not run. A CUDA mesh larger than the visible cards still raises. ``with
mesh:`` makes a mesh the active one for the sharding context managers of
`repro_torch.models`, which check the axes they name against it
(`repro_torch.sharding.rules.check_axis`).

>>> mesh = make_mesh((2, 3), ("seed", "node"), device="cpu")
>>> mesh.shape, mesh.axis_names, mesh.size
({'seed': 2, 'node': 3}, ('seed', 'node'), 6)
>>> node_mesh(4, device="cpu").shape
{'node': 4}
>>> node_mesh(1, device="cpu") is None, seed_mesh("auto", device="cpu")
(True, None)
>>> prod = make_production_mesh(multi_pod=True)
>>> prod.shape, prod.device_type, gossip_axes(prod), gossip_nodes(prod)
({'pod': 2, 'data': 16, 'model': 16}, 'meta', ('pod',), 2)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding import rules as shard_rules

__all__ = ["Mesh", "make_mesh", "seed_mesh", "node_mesh", "seed_node_mesh",
           "mesh_device", "make_production_mesh", "make_test_mesh",
           "gossip_axes", "gossip_nodes", "data_axes_for_batch"]


class Mesh:
    """Named axes over an array of torch devices (one per mesh position).

    ``shape`` maps each axis name to its size, in axis order, as a JAX
    mesh's does; ``devices`` is the numpy object array of
    ``torch.device``. Every entry has one device type; entries may repeat.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a Mesh of shape {arr.shape} needs "
                             f"{arr.ndim} distinct axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a Mesh needs at least one device")
        types = {d.type for d in arr.flat}
        if len(types) != 1:
            raise ValueError(f"a Mesh holds one device type, got "
                             f"{sorted(types)}")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def rows(self, axis: str) -> list[tuple]:
        """The devices along ``axis``, one tuple per position of the other
        axes (in their order): the shards of each row."""
        k = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, k, -1)
        return [tuple(row) for row in moved.reshape(-1, moved.shape[-1])]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")

    def __enter__(self) -> "Mesh":
        shard_rules._ACTIVE_MESH.append(self)
        return self

    def __exit__(self, *exc) -> None:
        shard_rules._ACTIVE_MESH.pop()


def _visible(device: str) -> int:
    """How many distinct devices of this type the process sees (the CPU
    is one)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _too_many(what: str, want: int, avail: int) -> ValueError:
    return ValueError(
        f"{what}: asked for {want} devices but only {avail} are visible; "
        f"to run the {want}-shard program on fewer cards, pass a prebuilt "
        f"Mesh that repeats a device, e.g. make_mesh(({want},), ('node',), "
        f"devices=['cuda:0'] * {want})")


def make_mesh(shape, axes, devices=None, *, device: str = "cuda") -> Mesh:
    """A `Mesh` of ``shape`` with axis names ``axes``.

    ``devices`` (a flat sequence in row-major order, repeats allowed) places
    the positions; without it they take the visible devices of type
    ``device``: distinct cards on CUDA (ValueError when there are fewer),
    ``cpu`` at every position on the CPU, ``meta`` (counted, not run) at
    every position for ``device="meta"``.
    """
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape))
    if devices is None and torch.device(device).type == "meta":
        devices = ["meta"] * size
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devices = ["cpu"] * size
        else:
            avail = _visible(device)
            if size > avail:
                raise _too_many("make_mesh", size, avail)
            devices = [f"cuda:{i}" for i in range(size)]
    flat = list(devices)
    if len(flat) != size:
        raise ValueError(f"make_mesh{shape} needs {size} devices, got "
                         f"{len(flat)}")
    arr = np.empty(size, dtype=object)
    arr[:] = [torch.device(d) for d in flat]
    return Mesh(arr.reshape(shape), axes)


def _count(what: str, devices, avail: int, device: str) -> int | None:
    """The shard count an int/"auto"/None asks for (None: unsharded)."""
    if devices == "auto":
        devices = avail
    devices = int(devices or 0)
    if devices <= 1:
        return None
    if resolve_device(device).type == "cuda" and devices > avail:
        raise _too_many(what, devices, avail)
    return devices


def seed_mesh(devices: int | str | None = "auto", *,
              device: str = "cuda") -> Mesh | None:
    """1-D ``("seed",)`` mesh for sharding `run_batch`'s seed axis.

    ``"auto"`` takes every visible device, an int asks for exactly that
    many (ValueError on CUDA when fewer are visible), ``None``, 0 or 1
    returns None — the caller's cue to stay on the one-device batch.
    """
    D = _count("seed_mesh", devices, _visible(device), device)
    return None if D is None else make_mesh((D,), ("seed",), device=device)


def node_mesh(devices: int | str | None = "auto", *,
              device: str = "cuda") -> Mesh | None:
    """1-D ``("node",)`` mesh for sharding the gossip node axis: the same
    rules as `seed_mesh`. Node shards are not independent: the sharded
    round copies neighbour blocks of theta~ between them
    (`repro_torch.api.shard_node`)."""
    D = _count("node_mesh", devices, _visible(device), device)
    return None if D is None else make_mesh((D,), ("node",), device=device)


def seed_node_mesh(seed_devices: int | None = 1,
                   node_devices: int | str | None = "auto", *,
                   device: str = "cuda") -> Mesh | None:
    """2-D ``("seed", "node")`` grid: independent seed rows x node columns.

    ``node_devices="auto"`` spreads what remains after the seed rows
    (visible // seed_devices); node_devices <= 1 returns None.
    """
    avail = _visible(device)
    s = int(seed_devices or 1) or 1
    if node_devices == "auto":
        node_devices = avail // s
    nd = int(node_devices or 0)
    if nd <= 1:
        return None
    if resolve_device(device).type == "cuda" and s * nd > avail:
        raise _too_many("seed_node_mesh", s * nd, avail)
    return make_mesh((s, nd), ("seed", "node"), device=device)


def mesh_device(mesh: Mesh, device: str | torch.device) -> torch.device:
    """The mesh's first device, where a sharded run keeps its global state:
    the mesh decides where each shard lives, so a ``device`` of another
    type raises, and so does a mesh of CUDA devices without CUDA."""
    want = torch.device(device)
    if mesh.device_type != want.type:
        raise ValueError(f"the mesh holds {mesh.device_type} devices but "
                         f"the run asked for device={str(want)!r}")
    for d in mesh.devices.flat:
        resolve_device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"the mesh names {d}, but only "
                             f"{torch.cuda.device_count()} CUDA devices "
                             "are visible")
    return mesh.devices.flat[0]


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "meta") -> Mesh:
    """Single pod: 256 positions (16, 16) = ("data", "model").
    Multi-pod: 512 positions (2, 16, 16) = ("pod", "data", "model");
    each pod is one gossip data center. ``meta`` positions by default (no
    machine here has the cards); ``device="cuda"`` asks for distinct cards
    and raises when fewer are visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_test_mesh(data: int = 4, model: int = 2, *,
                   device: str = "cuda") -> Mesh:
    """Small ("data", "model") mesh (``data * model`` shards of ``cpu``
    on the CPU)."""
    return make_mesh((data, model), ("data", "model"), device=device)


def gossip_axes(mesh) -> tuple[str, ...]:
    """Which mesh axes carry the gossip node dimension."""
    return ("pod",) if "pod" in mesh.axis_names else ("data",)


def gossip_nodes(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in gossip_axes(mesh)]))


def data_axes_for_batch(mesh) -> tuple[str, ...]:
    """Axes the *within-node* batch dim shards over."""
    return ("data",) if "pod" in mesh.axis_names else ()

"""Device meshes and sharding for the port: a grid of torch devices.

JAX's mesh is single-controller SPMD: one sharded array spans the
devices and XLA inserts the collectives. PyTorch has neither, so the
port holds each shard's state explicitly and moves data between devices
itself:

- `Mesh` is a grid of `torch.device`s with named axes — `[data, model]`
  from `make_mesh` (the reference's axis convention: batches shard over
  `data`, tenant rows over `model`). `dict(mesh.shape)` and `mesh.size`
  read as in JAX. A device may appear more than once: a logical device.
  That is how a CPU run stands in for the 8 virtual host devices XLA
  gives the JAX package (`--xla_force_host_platform_device_count`), and
  how one card carries a `{data: 2, model: 2}` mesh.
- A `Sharding` names, for each leading dimension of a tensor, the mesh
  axis it splits over (`None`: whole) — the `PartitionSpec` counterpart.
  `place` cuts a tensor into one block per mesh position, each on its
  position's device; positions whose blocks are the same slice on the
  same device share one tensor, so a replica written once is written
  for every position that holds it.
- Where the devices come from is explicit: `mesh_devices(device,
  cpu_devices)` lists every CUDA card for a card device, and
  `cpu_devices` logical copies of the CPU for the CPU (the instance's
  `cpu_mesh_devices`, 1 unless set). Nothing is read from the
  environment.

Multi-process: `parallel/distributed.py` builds a mesh whose `data`
axis spans the processes of a `torch.distributed` group; this process
holds its own rows of the grid (`process_count`, `process_index`).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A grid of torch devices with one name per axis.

    `devices` is this process's part of the grid; with a process group
    (`process_count` > 1) the first axis is the one that spans the
    processes, and `shape` reports its global size."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS,
                                                               MODEL_AXIS),
                 process_count: int = 1, process_index: int = 0):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        if len({d.type for d in flat}) > 1:
            raise ValueError(f"a mesh mixes device types: {flat}")
        self.axis_names = tuple(axis_names)
        self.process_count = int(process_count)
        self.process_index = int(process_index)

    @property
    def shape(self) -> dict[str, int]:
        sizes = list(self.devices.shape)
        sizes[0] *= self.process_count
        return dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def local_shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def first(self) -> torch.device:
        """Where assembled results land: the grid's first device."""
        return self.devices.flat[0]

    def positions(self) -> Iterable[tuple[int, ...]]:
        return np.ndindex(*self.devices.shape)

    def device(self, *pos: int) -> torch.device:
        return self.devices[pos]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        ax = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            index[ax] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{sorted({str(d) for d in self.devices.flat})}"
                + (f", process {self.process_index}/{self.process_count}"
                   if self.process_count > 1 else "") + ")")


def mesh_devices(device=None, cpu_devices: int = 1) -> list[torch.device]:
    """The devices a mesh may span: every CUDA card when `device` is the
    card (None means the card, and raises without one), else
    `cpu_devices` logical copies of the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * max(int(cpu_devices), 1)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over `devices` (default: every card)."""
    devices = list(devices if devices is not None else mesh_devices())
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices):
        grid.flat[i] = torch.device(d)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def mesh_from_spec(spec: Optional[dict],
                   devices: Sequence) -> Optional[Mesh]:
    """Build the serving mesh from a `{data: D, model: M}` config spec
    over `devices`, degrading as the reference does to what is there:

    - exact fit (D×M == devices): the requested mesh;
    - fewer devices: shrink the model axis to the largest divisor of
      the device count ≤ M, data takes the rest (logged);
    - one device (or no/empty spec): None, the single-device stacked
      dispatch (logged when the spec asked for more).

    More devices than the spec asks for uses only D×M of them."""
    if not spec:
        return None
    model = max(int(spec.get("model", 1) or 1), 1)
    data = spec.get("data")
    devices = list(devices)
    n = len(devices)
    if n <= 1:
        if int(spec.get("data") or 1) * int(spec.get("model") or 1) > 1:
            # a spec collapsing all the way to meshless must be loud, or
            # an A/B's "mesh on" leg can silently measure the off one
            logger.warning(
                "scoring mesh spec %s: this process has %d device(s) — "
                "running meshless (single-device stacked dispatch)",
                spec, n)
        return None
    want = (int(data) if data else max(n // model, 1)) * model
    if want > n:
        model = min(model, n)
        while n % model:
            model -= 1
        logger.warning(
            "scoring mesh spec %s wants %d devices, have %d — fitting "
            "{data: %d, model: %d}", spec, want, n, n // model, model)
        return make_mesh(data=n // model, model=model, devices=devices)
    return make_mesh(data=want // model, model=model,
                     devices=devices[:want])


# -- sharding ------------------------------------------------------------------


@dataclass(frozen=True)
class Sharding:
    """For each leading dim, the mesh axis it splits over (None: whole);
    trailing dims past `spec` are whole."""

    mesh: Mesh
    spec: tuple = ()


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int = 2) -> Sharding:
    """Shard the leading (batch) dim over `data`, replicate the rest."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def tenant_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard the leading (tenant) dim over `model`."""
    return Sharding(mesh, (MODEL_AXIS,) + (None,) * (ndim - 1))


def megabatch_sharding(mesh: Mesh, ndim: int = 2) -> Sharding:
    """The pooled `[T_cap, B, ...]` megabatch inputs: tenant rows over
    `model` (co-sharded with the stacked params and rings), batch
    columns over `data`."""
    return Sharding(mesh, (MODEL_AXIS, DATA_AXIS) + (None,) * (ndim - 2))


def block_slices(sharding: Sharding, shape: Sequence[int],
                 pos: tuple[int, ...]) -> tuple[slice, ...]:
    """The slice of a tensor of `shape` that mesh position `pos` holds."""
    mesh = sharding.mesh
    local = mesh.local_shape
    out = []
    for dim, axis in enumerate(sharding.spec):
        if axis is None:
            out.append(slice(None))
            continue
        parts = local[axis]
        if shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{parts} ways over `{axis}`")
        step = shape[dim] // parts
        i = pos[mesh.axis_names.index(axis)]
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def _key(slices) -> tuple:
    return tuple((s.start, s.stop) for s in slices)


class Sharded:
    """A tensor held as one block per mesh position (a JAX array with a
    NamedSharding): `blocks[pos]` is that position's slice, on its
    device; positions with the same slice on the same device share one
    tensor."""

    def __init__(self, blocks: dict, sharding: Sharding,
                 shape: Sequence[int]):
        self.blocks = blocks
        self.sharding = sharding
        self.shape = tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (the mesh's first by default)."""
        device = self.sharding.mesh.first if device is None else device
        first = next(iter(self.blocks.values()))
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        for pos, block in self.blocks.items():
            out[block_slices(self.sharding, self.shape, pos)] = \
                block.to(device)
        return out


def assemble(mesh: Mesh, blocks: dict, shape: Sequence[int],
             device=None) -> torch.Tensor:
    """The whole `shape` tensor from per-position blocks sharded tenant
    rows over `model` and columns over `data` (`megabatch_sharding`), on
    `device` (the mesh's first by default)."""
    return Sharded(blocks, megabatch_sharding(mesh, len(shape)),
                   shape).gather(device)


def place(x, sharding: Sharding) -> Sharded:
    """Cut `x` (a tensor or an array) into its blocks, each on its
    position's device."""
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    shared: dict = {}
    blocks = {}
    for pos in mesh.positions():
        sl = block_slices(sharding, x.shape, pos)
        dev = mesh.device(*pos)
        key = (_key(sl), dev)
        if key not in shared:
            # a block on x's own device may be a view of x
            shared[key] = x[sl].to(dev).contiguous()
        blocks[pos] = shared[key]
    return Sharded(blocks, sharding, x.shape)


def tenant_placer(mesh: Optional[Mesh]):
    """`place(leaf)` for tenant-stacked state: the leading (tenant) axis
    over `model`; with no mesh the leaf as it is (the stacked state is
    already on its one device)."""
    if mesh is None:
        return lambda leaf: leaf
    return lambda leaf: place(leaf, tenant_sharding(mesh, leaf.ndim))


def megabatch_placer(mesh: Optional[Mesh]):
    """`place(leaf)` for megabatch dispatch inputs — `torch.as_tensor`
    with no mesh, tenant rows over `model` and columns over `data`
    otherwise."""
    if mesh is None:
        return torch.as_tensor
    return lambda leaf: place(leaf, megabatch_sharding(mesh, leaf.ndim))


def split_blocks(x: torch.Tensor, devices: Sequence[torch.device],
                 dim: int = 1) -> list[torch.Tensor]:
    """`x` cut into len(devices) equal blocks along `dim`, block i on
    devices[i] (a time axis for ring attention, a node axis for the
    GNN)."""
    if x.shape[dim] % len(devices):
        raise ValueError(f"{x.shape[dim]} entries of dim {dim} do not "
                         f"split over {len(devices)} devices")
    return [b.to(d) for b, d in zip(x.chunk(len(devices), dim), devices)]


def shard_batch(mesh: Mesh, *arrays):
    """Pad each array's leading dim to a multiple of the data axis and
    place it sharded over `data`. Returns (sharded..., original_n)."""
    d = mesh.local_shape[DATA_AXIS]
    n = arrays[0].shape[0]
    padded = ((n + d - 1) // d) * d
    out = []
    for a in arrays:
        a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        if padded != n:
            a = torch.cat([a, a.new_zeros((padded - n, *a.shape[1:]))])
        out.append(place(a, batch_sharding(mesh, a.ndim)))
    return (*out, n)


# -- per-position trees (the stacked params and the rings' inputs) --------------


def place_tree(tree, placer, mesh: Mesh) -> dict:
    """`{pos: tree}`: every leaf of `tree` cut by `placer(leaf)` (a
    `Sharded`), one tree a mesh position. Positions that hold the same
    blocks share the same tree object. Autograd follows the cut: a block
    is a differentiable slice and copy of its leaf."""
    placed = tree_map(placer, tree)
    out: dict = {}
    by_blocks: dict = {}
    for pos in mesh.positions():
        sub = tree_map(lambda s: s.blocks[pos], placed,
                       is_leaf=lambda v: isinstance(v, Sharded))
        key = tuple(id(t) for t in
                    torch.utils._pytree.tree_leaves(sub))
        out[pos] = by_blocks.setdefault(key, sub)
    return out


def model_index(mesh: Mesh, pos: tuple[int, ...]) -> int:
    return pos[mesh.axis_names.index(MODEL_AXIS)]


def column_replicas(mesh: Mesh, items: dict, m: int) -> list:
    """The distinct objects that positions of model column `m` hold."""
    out: list = []
    for pos, item in items.items():
        if model_index(mesh, pos) == m and all(item is not o for o in out):
            out.append(item)
    return out

"""Meshes of devices, sharded tensors and the record of their collectives
(counterpart of troy_tpu/parallel/mesh.py).

The JAX package's mesh is single-controller GSPMD: arrays carry a
NamedSharding and XLA partitions one jitted step and inserts the
collectives.  PyTorch has no such partitioner over hand-written kernels, so
here the partition is explicit (parallel/partition.py) and this module holds
its vocabulary, with the JAX module's names:

  * Mesh: an ndarray of torch.device with named axes ('data', 'limb'),
    ('host', 'data', 'limb') or ('poly',).  A device may repeat:
    [torch.device("cpu")] * 8 stands for XLA's eight virtual host devices,
    [cuda:0] * k for k shards on one card.  Each mesh device belongs to a
    process rank (make_multihost_mesh maps 'host' to torch.distributed
    ranks); a process holds only its own shards.
  * Sharding / ShardedTensor: a spec of per-axis mesh-axis names, as
    PartitionSpec, and one contiguous local shard per mesh device, on that
    device.  An axis that does not divide is split unevenly, the first shards
    larger, so per_device_bytes is JAX's ceil.  ShardedTensor.gather()
    assembles the whole tensor; reading a result is not a collective.
  * CollectiveRecord: every cross-shard copy a plan issues, by kind
    ('all-gather', 'broadcast', 'all-to-all') with the bytes delivered to
    the receiving shards (a fast-path residue crosses as a 32-bit word, a
    wide one as 64 bits), and per shard the stage calls and kernel launches
    it ran.  A sharded result carries the record of the work that made it;
    recording() collects everything inside a with block.
    collective_stats(record) returns the JAX function's {"counts", "total",
    "approx_bytes"}.

Axes: 'data' (and 'host') split the ciphertext batch, with no collective at
all; 'limb' splits the RNS limbs, with collectives only where a stage mixes
limbs; 'poly' splits the coefficients, with an all-to-all around each NTT.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _rank() -> int:
    """This process's torch.distributed rank (0 without a process group)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _default_devices() -> list:
    """Every CUDA card of this process."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """devices: an ndarray of torch.device, one axis per name; ranks: the
    owning process of each (zeros: all this process's)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, ranks: np.ndarray | None = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = np.zeros(devices.shape, dtype=np.int64) if ranks is None else ranks

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def is_local(self, i: int) -> bool:
        """Whether flat mesh position i belongs to this process."""
        return int(self.ranks.flat[i]) == _rank()


def _device_array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return arr.reshape(shape)


def make_mesh(data: int | None = None, limb: int = 1, devices: list | None = None) -> Mesh:
    """A (data, limb) mesh over the devices (default: every CUDA card)."""
    devs = devices if devices is not None else _default_devices()
    if data is None:
        data = len(devs) // limb
    if data * limb > len(devs):
        raise ValueError(f"[make_mesh] need {data * limb} devices, have {len(devs)}")
    return Mesh(_device_array(devs[: data * limb], (data, limb)), ("data", "limb"))


def make_multihost_mesh(hosts: int | None = None, limb: int = 1,
                        devices: list | None = None) -> Mesh:
    """A (host, data, limb) mesh.  Under torch.distributed (gloo on the CPU,
    NCCL on cards) 'host' is the rank: devices are this process's own (default:
    its CUDA cards), every rank passes as many, and a process holds only its
    own shards.  Without a process group the hosts are simulated by slicing
    the device list, as the JAX package's virtual CPU mesh does.  'limb'
    stays inside a host; batch parallelism across hosts moves no byte."""
    dist = torch.distributed
    devs = devices if devices is not None else _default_devices()
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        hosts = world if hosts is None else hosts
        if hosts != world:
            raise ValueError(f"[make_multihost_mesh] {hosts} hosts, but the process "
                             f"group has {world} ranks")
        data = len(devs) // limb
        if data < 1:
            raise ValueError(f"[make_multihost_mesh] need {limb} devices a host, "
                             f"have {len(devs)}")
        local = devs[: data * limb]
        arr = _device_array(local * hosts, (hosts, data, limb))
        ranks = np.repeat(np.arange(hosts), data * limb).reshape(hosts, data, limb)
        return Mesh(arr, ("host", "data", "limb"), ranks)
    hosts = hosts or 1
    data = len(devs) // hosts // limb
    if hosts * data * limb > len(devs) or data < 1:
        raise ValueError(f"[make_multihost_mesh] need {hosts}x{data}x{limb} devices, "
                         f"have {len(devs)}")
    return Mesh(_device_array(devs[: hosts * data * limb], (hosts, data, limb)),
                ("host", "data", "limb"))


def make_latency_mesh(poly: int | None = None, devices: list | None = None) -> Mesh:
    """A 1-D ('poly',) mesh for one ciphertext's latency: the coefficient
    axis splits across the devices, and each transform runs on whole
    polynomials after an all-to-all (parallel/partition.py)."""
    devs = devices if devices is not None else _default_devices()
    poly = poly or len(devs)
    if poly > len(devs):
        raise ValueError(f"[make_latency_mesh] need {poly} devices, have {len(devs)}")
    return Mesh(_device_array(devs[:poly], (poly,)), ("poly",))


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Sharding:
    """A mesh and a per-axis spec: None (whole), a mesh-axis name or a tuple
    of names (split over their product, row-major), as PartitionSpec."""
    mesh: Mesh
    spec: tuple


def _names(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def split(size: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of `parts` chunks of range(size), the first larger."""
    base, rem = divmod(size, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + base + (i < rem)
        out.append((lo, hi))
        lo = hi
    return out


def shard_slices(sharding: Sharding, shape, i: int) -> tuple:
    """The slice of each axis that flat mesh position i holds."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.axis_names, np.unravel_index(i, mesh.devices.shape)))
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    out = []
    for size, entry in zip(shape, spec):
        names = _names(entry)
        count = int(np.prod([mesh.shape[a] for a in names])) if names else 1
        if size < count:
            raise ValueError(f"[shard] an axis of {size} cannot split over {count} devices")
        idx = int(np.ravel_multi_index([coord[a] for a in names],
                                       [mesh.shape[a] for a in names])) if names else 0
        lo, hi = split(size, count)[idx]
        out.append(slice(lo, hi))
    return tuple(out)


@dataclass
class CollectiveRecord:
    """Cross-shard copies by kind (counts, bytes delivered), and per flat
    shard the stage calls and kernel launches it ran."""
    counts: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)

    def add(self, kind: str, nbytes: int):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)

    def merge(self, other: "CollectiveRecord"):
        for k, v in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        for k, v in other.bytes.items():
            self.bytes[k] = self.bytes.get(k, 0) + v
        for i, v in other.work.items():
            self.work[i] = self.work.get(i, 0) + v
        for i, d in other.launches.items():
            mine = self.launches.setdefault(i, {})
            for k, v in d.items():
                mine[k] = mine.get(k, 0) + v

    @property
    def active_shards(self) -> list[int]:
        """Flat mesh positions that ran at least one stage."""
        return sorted(i for i, v in self.work.items() if v)


_ACTIVE: list[CollectiveRecord] = []


@contextlib.contextmanager
def recording():
    """Collect every collective and shard stage run inside the block."""
    rec = CollectiveRecord()
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


class _Shard:
    """One addressable shard, as jax.Shard: its index (slices) and data."""

    def __init__(self, index: tuple, data: torch.Tensor, device):
        self.index, self.data, self.device = index, data, device


class ShardedTensor:
    """A tensor of global `shape` split by `sharding`: shards[i] is flat mesh
    position i's contiguous piece on its device (None where another process
    holds it).  record: the collectives and shard work that produced it."""

    def __init__(self, shards: list, shape, sharding: Sharding, dtype=torch.int64,
                 record: CollectiveRecord | None = None):
        self.shards = shards
        self.shape = torch.Size(shape)
        self.sharding = sharding
        self.dtype = dtype
        self.record = record if record is not None else CollectiveRecord()

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def slices(self, i: int) -> tuple:
        return shard_slices(self.sharding, self.shape, i)

    @property
    def addressable_shards(self) -> list[_Shard]:
        return [_Shard(self.slices(i), s, self.mesh.devices.flat[i])
                for i, s in enumerate(self.shards) if s is not None]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first shard's); raises
        where another process holds a shard."""
        if any(s is None for s in self.shards):
            raise ValueError("[ShardedTensor.gather] shards are held by other processes")
        local = self.addressable_shards
        dev = torch.device(device) if device is not None else local[0].data.device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for s in local:
            out[s.index] = s.data.to(dev)
        return out

    def __repr__(self):
        return (f"ShardedTensor(shape={tuple(self.shape)}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")


def shard(x, sharding: Sharding) -> ShardedTensor:
    """x split by sharding: each of this process's mesh positions gets its
    contiguous piece on its device (jax.device_put with a NamedSharding).  A
    ShardedTensor is gathered first."""
    if isinstance(x, ShardedTensor):
        x = x.gather()
    mesh = sharding.mesh
    shards = []
    for i in range(mesh.size):
        if not mesh.is_local(i):
            shards.append(None)
            continue
        piece = x[shard_slices(sharding, x.shape, i)]
        shards.append(piece.to(mesh.devices.flat[i]).contiguous())
    return ShardedTensor(shards, x.shape, sharding, x.dtype)


def ct_batch_spec(mesh: Mesh, shard_limbs: bool = True, ndim: int = 4) -> Sharding:
    """Sharding of a stacked ciphertext batch (B, size, L, n), at either
    width: the batch over 'data' (and 'host'), the RNS limb axis (second
    from last) over 'limb'."""
    limb = "limb" if shard_limbs else None
    batch = ("host", "data") if "host" in mesh.axis_names else "data"
    return Sharding(mesh, tuple([batch] + [None] * (ndim - 3) + [limb, None]))


def table_spec(mesh: Mesh) -> Sharding:
    """Tables (L, n): whole over 'data', limbs over 'limb'."""
    return Sharding(mesh, ("limb", None))


def poly_spec(mesh: Mesh, ndim: int = 4) -> Sharding:
    """The coefficient (last) axis over 'poly'."""
    return Sharding(mesh, tuple([None] * (ndim - 1) + ["poly"]))


def shard_poly(data, mesh: Mesh) -> ShardedTensor:
    """Any (..., n) tensor split along its coefficient axis."""
    return shard(data, poly_spec(mesh, data.ndim))


def shard_batch(data, mesh: Mesh, shard_limbs: bool = True) -> ShardedTensor:
    return shard(data, ct_batch_spec(mesh, shard_limbs, data.ndim))


def replicate(x, mesh: Mesh) -> ShardedTensor:
    """A whole copy of x on every mesh device of this process."""
    return shard(x, Sharding(mesh, ()))


# ---------------------------------------------------------------------------
# partition diagnostics
# ---------------------------------------------------------------------------

def collective_stats(record) -> dict:
    """Counts of the cross-shard copies and the bytes they delivered, from a
    CollectiveRecord or a ShardedTensor's own: the proof that a plan
    communicates instead of replicating.  (The JAX function reads a compiled
    executable's HLO and counts each collective's per-device result once.)"""
    rec = record.record if isinstance(record, ShardedTensor) else record
    counts = dict(rec.counts)
    return {"counts": counts, "total": sum(counts.values()),
            "approx_bytes": sum(rec.bytes.values())}


def per_device_bytes(x: ShardedTensor) -> int:
    """Bytes of x resident on one device: its first addressable shard."""
    s = x.addressable_shards[0].data
    return s.numel() * s.element_size()

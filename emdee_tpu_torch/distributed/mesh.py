"""The (nz, ny, nx) shard mesh of the sharded engines and its transport
— counterpart of emdee_tpu/distributed/mesh.py (`make_mesh`, `ATOM_AXIS`:
the 1-D slab mesh, here a (D, 1, 1) mesh) and of the mesh part of
emdee_tpu/distributed/grid_sharded.py (`make_grid_mesh`,
`validate_grid_config`, and the `ppermute`/`psum`/`pmax`/`axis_index` they
call inside `shard_map`).

A mesh holds some of the shards in this process, stacked on three leading
dimensions (the local shards' grid, `local_shape`, whose first shard sits at
the global shard coordinates `base`).  Every tensor the engine exchanges has
one leading field dimension, then those three, then the shard's own cells:
(F, sz, sy, sx, …).  The per-shard code is written once against four
operations:

- `shift(x, axis, d)`: on every local shard, x as held by the shard d steps
  along mesh axis `axis` (0 = gz, 1 = gy, 2 = gx), periodically — the ring
  `ppermute` of a boundary layer;
- `psum(x)`, `pmax(x)`: a sum, a max over the shards of other processes
  (this process's own shards are reduced by the caller's sum over them);
  `psum` takes float and int32 tensors alike (the molecular grid sums its
  (N+1,) int32 atom → global slot map with it);
- `axis_index(axis)`: each local shard's index along a mesh axis (the
  local shards' grid is `local_shape`, its first shard at `base`);
- `all_gather(x)`: every shard's block on every shard — x holds this
  process's shards stacked on its leading dimension in row-major (gz, gy,
  gx) order, the result every shard of the mesh in that order (the global
  sorts of the slab engines, and the gathers that undo a distribution).

Two transports implement them.  `LocalMesh` holds every shard in one
process, on one device: a shift is a roll over the stacked shard dimension,
and a reduction has nothing left to do.  `DistMesh` holds one shard per rank
of a `torch.distributed` group (NCCL between cards, gloo on the CPU): a
shift is one `batch_isend_irecv` pair with the two ring neighbours, a
reduction one `all_reduce`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from emdee_tpu_torch.core.types import resolve_device

AXES = ("gz", "gy", "gx")
ATOM_AXIS = "atoms"  # the reference's name for the slab axis: this mesh's "gz"


class GridMesh:
    """A (nz, ny, nx) mesh with axes ("gz", "gy", "gx"); see the module
    docstring for the transport operations its subclasses provide."""

    shape: Tuple[int, int, int]
    local_shape: Tuple[int, int, int]
    base: Tuple[int, int, int]
    device: torch.device

    def axis_size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def axis_index(self, axis: int) -> torch.Tensor:
        """(local_shape[axis],) int64 on the mesh's device: the local
        shards' indices along mesh axis `axis` (0 = gz, 1 = gy, 2 = gx)."""
        return self.base[axis] + torch.arange(self.local_shape[axis], device=self.device)

    def shift(self, x: torch.Tensor, axis: int, d: int) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, flag: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class LocalMesh(GridMesh):
    """Every shard in this process, stacked on the leading (nz, ny, nx)
    dimensions: exchanges between shards are device copies."""

    def __init__(self, shape, device):
        self.shape = self.local_shape = tuple(int(s) for s in shape)
        self.base = (0, 0, 0)
        self.device = torch.device(device)

    def shift(self, x, axis, d):
        if self.shape[axis] == 1:
            return x
        return torch.roll(x, shifts=-d, dims=1 + axis)

    def psum(self, x):
        return x

    def pmax(self, flag):
        return flag

    def all_gather(self, x):
        return x


class DistMesh(GridMesh):
    """One shard per rank of a `torch.distributed` group; rank r holds the
    shard at the mesh coordinates of r in row-major (gz, gy, gx) order."""

    def __init__(self, shape, group, device):
        import torch.distributed as dist

        self.shape = tuple(int(s) for s in shape)
        self.group = group
        self.device = torch.device(device)
        self.local_shape = (1, 1, 1)
        world = dist.get_world_size(group)
        if world != int(np.prod(self.shape)):
            raise ValueError(f"a {self.shape} mesh needs {int(np.prod(self.shape))} ranks, the group has {world}")
        self.rank = dist.get_rank(group)
        self.base = tuple(int(v) for v in np.unravel_index(self.rank, self.shape))

    def _peer(self, axis: int, d: int) -> int:
        import torch.distributed as dist

        coords = list(self.base)
        coords[axis] = (coords[axis] + d) % self.shape[axis]
        return dist.get_global_rank(self.group, int(np.ravel_multi_index(coords, self.shape)))

    def shift(self, x, axis, d):
        import torch.distributed as dist

        if self.shape[axis] == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, self._peer(axis, -d), self.group),
            dist.P2POp(dist.irecv, out, self._peer(axis, d), self.group),
        ])
        for req in reqs:
            req.wait()
        return out

    def psum(self, x):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def pmax(self, flag):
        import torch.distributed as dist

        v = flag.to(torch.int32)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return v > 0

    def all_gather(self, x):
        import torch.distributed as dist

        sent = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(sent) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, sent, group=self.group)
        return torch.cat(parts).to(x.dtype)


def make_grid_mesh(shape: Tuple[int, int, int], group=None, device=None) -> GridMesh:
    """A (nz, ny, nx) mesh with axes ("gz", "gy", "gx") on `device` (by
    default the CUDA card): every shard in this process (`LocalMesh`) when
    `group` is None, else one shard per rank of that `torch.distributed`
    process group (`DistMesh`)."""
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh shape must be three positive sizes, got {shape}")
    device = resolve_device(device)
    if group is None:
        return LocalMesh(shape, device)
    return DistMesh(shape, group, device)


def make_mesh(num_devices=None, group=None, device=None) -> GridMesh:
    """The 1-D slab mesh of `distributed/domain.py` and
    `distributed/cell_dense_sharded.py`: a (D, 1, 1) mesh whose "gz" axis is
    the reference's `ATOM_AXIS`, on `device` (by default the CUDA card).
    With `group`, one slab per rank of that `torch.distributed` group
    (`DistMesh`; D defaults to the group's size); without, D slabs in this
    process (`LocalMesh`; D defaults to 1)."""
    if num_devices is None:
        if group is None:
            num_devices = 1
        else:
            import torch.distributed as dist

            num_devices = dist.get_world_size(group)
    return make_grid_mesh((int(num_devices), 1, 1), group=group, device=device)


def validate_grid_config(config, mesh: GridMesh) -> Tuple[int, int, int]:
    """The local cells per shard (mz, my, mx); raises if M does not divide
    over an axis or leaves fewer than 2 layers on a split axis."""
    m = config.cells_per_dim
    locs = []
    for ax in AXES:
        nd = mesh.axis_size(ax)
        if m % nd != 0:
            raise ValueError(f"cells_per_dim {m} must divide over {nd} ({ax}) devices")
        loc = m // nd
        if nd > 1 and loc < 2:
            raise ValueError(f"{loc} cell layer(s) per device on {ax} — need ≥ 2")
        locs.append(loc)
    return tuple(locs)

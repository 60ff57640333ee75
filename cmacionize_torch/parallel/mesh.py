"""A mesh of shards in one process, with the collectives of the domain
decomposition.

Port of ``cmacionize_tpu/parallel/mesh.py`` (``make_mesh``) and
``parallel/domain3d.py:make_mesh_3d``.  The JAX package never runs over more
than one process: its mesh is the local devices, and its tests put 8 virtual
CPU devices in one process.  The port does the same.  A :class:`LocalMesh`
holds ``prod(shape)`` shards in row-major order over the named axes; shard
``i`` sits on ``devices[i % len(devices)]``, so on one card every shard
shares it, as the JAX tests' 8 shards share one CPU.

What runs inside JAX's ``shard_map`` becomes a loop over the shards on the
host, and the data of a sharded array a list of per-shard tensors.  The
collectives below take and return such lists, and they are the only points
where shards meet: ``psum``/``pmin`` (formed on the first member's device,
then copied to each member's device), ``ppermute`` (a circular shift along
one axis) and ``axis_index``.  There is no NCCL and no ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cmacionize_torch.device import require_cuda


def cuda_devices():
    """Every visible CUDA device; raises where CUDA is unavailable."""
    require_cuda()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class LocalMesh:
    """``shape`` shards over the named axes, in one process.

    ``devices=None`` means the visible CUDA devices; a caller that wants the
    CPU passes ``devices=[torch.device("cpu")]``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
        if devices is None:
            devices = cuda_devices()
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))  # as jax.sharding.Mesh.shape
        self.size = int(np.prod(shape))
        self.devices = [devices[i % len(devices)] for i in range(self.size)]
        self._grid = np.arange(self.size).reshape(shape)

    def coords(self, i: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(i, self._grid.shape))

    def axis_index(self, axis: str) -> list:
        """Each shard's coordinate on ``axis``."""
        a = self.axis_names.index(axis)
        return [self.coords(i)[a] for i in range(self.size)]

    def _groups(self, axes):
        """The shards that reduce together over ``axes`` (None: all)."""
        if axes is None:
            return [list(range(self.size))]
        if isinstance(axes, str):
            axes = (axes,)
        keep = [a for a, name in enumerate(self.axis_names) if name not in axes]
        grid = np.moveaxis(self._grid, keep, list(range(len(keep))))
        rows = grid.reshape((-1,) + grid.shape[len(keep):])
        return [[int(i) for i in row.reshape(-1)] for row in rows]

    def _reduce(self, values, axes, op):
        out = [None] * self.size
        for group in self._groups(axes):
            home = self.devices[group[0]]
            total = values[group[0]].to(home)
            for i in group[1:]:
                total = op(total, values[i].to(home))
            for k, i in enumerate(group):
                # every member gets its own tensor on its own device
                out[i] = total if k == 0 else total.to(self.devices[i], copy=True)
        return out

    def psum(self, values, axes=None) -> list:
        """The sum over ``axes`` (one name, several, or None for all) of the
        per-shard tensors, on every member's device."""
        return self._reduce(values, axes, torch.add)

    def pmin(self, values, axes=None) -> list:
        """The elementwise minimum over ``axes``, as :meth:`psum`."""
        return self._reduce(values, axes, torch.minimum)

    def ppermute(self, values, axis: str, shift: int) -> list:
        """Circular shift along ``axis``: the shard at coordinate c receives
        what the shard at c - shift (mod the axis' size) sent, moved to its
        device.  ``values`` holds one tensor or tuple of tensors per shard."""
        a = self.axis_names.index(axis)
        source = np.roll(self._grid, shift, axis=a)  # source[c] = grid[c - shift]
        out = []
        for i in range(self.size):
            sent = values[int(source.reshape(-1)[i])]
            device = self.devices[i]
            if isinstance(sent, torch.Tensor):
                out.append(sent.to(device))
            else:
                out.append(type(sent)(t.to(device) for t in sent))
        return out

    def shard(self, array: torch.Tensor, spec: Sequence[str]) -> list:
        """Cut a global array into per-shard blocks: ``spec[d]`` names the
        mesh axis that splits dimension d, as a JAX PartitionSpec does (the
        dimensions past ``spec`` are not split).  Each block is a contiguous
        copy on its shard's device."""
        blocks = []
        for i in range(self.size):
            c = self.coords(i)
            index = []
            for d, name in enumerate(spec):
                n = self.shape[name]
                size = array.shape[d]
                if size % n:
                    raise ValueError(f"dimension {d} ({size}) does not divide over {n} shards")
                k = c[self.axis_names.index(name)]
                index.append(slice(k * size // n, (k + 1) * size // n))
            blocks.append(array[tuple(index)].to(self.devices[i]).contiguous().clone())
        return blocks

    def unshard(self, blocks: Sequence[torch.Tensor], spec: Sequence[str]) -> torch.Tensor:
        """The global array of per-shard blocks cut by :meth:`shard` with
        the same ``spec`` (naming every mesh axis), on the first shard's
        device."""
        grid = np.empty(self._grid.shape, dtype=object)
        for i in range(self.size):
            grid[self.coords(i)] = blocks[i].to(self.devices[0])
        for dim, name in enumerate(spec):
            grid = _cat_along(grid, self.axis_names.index(name), dim)
        return grid[(0,) * grid.ndim]


def _cat_along(grid: np.ndarray, axis: int, dim: int) -> np.ndarray:
    """Concatenate the tensors of an object array along one of its axes."""
    moved = np.moveaxis(grid, axis, -1)
    out = np.empty(moved.shape[:-1], dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = torch.cat(list(moved[idx]), dim=dim)
    # keep the reduced axis as size 1, so later axis numbers stay valid
    return np.expand_dims(out, axis)

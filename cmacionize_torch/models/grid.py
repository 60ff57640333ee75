"""Grid geometry (static, host-side numpy).

Port of ``cmacionize_tpu/models/grid.py:GridGeometry``.  Cell fields in the
port are ``[nx, ny, nz]`` tensors whose flat C-order index is
``(cx*ny + cy)*nz + cz``, the JAX package's layout, so tallies compare cell
by cell.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static description of a Cartesian box grid (SI units)."""

    anchor: Tuple[float, float, float]
    sides: Tuple[float, float, float]
    shape: Tuple[int, int, int]
    periodic: Tuple[bool, bool, bool] = (False, False, False)

    @property
    def cell_size(self) -> np.ndarray:
        return np.asarray(self.sides) / np.asarray(self.shape)

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.cell_size))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.shape))

    def cell_centers(self) -> np.ndarray:
        """[nx, ny, nz, 3] SI cell-center coordinates (host-side numpy)."""
        axes = [
            self.anchor[i] + (np.arange(self.shape[i]) + 0.5) * self.cell_size[i]
            for i in range(3)
        ]
        grid = np.meshgrid(*axes, indexing="ij")
        return np.stack(grid, axis=-1)

    def position_to_grid_coords(self, position) -> np.ndarray:
        """SI position → continuous grid coordinates in [0, shape)."""
        return (np.asarray(position) - np.asarray(self.anchor)) / self.cell_size

    @classmethod
    def from_params(cls, params) -> "GridGeometry":
        anchor = params.get_physical_vector("SimulationBox:anchor", "length")
        sides = params.get_physical_vector("SimulationBox:sides", "length")
        periodic = params.get_bool_vector(
            "SimulationBox:periodicity", [False, False, False]
        )
        shape = params.get_int_vector("DensityGrid:number of cells", [64, 64, 64])
        return cls(tuple(anchor), tuple(sides), tuple(shape), tuple(periodic))

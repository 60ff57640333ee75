"""Density functions: initial-condition generators for the grids.

Port of the Homogeneous and BlockSyntax parts of
``cmacionize_tpu/models/density_functions.py``.  A density function maps
cell centres to (number density, temperature, neutral fraction) fields; it
runs once at set-up, host-side in numpy (f64).  Block files are read with the
port's own YAML-subset reader, not PyYAML; a file name is opened relative to
the working directory, as in the JAX package.

The other DensityFunction types of the JAX factory raise
``NotImplementedError`` (ROADMAP.md, queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.utils.params import parse_yaml_subset
from cmacionize_torch.utils.units import parse_quantity

NOT_PORTED = "not ported yet (ROADMAP.md, queue 1, item 6)"


@dataclasses.dataclass(frozen=True)
class DensityFields:
    number_density: np.ndarray
    temperature: np.ndarray
    neutral_fraction: np.ndarray
    # optional [*, 3] bulk velocity (hydro ICs)
    velocity: Optional[np.ndarray] = None


def homogeneous(geometry: GridGeometry, number_density, temperature,
                neutral_fraction=1e-6) -> DensityFields:
    shape = geometry.shape
    return DensityFields(
        np.full(shape, number_density),
        np.full(shape, temperature),
        np.full(shape, neutral_fraction),
    )


@dataclasses.dataclass(frozen=True)
class Block:
    """One BlockSyntax primitive: a cube or sphere with constant values."""

    origin: Tuple[float, float, float]
    sides: Tuple[float, float, float]  # sphere: sides[0] = diameter
    kind: str  # "cube" | "sphere"
    number_density: float
    temperature: float
    neutral_fraction: float = 1e-6

    def contains(self, centers: np.ndarray) -> np.ndarray:
        rel = centers - np.asarray(self.origin)
        if self.kind == "sphere":
            return (rel**2).sum(-1) <= (0.5 * self.sides[0]) ** 2
        return np.all(np.abs(rel) <= 0.5 * np.asarray(self.sides), axis=-1)


def block_syntax(
    geometry: GridGeometry,
    blocks: Sequence[Block],
    background_density: float = 0.0,
    background_temperature: float = 100.0,
    background_neutral_fraction: float = 1.0,
) -> DensityFields:
    """Apply nested blocks in order (later blocks override earlier ones)."""
    centers = geometry.cell_centers()
    nd = np.full(geometry.shape, background_density)
    T = np.full(geometry.shape, background_temperature)
    xh = np.full(geometry.shape, background_neutral_fraction)
    for block in blocks:
        inside = block.contains(centers)
        nd = np.where(inside, block.number_density, nd)
        T = np.where(inside, block.temperature, T)
        xh = np.where(inside, block.neutral_fraction, xh)
    return DensityFields(nd, T, xh)


def blocks_from_yaml(filename: str) -> List[Block]:
    """Parse a BlockSyntax YAML file (cf. benchmarks/starbench.yml)."""
    with open(filename) as handle:
        doc = parse_yaml_subset(handle.read())
    blocks = []
    for i in range(int(doc["number of blocks"])):
        entry = doc[f"block[{i}]"]
        blocks.append(
            Block(
                origin=tuple(parse_quantity(c, "length") for c in entry["origin"]),
                sides=tuple(parse_quantity(c, "length") for c in entry["sides"]),
                kind=str(entry.get("type", "cube")),
                number_density=parse_quantity(
                    entry["number density"], "number density"
                ),
                temperature=parse_quantity(
                    entry.get("initial temperature", "100. K"), "temperature"
                ),
                neutral_fraction=float(entry.get("neutral fraction H", 1e-6)),
            )
        )
    return blocks


def density_function_from_params(params, geometry: GridGeometry) -> DensityFields:
    """Factory: the initial density/temperature fields from a parameter
    file, by ``DensityFunction:type`` (Homogeneous and BlockSyntax)."""
    dftype = params.get_string("DensityFunction:type", "Homogeneous")
    temperature = params.get_physical_value(
        "DensityFunction:temperature", "temperature", "8000. K")

    if dftype == "Homogeneous":
        nd = np.full(geometry.shape, params.get_physical_value(
            "DensityFunction:density", "number density", "100. cm^-3"))
        T = np.full(geometry.shape, temperature)
    elif dftype == "BlockSyntax":
        fields = block_syntax(
            geometry, blocks_from_yaml(params.get_string("DensityFunction:filename"))
        )
        nd, T = np.asarray(fields.number_density), np.asarray(fields.temperature)
    else:
        raise NotImplementedError(f"DensityFunction type {dftype!r}: {NOT_PORTED}")

    mask_type = params.get_string("DensityMask:type", "None")
    if mask_type == "Fractal":
        raise NotImplementedError(f"DensityMask type 'Fractal': {NOT_PORTED}")
    if mask_type != "None":
        raise ValueError(f"unknown DensityMask type '{mask_type}'")

    xh0 = params.get_number("DensityFunction:initial neutral fraction", 1e-6)
    return DensityFields(
        number_density=np.asarray(nd),
        temperature=np.asarray(T),
        neutral_fraction=np.full(geometry.shape, xh0),
        velocity=None,
    )

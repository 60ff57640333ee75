"""Photon trackers of the multi-frequency driver.

Port of the tracker part of ``cmacionize_tpu/models/trackers.py`` (the
reference's Absorption/Spectrum/WeightedSpectrum trackers placed by its
TrackerManager):

- :class:`TrackerManager` gathers the tracked cells' columns of each
  iteration's frequency-binned tally (host numpy);
- :class:`CellTrackers` are the typed trackers.  Packets fly straight between
  emission and termination within each generation (the source batch, then
  one batch per re-emission generation), so every crossing of a tracked cell
  follows after the march from the segment origin → final position alone:
  a slab test of every segment against every tracked cell, as torch ops on
  the driver's device, with nothing added to the march.

The live outputs of the JAX module (``LiveOutputManager``,
``PhotonPacketStatistics``, ``surface_density``, ``field_pdf``) serve the RHD
driver and the command line and are not ported here.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_torch.utils.units import parse_quantity


def _tracked_cell(geometry: GridGeometry, position) -> np.ndarray:
    """The (ix, iy, iz) cell holding ``position``, clamped into the grid."""
    shape = np.asarray(geometry.shape)
    return np.clip(geometry.position_to_grid_coords(position).astype(int), 0, shape - 1)


class TrackerManager:
    """Accumulates per-cell spectra for tracked positions.

    Feed it the [n_bins * n_cell] spectral tally of each iteration (the
    multi-frequency driver's binned tally); :meth:`spectra` returns the
    accumulated path-length spectrum Σ ℓ·w per frequency bin of each tracked
    cell — multiply by σ(ν)/V_cell·jfac for a mean-intensity spectrum.
    """

    def __init__(self, geometry: GridGeometry, positions: Sequence[Tuple[float, float, float]],
                 bin_edges: np.ndarray):
        self.geometry = geometry
        self.bin_edges = np.asarray(bin_edges)
        self.positions = list(positions)
        shape = geometry.shape
        cells = []
        for position in positions:
            idx = _tracked_cell(geometry, position)
            cells.append((idx[0] * shape[1] + idx[1]) * shape[2] + idx[2])
        self.cell_indices = np.asarray(cells, dtype=np.int64)
        self._accumulated = np.zeros((len(cells), len(self.bin_edges) - 1), dtype=np.float64)
        self.n_iterations = 0

    @classmethod
    def from_yaml(cls, geometry, filename, bin_edges):
        """Tracker positions from a YAML file: a ``positions:`` list of
        unit-bearing coordinate triples."""
        doc = ParameterFile(filename)
        positions = [
            tuple(parse_quantity(component, "length") for component in entry)
            for entry in doc.get_value("positions")
        ]
        return cls(geometry, positions, bin_edges)

    def accumulate(self, tally2d) -> None:
        """Add one iteration's [n_bins * n_cell] tally (tensor or array)."""
        if torch.is_tensor(tally2d):
            tally2d = tally2d.detach().cpu().numpy()
        t2 = np.asarray(tally2d).reshape(-1, self.geometry.n_cells)
        self._accumulated += t2[:, self.cell_indices].T
        self.n_iterations += 1

    def spectra(self) -> np.ndarray:
        """[n_trackers, n_bins] accumulated path-length spectra."""
        return self._accumulated.copy()

    def write(self, filename: str) -> None:
        centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        with open(filename, "w") as handle:
            handle.write("# frequency_Hz\t" + "\t".join(
                f"tracker_{i}" for i in range(len(self.cell_indices))) + "\n")
            for b, nu in enumerate(centers):
                row = "\t".join(f"{self._accumulated[t, b]:.8e}"
                                for t in range(len(self.cell_indices)))
                handle.write(f"{nu:.8e}\t{row}\n")


#: PHOTONTYPE slots (the reference's Photon.hpp PhotonType)
TRACKER_SLOTS = ("primary", "diffuse H", "diffuse He")


def cube_projected_area(dx, dy, dz):
    """Projected area of a unit cube seen from direction (dx, dy, dz):
    |dx| + |dy| + |dz| (the three visible faces' direction cosines), the
    reference's projected hexagon.  Multiply by L² for a cell of side L."""
    return torch.abs(torch.as_tensor(dx)) + torch.abs(torch.as_tensor(dy)) + torch.abs(
        torch.as_tensor(dz))


def segment_aabb_overlap(origin, direction, length, lo, hi):
    """Overlap lengths [n_track, P] of P ray segments with n_track
    axis-aligned boxes, by the slab method.

    origin/direction: [P, 3] (cell units; direction normalized); length: [P]
    segment lengths; lo/hi: [n_track, 3]."""
    o = origin[None, :, :]
    d = direction[None, :, :]
    lo = lo[:, None, :]
    hi = hi[:, None, :]
    deg = torch.abs(d) <= 1e-12
    safe = torch.where(deg, 1e-12, d)
    t0 = (lo - o) / safe
    t1 = (hi - o) / safe
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    inside = (o >= lo) & (o <= hi)
    tmin = torch.where(deg, torch.where(inside, -1e30, 1e30), tmin)
    tmax = torch.where(deg, torch.where(inside, 1e30, -1e30), tmax)
    enter = tmin.amax(dim=-1)
    exit_ = tmax.amin(dim=-1)
    a = torch.minimum(torch.clamp_min(enter, 0.0), length[None, :])
    b = torch.minimum(torch.clamp_min(exit_, 0.0), length[None, :])
    return torch.clamp_min(b - a, 0.0)


class CellTrackers:
    """Typed per-cell photon trackers (Absorption, Spectrum, WeightedSpectrum
    and Multi), placed from the reference's tracker file format (``number of
    trackers`` and ``tracker[i]: position/type/...`` blocks).

    The driver feeds :meth:`contributions` once per marched generation, on
    its device; three accumulators cover every tracker type:

    - ``counts`` [nT, 3, n_bins]: Σ w per crossing per frequency bin per
      PHOTONTYPE (Spectrum; with an optional reference direction and
      opening angle);
    - ``weighted`` [nT, 3, n_bins]: Σ w / A_proj(direction), the projected
      area weighting (WeightedSpectrum); multiply by 1/L² per unit area;
    - ``lengths`` [nT, 3, n_bins]: Σ w·ℓ in the cell (SI m); per-ion
      absorption volumes follow as σ_table @ lengths (Absorption).

    The accumulators are f64 tensors on the driver's device, read as numpy
    arrays through the properties of the same names.
    """

    def __init__(self, geometry: GridGeometry, entries: List[dict], bin_edges: np.ndarray,
                 device="cpu"):
        self.geometry = geometry
        self.entries = entries
        self.bin_edges = np.asarray(bin_edges)
        self.n_bins = len(self.bin_edges) - 1
        self.n_track = len(entries)
        self.n_iterations = 0
        lo, hi, refdir, cosang = [], [], [], []
        for e in entries:
            idx = _tracked_cell(geometry, e["position"])
            lo.append(idx.astype(float))
            hi.append(idx.astype(float) + 1.0)
            rd = np.asarray(e.get("reference_direction", (0.0, 0.0, 0.0)), dtype=float)
            norm = np.linalg.norm(rd)
            refdir.append(rd / norm if norm > 0 else rd)
            cosang.append(np.cos(e.get("opening_angle", np.pi)) if norm > 0 else -2.0)
        self._lo, self._hi, self._refdir, self._cosang = (
            torch.tensor(np.asarray(a, np.float64)) for a in (lo, hi, refdir, cosang))
        self._sums = torch.zeros((3, self.n_track, len(TRACKER_SLOTS), self.n_bins),
                                 dtype=torch.float64)
        self.to(device)

    def to(self, device) -> "CellTrackers":
        """Move the tracker geometry and the accumulators to ``device``."""
        self.device = torch.device(device)
        for name in ("_lo", "_hi", "_refdir", "_cosang", "_sums"):
            setattr(self, name, getattr(self, name).to(self.device))
        return self

    @classmethod
    def from_reference_yaml(cls, geometry, filename, bin_edges, device="cpu"):
        """Parse the reference's tracker file."""
        blocks = ParameterFile(filename)
        entries = []
        for i in range(blocks.get_int("number of trackers")):
            prefix = f"tracker[{i}]"
            entry = {
                "type": blocks.get_string(f"{prefix}:type", "Spectrum"),
                "position": tuple(blocks.get_physical_vector(f"{prefix}:position", "length")),
                "output_name": blocks.get_string(f"{prefix}:output name", f"Tracker{i}.txt"),
            }
            if blocks.has_value(f"{prefix}:reference direction"):
                entry["reference_direction"] = tuple(
                    blocks.get_physical_vector(f"{prefix}:reference direction", None))
                entry["opening_angle"] = blocks.get_physical_value(
                    f"{prefix}:opening angle", "angle", "3.1415926536 radians")
            entries.append(entry)
        return cls(geometry, entries, bin_edges, device)

    # ----------------------------------------------------------- device part

    def contributions(self, origin, direction, final, fbin, weight, valid, slot):
        """One generation's (counts, weighted, lengths), each [nT, 3, n_bins].

        origin/direction/final: [P, 3] in cell units (final: the position
        after the march, an absorption point or a boundary exit); fbin: [P]
        int; weight: [P]; valid: [P] bool; slot: [P] int PHOTONTYPE index
        (0 primary, 1 diffuse H, 2 diffuse He).  ``lengths`` is in SI m.
        Not for periodic boxes (a wrapped segment is not straight in cell
        coordinates); the driver guards.
        """
        dx_m = float(self.geometry.cell_size[0])
        length = ((final - origin) * direction).sum(-1)
        ov = segment_aabb_overlap(origin, direction, length, self._lo, self._hi)  # [nT, P]
        crossed = (ov > 0.0) & valid[None, :]
        # per-tracker reference-direction filter
        dots = self._refdir @ direction.to(self._refdir.dtype).T
        crossed = crossed & (dots >= self._cosang[:, None])

        n_slots = len(TRACKER_SLOTS)
        flat = (slot.long() * self.n_bins + fbin.long())
        inv_area = 1.0 / torch.clamp_min(
            cube_projected_area(direction[:, 0], direction[:, 1], direction[:, 2]), 1e-12)
        w = torch.where(crossed, weight[None, :].to(ov.dtype), 0.0)  # [nT, P]
        sources = (w, w * inv_area.to(ov.dtype), w * ov * dx_m)
        out = []
        for values in sources:
            base = torch.zeros((self.n_track, n_slots * self.n_bins), dtype=ov.dtype,
                               device=ov.device)
            out.append(base.index_add_(1, flat, values).reshape(
                self.n_track, n_slots, self.n_bins))
        return tuple(out)

    def accumulate(self, counts, weighted, lengths) -> None:
        self._sums += torch.stack([counts, weighted, lengths]).to(self._sums)

    def end_iteration(self) -> None:
        self.n_iterations += 1

    # ------------------------------------------------------------- host part

    @property
    def counts(self) -> np.ndarray:
        return self._sums[0].cpu().numpy()

    @property
    def weighted(self) -> np.ndarray:
        return self._sums[1].cpu().numpy()

    @property
    def lengths(self) -> np.ndarray:
        return self._sums[2].cpu().numpy()

    def absorption(self, sigma_table) -> np.ndarray:
        """[n_track, 3, n_ion] per-ion absorption volumes (m³): σ_i(ν)·ℓ·w
        summed over the bins."""
        return np.einsum("ib,tsb->tsi", np.asarray(sigma_table), self.lengths)

    def write_outputs(self, folder: str = ".", sigma_table=None,
                      ion_names: Optional[Sequence[str]] = None) -> List[str]:
        """One output file per tracker in its reference text layout."""
        centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        absorption = self.absorption(sigma_table) if sigma_table is not None else None
        counts, weighted = self.counts, self.weighted
        written = []
        for t, e in enumerate(self.entries):
            path = os.path.join(folder, e["output_name"])
            with open(path, "w") as fh:
                if e["type"] == "Absorption":
                    if absorption is None:
                        raise ValueError("Absorption tracker output needs sigma_table")
                    fh.write("# Ion\t" + "\t".join(TRACKER_SLOTS) + "\n")
                    names = ion_names or [f"ion{i}" for i in range(absorption.shape[-1])]
                    for i, name in enumerate(names):
                        row = "\t".join(f"{absorption[t, s, i]:.8e}"
                                        for s in range(len(TRACKER_SLOTS)))
                        fh.write(f"{name}\t{row}\n")
                else:
                    data = weighted if e["type"] == "WeightedSpectrum" else counts
                    fh.write("# frequency_Hz\t" + "\t".join(TRACKER_SLOTS) + "\n")
                    for b, nu in enumerate(centers):
                        row = "\t".join(f"{data[t, s, b]:.8e}" for s in range(len(TRACKER_SLOTS)))
                        fh.write(f"{nu:.8e}\t{row}\n")
            written.append(path)
        return written

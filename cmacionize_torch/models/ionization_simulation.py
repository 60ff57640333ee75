"""Monte Carlo photoionization drivers, hydrogen only: one device, and the
domain-decomposed ``ShardedHOnlyIonizationSimulation``.

Port of the hydrogen-only monochromatic path of
``cmacionize_tpu/models/ionization_simulation.py`` (the Strömgren benchmark
family): per iteration, emit packets from the point source → march them
through the grid (K1 on the GPU) → normalize the tally → solve the hydrogen
balance in every cell.

As in the JAX driver's fused loop (``h_only_run_fused``), an iteration reads
nothing back to the host: the escaped counts stay on the device, one scalar
tensor per iteration, and are read once after the loop, and only when a log
will print them.  The single-device driver runs in f32 on the device it is
given; there is no default device.  The sharded one spreads its shards over
the visible CUDA devices unless it is given devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cmacionize_torch.models import sources
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import ionization, traversal
from cmacionize_torch.parallel import domain, domain3d
from cmacionize_torch.parallel.drivers import (
    DIAGNOSTIC_COUNTS,
    mesh_devices,
    read_diagnostics,
    shard_generators,
)
from cmacionize_torch.utils.logging import Log, NullLog

RESTART_NOT_PORTED = "restart is not ported yet (ROADMAP.md, queue 1, item 3)"


@dataclasses.dataclass(frozen=True)
class HOnlyConfig:
    """Static configuration of a hydrogen-only monochromatic simulation."""

    geometry: GridGeometry
    number_density: float  # m^-3 (homogeneous)
    temperature: float  # K
    source_position: Tuple[float, float, float]  # SI
    luminosity: float  # photons / s
    cross_section: float  # m^2 (at the source frequency)
    recombination_rate: float  # m^3 s^-1
    n_photons: int
    n_iterations: int
    initial_neutral_fraction: float = 1.0e-6

    @classmethod
    def from_params(cls, params) -> "HOnlyConfig":
        geometry = GridGeometry.from_params(params)
        return cls(
            geometry=geometry,
            number_density=params.get_physical_value(
                "DensityFunction:density", "number density", "100. cm^-3"
            ),
            temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "8000. K"
            ),
            source_position=tuple(
                params.get_physical_vector(
                    "PhotonSourceDistribution:position",
                    "length",
                    ["0. m", "0. m", "0. m"],
                )
            ),
            luminosity=params.get_physical_value(
                "PhotonSourceDistribution:luminosity", "frequency", "4.26e49 s^-1"
            ),
            cross_section=params.get_physical_value(
                "CrossSections:hydrogen_0", "surface area", "6.3e-18 cm^2"
            ),
            recombination_rate=params.get_physical_value(
                "RecombinationRates:hydrogen_1", "reaction rate", "4.e-13 cm^3 s^-1"
            ),
            n_photons=params.get_int("IonizationSimulation:number of photons", 1000000),
            n_iterations=params.get_int(
                "IonizationSimulation:number of iterations", 20
            ),
        )


def _h_only_iteration_body(
    packets: traversal.PacketBatch,
    neutral_fraction,
    number_density,
    *,
    shape,
    periodic,
    sigma_dx,
    jfac_scale,
    alpha,
    max_steps=0,
):
    """One Monte Carlo iteration on emitted packets: trace → normalize →
    H balance.

    Returns (new_neutral_fraction [shape], jH [shape], n_escaped scalar
    tensor); packets cut off by ``max_steps`` count as escaped.
    """
    chi = (number_density * neutral_fraction * sigma_dx).reshape(-1)
    tally = torch.zeros_like(chi)
    tally, packets = traversal.trace_packets(
        chi, packets, tally, shape=shape, periodic=periodic, max_steps=max_steps,
    )
    n_escaped = packets.size - torch.sum(packets.absorbed)
    jH = tally.reshape(shape) * jfac_scale
    new_x = ionization.hydrogen_neutral_fraction(jH, number_density, alpha)
    return new_x, jH, n_escaped


class HOnlyIonizationSimulation:
    """Driver: owns config + grid tensors, runs the iteration loop."""

    STATE_FIELDS = ("neutral_fraction", "number_density", "jH")

    def __init__(
        self,
        config: HOnlyConfig,
        device,
        log: Optional[Log] = None,
        seed: int = 42,
    ):
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError(
                "traversal currently requires cubic cells; got cell size "
                f"{cell}"
            )
        self.config = config
        self.device = torch.device(device)
        self.log = log or NullLog()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.geometry = geom
        self.dx = float(cell[0])
        self.number_density = torch.full(
            geom.shape, config.number_density, dtype=torch.float32, device=self.device
        )
        self.neutral_fraction = torch.full(
            geom.shape, config.initial_neutral_fraction,
            dtype=torch.float32, device=self.device,
        )
        self.jH = torch.zeros(geom.shape, dtype=torch.float32, device=self.device)
        self.iteration = 0  # completed iterations
        # escaped packets per iteration of the last run() (device tensor)
        self.n_escaped = torch.zeros(0, dtype=torch.int64, device=self.device)
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )

    def load_reference_state(self, arrays: dict) -> None:
        """Continue from a state given as numpy arrays (for example the JAX
        simulation's ``neutral_fraction``, ``number_density`` and ``jH``)."""
        for name in self.STATE_FIELDS:
            value = np.asarray(arrays[name], dtype=np.float32)
            if value.shape != tuple(self.geometry.shape):
                raise ValueError(
                    f"{name}: shape {value.shape} != grid {self.geometry.shape}"
                )
            setattr(self, name, torch.tensor(value, device=self.device))

    def emit(self) -> traversal.PacketBatch:
        """The packets of one iteration, from the point source."""
        cfg = self.config
        px, py, pz, dx, dy, dz, tau, weight = sources.emit_point_source(
            self.generator, cfg.n_photons, self._source_gpos
        )
        return traversal.make_packets(
            torch.stack([px, py, pz], dim=1), torch.stack([dx, dy, dz], dim=1),
            tau, weight, self.geometry.shape,
        )

    def step(self, packets: traversal.PacketBatch) -> torch.Tensor:
        """One iteration on ``packets``; returns the escaped count (device)."""
        cfg = self.config
        sigma_dx = cfg.cross_section * self.dx
        jfac_scale = (
            cfg.luminosity
            * cfg.cross_section
            * self.dx
            / (cfg.n_photons * self.geometry.cell_volume)
        )
        self.neutral_fraction, self.jH, n_escaped = _h_only_iteration_body(
            packets,
            self.neutral_fraction,
            self.number_density,
            shape=self.geometry.shape,
            periodic=self.geometry.periodic,
            sigma_dx=sigma_dx,
            jfac_scale=jfac_scale,
            alpha=cfg.recombination_rate,
        )
        self.iteration += 1
        return n_escaped

    def advance(self, n_iterations: int):
        """Run ``n_iterations`` MORE iterations (``run(n)`` counts TOTAL
        iterations)."""
        return self.run(self.iteration + n_iterations)

    def run(self, n_iterations: Optional[int] = None, diagnostics=None):
        """Run MC iterations until ``n_iterations`` (total, default the
        config's) are done; returns the neutral fraction.

        ``diagnostics``: an optional
        :class:`~cmacionize_torch.utils.diagnostics.IterationDiagnostics`,
        given each iteration's "iteration" phase (timed to the device's
        synchronise) and its emitted, escaped and absorbed packets; it reads
        the escaped count back every iteration."""
        cfg = self.config
        n_iterations = n_iterations or cfg.n_iterations
        first = self.iteration
        n_escs = []
        while self.iteration < n_iterations:
            if diagnostics is None:
                n_escs.append(self.step(self.emit()))
                continue
            with diagnostics.phase("iteration", synchronize=self._synchronize):
                n_escs.append(self.step(self.emit()))
            n_escaped = int(n_escs[-1])
            diagnostics.count("photons emitted", cfg.n_photons)
            diagnostics.count("photons escaped", n_escaped)
            diagnostics.count("photons absorbed", cfg.n_photons - n_escaped)
            diagnostics.end_iteration()
        if n_escs:
            self.n_escaped = torch.stack(n_escs)
            if not isinstance(self.log, NullLog):
                for i, n_esc in enumerate(self.n_escaped.tolist()):
                    self.log.info(
                        f"iteration {first + i + 1}/{n_iterations}: "
                        f"{n_esc} / {cfg.n_photons} photons escaped"
                    )
        return self.neutral_fraction

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stromgren_radius_analytic(self) -> float:
        """Analytic Strömgren radius for the homogeneous H-only setup (m),
        cf. the reference's benchmarks/stromgren.py:45-55."""
        cfg = self.config
        return float(
            (
                0.75
                * cfg.luminosity
                / (np.pi * cfg.number_density**2 * cfg.recombination_rate)
            )
            ** (1.0 / 3.0)
        )


class ShardedHOnlyIonizationSimulation:
    """Domain-decomposed H-only driver: the grid tiled (sx, sy, sz) over a
    :class:`~cmacionize_torch.parallel.mesh.LocalMesh`, photon packets
    exchanged between the tiles.

    Port of the JAX ``ShardedHOnlyIonizationSimulation`` over
    ``parallel/domain3d.py:make_domain_mc_iteration_3d``.  ``tiling=None``
    means (number of devices, 1, 1); ``device=None`` means the visible CUDA
    devices (shard i on device i mod their number), and ``device="cpu"``
    runs every shard on the CPU.  Each shard draws from its own generator,
    so the run agrees with the single-device driver statistically.  The
    fields ``neutral_fraction`` and ``jH`` are the global arrays, gathered
    from the shards.  ``last_diagnostics`` holds the last iteration's
    counters, ``total_diagnostics`` their sums over the driver's life.
    Restart is not ported (ROADMAP.md, queue 1, item 3).
    """

    def __init__(self, config: HOnlyConfig, tiling=None, device=None,
                 log: Optional[Log] = None, seed: int = 42):
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError("cubic cells required")
        devices = mesh_devices(device)
        if tiling is None:
            tiling = (len(devices), 1, 1)
        self.tiling = tuple(int(t) for t in tiling)
        self.mesh = domain3d.make_mesh_3d(self.tiling, devices)
        self.n_devices = self.mesh.size
        self.config = config
        self.log = log or NullLog()
        self.generators = shard_generators(seed, self.mesh.devices)
        self.geometry = geom
        self.dx = float(cell[0])
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )
        sigma_dx = config.cross_section * self.dx
        jfac_scale = (
            config.luminosity * config.cross_section * self.dx
            / (config.n_photons * geom.cell_volume)
        )
        self._step = domain3d.make_domain_mc_iteration_3d(
            self.mesh,
            global_shape=geom.shape,
            n_photons=config.n_photons,
            sigma_dx=sigma_dx,
            source_gpos=self._source_gpos,
            jfac_scale=jfac_scale,
            alpha=config.recombination_rate,
        )
        self._spec = domain3d.AXES
        full = torch.full(geom.shape, config.number_density, dtype=torch.float32)
        self._number_density = self.mesh.shard(full, self._spec)
        full = torch.full(geom.shape, config.initial_neutral_fraction, dtype=torch.float32)
        self._neutral_fraction = self.mesh.shard(full, self._spec)
        self._jH = None
        self.iteration = 0
        self.last_diagnostics = None
        self.total_diagnostics = dict.fromkeys(DIAGNOSTIC_COUNTS, 0)

    @property
    def neutral_fraction(self) -> torch.Tensor:
        return self.mesh.unshard(self._neutral_fraction, self._spec)

    @property
    def number_density(self) -> torch.Tensor:
        return self.mesh.unshard(self._number_density, self._spec)

    @property
    def jH(self) -> Optional[torch.Tensor]:
        return None if self._jH is None else self.mesh.unshard(self._jH, self._spec)

    def run(self, n_iterations: Optional[int] = None, restart_manager=None,
            diagnostics=None):
        """Run MC iterations until ``n_iterations`` (total, default the
        config's) are done; returns the global neutral fraction.  Each
        iteration's counters land in ``last_diagnostics``; a nonzero
        overflow or truncation is logged as a warning."""
        if restart_manager is not None:
            raise NotImplementedError(f"ShardedHOnlyIonizationSimulation: {RESTART_NOT_PORTED}")
        cfg = self.config
        n_iterations = n_iterations or cfg.n_iterations
        emit = domain.emit_from(self.generators)
        while self.iteration < n_iterations:
            self._neutral_fraction, self._jH, diag = self._step(
                emit, self._neutral_fraction, self._number_density)
            self.iteration += 1
            self.last_diagnostics = read_diagnostics(diag, self.total_diagnostics, self.log)
            self.last_diagnostics["packets_traced"] = (
                self.last_diagnostics["packets_traced"].reshape(self.tiling))
            traced = self.last_diagnostics["packets_traced"]
            self.log.info(
                f"iteration {self.iteration}/{n_iterations}: "
                f"{self.last_diagnostics['n_escaped']} escaped; "
                f"per-device traced skew max/mean = "
                f"{traced.max() / max(traced.mean(), 1):.2f}"
            )
            if diagnostics is not None:
                diagnostics.count("photons emitted", cfg.n_photons)
                diagnostics.count("photons escaped", self.last_diagnostics["n_escaped"])
                for d, n in enumerate(traced.reshape(-1)):
                    diagnostics.count(f"packets traced[device {d}]", int(n))
                diagnostics.end_iteration()
        return self.neutral_fraction

    def write_restart(self, manager) -> str:
        raise NotImplementedError(f"ShardedHOnlyIonizationSimulation: {RESTART_NOT_PORTED}")

    def load_restart(self, filename: str) -> None:
        raise NotImplementedError(f"ShardedHOnlyIonizationSimulation: {RESTART_NOT_PORTED}")

    stromgren_radius_analytic = HOnlyIonizationSimulation.stromgren_radius_analytic

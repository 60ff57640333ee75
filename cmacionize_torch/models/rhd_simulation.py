"""Radiation hydrodynamics: coupled MC photoionization + finite-volume hydro.

Port of the single-device ``cmacionize_tpu/models/rhd_simulation.py``
(``RHDSimulation``) for starbench-class problems: every step runs ``nloop``
Monte Carlo ionization iterations on the current density field (K1 on the
GPU), couples the ionization state to the gas energy through the
two-temperature scheme, then takes one MUSCL-Hancock hydro step (K3 on the
GPU).  A step reads nothing back to the host; ``run`` reads one scalar (the
CFL timestep) per block of up to 16 steps, as the JAX driver evaluates the
CFL once per fused block.

Random numbers come from one ``torch.Generator`` on the driver's device in
place of the JAX key chain, so the two drivers agree statistically, not bit
for bit.  The optional physics of the JAX driver (potentials, self-gravity,
cooling, masks, turbulence forcing, Bondi inflow, isothermal EOS,
time-dependent sources, stellar feedback), restart, statistics, diagnostics
and live output are not ported yet: switched on, they raise
``NotImplementedError`` (ROADMAP.md, queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.models import sources
from cmacionize_torch.models.density_functions import (
    NOT_PORTED,
    density_function_from_params,
)
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    RESTART_NOT_PORTED,
    _h_only_iteration_body,
)
from cmacionize_torch.ops import hydro, traversal
from cmacionize_torch.ops.riemann import _div
from cmacionize_torch.parallel import domain
from cmacionize_torch.parallel.drivers import (
    DIAGNOSTIC_COUNTS,
    mesh_devices,
    read_diagnostics,
    shard_generators,
)
from cmacionize_torch.parallel.mesh import LocalMesh
from cmacionize_torch.utils.logging import Log, NullLog
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_torch.utils.timeline import TimeLine

MYR = 3.156e13  # s, as the JAX driver's log lines use it
# steps between two CFL evaluations in ``run`` (the JAX driver's fused-chunk
# length, which sets how often it evaluates the CFL condition)
CFL_BLOCK_STEPS = 16


@dataclasses.dataclass(frozen=True)
class DensityBlock:
    """A BlockSyntax cube: constant density/temperature inside a box."""

    origin: Tuple[float, float, float]  # SI (center of the block)
    sides: Tuple[float, float, float]
    number_density: float  # m^-3
    temperature: float  # K


@dataclasses.dataclass(frozen=True)
class RHDConfig:
    geometry: GridGeometry
    gamma: float
    timestep: float  # s (fixed-dt fallback; also the TimeLine minimum)
    total_time: float  # s
    luminosity: float
    source_position: Tuple[float, float, float]
    cross_section: float
    recombination_rate: float
    n_photons: int
    nloop: int  # ionization iterations per radiation update
    background_density: float = 0.0  # m^-3
    background_temperature: float = 100.0
    blocks: Sequence[DensityBlock] = ()
    boundaries: Tuple = (
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
    )
    neutral_temperature: float = 100.0
    ionised_temperature: float = 1.0e4
    shock_temperature: float = 3.0e4
    radiative_heating: bool = True
    radiative_cooling: bool = False
    initial_neutral_fraction: float = 1.0
    # "HLLC" or "Exact": the flux solver
    riemann_solver: str = "HLLC"
    # time-loop controls; 0.0 → "unset": min/max collapse to ``timestep`` and
    # snapshots default to 0.1·total_time
    minimum_timestep: float = 0.0
    maximum_timestep: float = 0.0
    snapshot_time: float = 0.0
    radiation_time: float = -1.0  # <0 → radiation every hydro step
    cfl: float = 0.2


def _not_ported(what: str):
    return NotImplementedError(f"RHDSimulation: {what} is {NOT_PORTED}")


class RHDSimulation:
    """Driver for the coupled RHD time loop on one device."""

    STATE_FIELDS = ("rho", "mom_x", "mom_y", "mom_z", "energy", "neutral_fraction")

    def __init__(self, config: RHDConfig, device, log: Optional[Log] = None,
                 seed: int = 42, *, initial=None):
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError("cubic cells required")
        if config.riemann_solver not in hydro.RIEMANN_SOLVERS:
            raise ValueError(f"unknown Riemann solver {config.riemann_solver!r}")
        self.config = config
        self.device = torch.device(device)
        self.log = log or NullLog()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.geometry = geom
        self.dx = float(cell[0])

        # initial conditions in f64 numpy, cast to f32 as the JAX driver does:
        # DensityFields override, else background + blocks
        velocity = None
        if initial is not None:
            nd = np.asarray(initial.number_density, dtype=float)
            T = np.asarray(initial.temperature, dtype=float)
            if getattr(initial, "velocity", None) is not None:
                velocity = np.asarray(initial.velocity, dtype=float)
        else:
            centers = geom.cell_centers()
            nd = np.full(geom.shape, config.background_density)
            T = np.full(geom.shape, config.background_temperature)
            for block in config.blocks:
                origin = np.asarray(block.origin)
                half = 0.5 * np.asarray(block.sides)
                inside = np.all(np.abs(centers - origin) <= half, axis=-1)
                nd = np.where(inside, block.number_density, nd)
                T = np.where(inside, block.temperature, T)
        rho = nd * constants.PROTON_MASS
        pressure = nd * constants.BOLTZMANN * T
        zeros = np.zeros(geom.shape)
        vel = [velocity[..., a] if velocity is not None else zeros for a in range(3)]
        w = hydro.Primitives(*(self._tensor(f) for f in (rho, *vel, pressure)))
        self.state = hydro.conserved_from_primitives(w, config.gamma)
        self.neutral_fraction = torch.full(
            geom.shape, config.initial_neutral_fraction,
            dtype=torch.float32, device=self.device,
        )
        self.time = 0.0
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )
        self._lastsnap = 1
        self._lastrad = 0

    def _tensor(self, array) -> torch.Tensor:
        return torch.tensor(np.asarray(array, dtype=np.float32), device=self.device)

    def load_reference_state(self, arrays: dict, time: Optional[float] = None) -> None:
        """Continue from a state given as numpy arrays: the JAX driver's
        ``rho, mom_x, mom_y, mom_z, energy`` (``sim.state``) and
        ``neutral_fraction``, and optionally its ``time``."""
        fields = {}
        for name in self.STATE_FIELDS:
            value = np.asarray(arrays[name], dtype=np.float32)
            if value.shape != tuple(self.geometry.shape):
                raise ValueError(
                    f"{name}: shape {value.shape} != grid {self.geometry.shape}"
                )
            fields[name] = self._tensor(value)
        self.neutral_fraction = fields.pop("neutral_fraction")
        self.state = hydro.HydroState(**fields)
        if time is not None:
            self.time = float(time)

    # ----------------------------------------------------------- from_params

    @classmethod
    def from_params(cls, params: ParameterFile, device, log=None,
                    seed: int = 42) -> "RHDSimulation":
        """Build the driver from a parameter file, as the JAX
        ``RHDSimulation.from_params`` parses it.  Optional physics that the
        port does not carry yet raises ``NotImplementedError``."""
        config, initial = cls.config_from_params(params)
        return cls(config, device, log=log, seed=seed, initial=initial)

    @staticmethod
    def config_from_params(params: ParameterFile):
        """(RHDConfig, initial DensityFields or None) of a parameter file:
        the parsing half of :meth:`from_params`."""
        geom = GridGeometry.from_params(params)
        total_time = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:total time", "time", "0.141 Myr"
        )
        dt_min = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:minimum timestep", "time", "-1. s",
        )
        if dt_min < 0.0:
            dt_min = 1.0e-10 * total_time
        dt_max = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:maximum timestep", "time", "-1. s",
        )
        if dt_max < 0.0:
            dt_max = 0.1 * total_time
        snapshot_time = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:snapshot time", "time", "-1. s"
        )
        radiation_time = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:radiation time", "time", "-1. s"
        )
        cfl = params.get_number("HydroIntegrator:CFL constant", 0.2)
        # fixed-dt fallback for advance(): the explicit minimum when one is
        # given (starbench pins min == max), else total/2048
        dt = dt_min if params.has_value(
            "RadiationHydrodynamicsSimulation:minimum timestep"
        ) else total_time / 2048.0
        gamma = params.get_number("HydroIntegrator:polytropic index", 5.0 / 3.0)

        # ---- initial conditions
        initial = None
        blocks = []
        dftype = params.get_string("DensityFunction:type", "Homogeneous")
        if dftype == "Homogeneous":
            block_file = params.get_string("DensityFunction:filename", "")
            if block_file and os.path.exists(block_file):
                block_params = ParameterFile(block_file)
                for i in range(block_params.get_int("number of blocks", 0)):
                    prefix = f"block[{i}]"
                    blocks.append(DensityBlock(
                        origin=tuple(block_params.get_physical_vector(
                            f"{prefix}:origin", "length")),
                        sides=tuple(block_params.get_physical_vector(
                            f"{prefix}:sides", "length")),
                        number_density=block_params.get_physical_value(
                            f"{prefix}:number density", "number density"),
                        temperature=block_params.get_physical_value(
                            f"{prefix}:initial temperature", "temperature",
                            "100. K"),
                    ))
        else:
            initial = density_function_from_params(params, geom)

        # ---- boundaries
        names = {
            "periodic": hydro.BC_PERIODIC,
            "reflective": hydro.BC_REFLECTIVE,
            "inflow": hydro.BC_INFLOW,
            "outflow": hydro.BC_OUTFLOW,
        }
        bcs = []
        for side in ("x low", "x high", "y low", "y high", "z low", "z high"):
            value = params.get_string(f"HydroIntegrator:boundary {side}", "reflective")
            if value == "bondi":
                raise _not_ported("the Bondi inflow boundary")
            bcs.append(names[value])
        boundaries = tuple((bcs[2 * a], bcs[2 * a + 1]) for a in range(3))

        # ---- optional physics, not ported yet
        if params.has_value("BondiProfile:central mass"):
            raise _not_ported("BondiProfile")
        if gamma <= 1.0:
            raise _not_ported("the isothermal equation of state")
        switches = {
            "RadiationHydrodynamicsSimulation:use potential": "an external potential",
            "RadiationHydrodynamicsSimulation:use self gravity": "self-gravity",
            "RadiationHydrodynamicsSimulation:use cooling": "radiative cooling (De Rijcke)",
            "RadiationHydrodynamicsSimulation:use mask": "the hydro mask",
            "RadiationHydrodynamicsSimulation:use turbulent forcing": "turbulence forcing",
            "RadiationHydrodynamicsSimulation:use stellar feedback": "stellar feedback",
        }
        for key, what in switches.items():
            if params.get_bool(key, False):
                raise _not_ported(what)
        if params.has_value("TurbulenceForcing:forcing power"):
            raise _not_ported("turbulence forcing")
        sdtype = params.get_string("PhotonSourceDistribution:type", "SingleStar")
        if sdtype != "SingleStar":
            raise _not_ported(f"the {sdtype!r} source distribution")

        config = RHDConfig(
            geometry=geom,
            gamma=gamma,
            timestep=dt,
            total_time=total_time,
            luminosity=params.get_physical_value(
                "PhotonSourceDistribution:luminosity", "frequency", "1.e49 s^-1"),
            source_position=tuple(params.get_physical_vector(
                "PhotonSourceDistribution:position", "length", ["0. m"] * 3)),
            cross_section=params.get_physical_value(
                "CrossSections:hydrogen_0", "surface area", "6.3e-18 cm^2"),
            recombination_rate=params.get_physical_value(
                "RecombinationRates:hydrogen_1", "reaction rate",
                "2.7e-13 cm^3 s^-1"),
            n_photons=params.get_int(
                "RadiationHydrodynamicsSimulation:number of photons", 1000000),
            nloop=params.get_int(
                "RadiationHydrodynamicsSimulation:number of iterations", 10),
            background_density=params.get_physical_value(
                "DensityFunction:density", "number density", "0. m^-3"),
            background_temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "100. K"),
            blocks=blocks,
            boundaries=boundaries,
            radiative_heating=params.get_bool("HydroIntegrator:radiative heating", True),
            radiative_cooling=params.get_bool("HydroIntegrator:radiative cooling", False),
            riemann_solver=params.get_string(
                "HydroIntegrator:riemann solver type", "HLLC"),
            minimum_timestep=dt_min,
            maximum_timestep=dt_max,
            snapshot_time=snapshot_time,
            radiation_time=radiation_time,
            cfl=cfl,
        )
        return config, initial

    # ------------------------------------------------------------------ core

    def _radiation_update(self, number_density, neutral_fraction):
        """nloop MC ionization iterations on the current density field:
        emit → march (K1 on the GPU) → jH → H balance, on the device."""
        cfg = self.config
        sigma_dx = cfg.cross_section * self.dx
        jfac_scale = (
            cfg.luminosity * cfg.cross_section * self.dx
            / (cfg.n_photons * self.geometry.cell_volume)
        )
        for _ in range(cfg.nloop):
            px, py, pz, dx, dy, dz, tau, weight = sources.emit_point_source(
                self.generator, cfg.n_photons, self._source_gpos
            )
            packets = traversal.make_packets(
                torch.stack([px, py, pz], dim=1), torch.stack([dx, dy, dz], dim=1),
                tau, weight, self.geometry.shape,
            )
            neutral_fraction, _, _ = _h_only_iteration_body(
                packets, neutral_fraction, number_density,
                shape=self.geometry.shape, periodic=self.geometry.periodic,
                sigma_dx=sigma_dx, jfac_scale=jfac_scale,
                alpha=cfg.recombination_rate,
            )
        return neutral_fraction

    def _two_temperature_coupling(self, u, neutral_fraction):
        """Ionization → gas energy coupling (the pure per-cell op)."""
        cfg = self.config
        return hydro.two_temperature_coupling(
            u, neutral_fraction,
            gamma=cfg.gamma,
            ionised_temperature=cfg.ionised_temperature,
            neutral_temperature=cfg.neutral_temperature,
            shock_temperature=cfg.shock_temperature,
            radiative_heating=cfg.radiative_heating,
            radiative_cooling=cfg.radiative_cooling,
        )

    def _step(self, u, neutral_fraction, dt, do_radiation: bool = True):
        cfg = self.config
        if do_radiation and cfg.nloop > 0:
            # the floored density of primitives_from_conserved, alone
            number_density = _div(torch.clamp_min(u.rho, hydro.RHO_FLOOR), constants.PROTON_MASS)
            neutral_fraction = self._radiation_update(number_density, neutral_fraction)
            u = self._two_temperature_coupling(u, neutral_fraction)
        u = hydro.hydro_step(
            u, dt,
            boundaries=cfg.boundaries,
            cell_size=(self.dx,) * 3,
            gamma=cfg.gamma,
            riemann_solver=cfg.riemann_solver,
        )
        return u, neutral_fraction

    # ------------------------------------------------------------------- run

    def _log_state(self, tag):
        if isinstance(self.log, NullLog):
            return  # no host readback for a log nobody reads
        w = hydro.primitives_from_conserved(self.state, self.config.gamma)
        self.log.info(
            f"{tag} t={self.time / MYR:.4f} Myr "
            f"max|v|={float(torch.max(torch.abs(w.vx))):.3g} m/s "
            f"<xH>={float(torch.mean(self.neutral_fraction)):.3f}"
        )

    @staticmethod
    def _refuse(**hooks):
        for name, value in hooks.items():
            if value is not None:
                raise _not_ported(f"the {name} hook")

    def advance(self, n_steps: int, log_every: int = 50, restart_manager=None,
                statistics=None, diagnostics=None, dt: Optional[float] = None):
        """Advance ``n_steps`` MORE steps at fixed ``dt`` (default
        ``config.timestep``); the production loop is :meth:`run`."""
        self._refuse(restart_manager=restart_manager, statistics=statistics,
                     diagnostics=diagnostics)
        if dt is None:
            dt = self.config.timestep
        for step in range(n_steps):
            self._advance_steps(1, dt)
            self.time += dt
            if (step + 1) % log_every == 0 or step == n_steps - 1:
                self._log_state(f"step {step + 1}/{n_steps}")
        return self.state, self.neutral_fraction

    def _advance_steps(self, n_steps: int, dt, do_radiation: bool = True) -> None:
        """``n_steps`` steps at ``dt`` on the driver's state (no clock)."""
        for _ in range(n_steps):
            self.state, self.neutral_fraction = self._step(
                self.state, self.neutral_fraction, dt, do_radiation=do_radiation
            )

    def _cfl_timestep(self) -> float:
        """The CFL-limited timestep of the current state (one host read)."""
        cfg = self.config
        return float(hydro.cfl_timestep(
            self.state, (self.dx,) * 3, cfl=cfg.cfl, gamma=cfg.gamma))

    def _timestep_bounds(self):
        """(minimum, maximum) timestep of :meth:`run`; the fixed-dt fallback
        stands in for an unset bound, and a radiation time caps the step."""
        cfg = self.config
        dt_min = cfg.minimum_timestep or cfg.timestep
        dt_max = cfg.maximum_timestep or cfg.timestep
        if cfg.radiation_time > 0:
            dt_max = min(dt_max, cfg.radiation_time)
        return dt_min, max(dt_max, dt_min)  # an explicit minimum wins

    def timeline(self) -> TimeLine:
        """A fresh TimeLine of :meth:`run` over [0, total_time]."""
        return TimeLine(0.0, self.config.total_time, *self._timestep_bounds())

    def run(self, log_every: int = 50, restart_manager=None, statistics=None,
            diagnostics=None, snapshot_callback=None, live_output=None):
        """Run the configured workload to ``total_time``.

        The JAX driver's production loop: the CFL timestep is evaluated once
        per block of at most 16 steps and fed through a power-of-two
        :class:`TimeLine`; ``snapshot_callback(sim, index)`` fires every
        ``snapshot time`` (default total/10) and once at the end; with
        ``radiation_time`` > 0 the MC update runs only when due.
        """
        self._refuse(restart_manager=restart_manager, statistics=statistics,
                     diagnostics=diagnostics, live_output=live_output)
        cfg = self.config
        total = cfg.total_time
        snaptime = cfg.snapshot_time if cfg.snapshot_time > 0 else 0.1 * total
        radtime = cfg.radiation_time
        _, dt_max = self._timestep_bounds()
        timeline = self.timeline()
        if self.time > 0.0:  # resumed mid-run
            timeline.restore(self.time)

        step_num = 0
        while not timeline.finished:
            requested = self._cfl_timestep()
            dt = timeline.set_timestep(min(requested, dt_max))
            if dt > requested * 1.01:
                self.log.warning(
                    f"CFL violation: minimum timestep {dt:.3e} s exceeds "
                    f"CFL-limited {requested:.3e} s")
            # steps until the next snapshot threshold / the end, at this dt
            remaining = max(total - self.time, 0.0)
            n_to_end = max(int(np.ceil(remaining / dt - 1e-9)), 1)
            t_snap = self._lastsnap * snaptime
            n_to_snap = (
                max(int(np.ceil((t_snap - self.time) / dt - 1e-9)), 1)
                if snapshot_callback is not None else n_to_end
            )
            if radtime < 0.0:
                n_block = min(CFL_BLOCK_STEPS, n_to_snap, n_to_end)
                self._advance_steps(n_block, dt)
            else:
                n_block = 1
                rad_due = self.time >= self._lastrad * radtime
                if rad_due and radtime > 0.0:
                    self._lastrad += 1
                self._advance_steps(1, dt, do_radiation=rad_due)
            for _ in range(n_block):
                timeline.advance()
            # host time follows the tick timeline exactly
            self.time = timeline.current_time
            step_num += n_block
            if step_num % log_every < n_block:
                self._log_state(f"step {step_num}")
            if (
                snapshot_callback is not None
                and self._lastsnap * snaptime <= self.time
                and not timeline.finished
            ):
                snapshot_callback(self, self._lastsnap)
                self._lastsnap += 1
        if snapshot_callback is not None and timeline.finished:
            snapshot_callback(self, self._lastsnap)
            self._lastsnap += 1
        return self.state, self.neutral_fraction

    # ------------------------------------------------------------- analysis

    def ionization_front_radius(self) -> float:
        """Radius of the ionized region around the source (m)."""
        xH = self.neutral_fraction.cpu().numpy()
        v_ion = float((xH < 0.5).sum()) * self.geometry.cell_volume
        # source at a box corner with reflective boundaries → the box models
        # one octant of the full sphere
        corner = all(
            abs(g) < 1e-6 or abs(g - s) < 1e-6
            for g, s in zip(self._source_gpos, self.geometry.shape)
        )
        if corner:
            v_ion *= 8.0
        return (3.0 * v_ion / (4.0 * np.pi)) ** (1.0 / 3.0)


class ShardedRHDSimulation(RHDSimulation):
    """Domain-decomposed RHD driver: the grid cut into x-slabs over a
    :class:`~cmacionize_torch.parallel.mesh.LocalMesh`, each step the slab
    MC exchange, the two-temperature coupling and the halo-exchange hydro
    step (``parallel/domain.py:make_domain_rhd_step``).

    Port of the JAX ``ShardedRHDSimulation``.  ``tiling=None`` means (number
    of devices, 1, 1), and only (N, 1, 1) tilings are taken; ``device=None``
    means the visible CUDA devices, ``device="cpu"`` puts every shard on the
    CPU.  Each shard draws from its own generator, so the run agrees with
    the single-device driver statistically.  ``state`` and
    ``neutral_fraction`` are the global arrays, gathered from and cut back
    into the shards when read or set.  It carries what its parent carries;
    restart raises ``NotImplementedError`` (ROADMAP.md, queue 1, item 3).
    ``supersteps`` records each step's supersteps, ``last_diagnostics`` the
    counters of the last block of steps, ``total_diagnostics`` their sums.
    """

    SPEC = ("x",)

    def __init__(self, config: RHDConfig, tiling=None, device=None,
                 log: Optional[Log] = None, seed: int = 42, *, initial=None):
        devices = mesh_devices(device)
        if tiling is None:
            tiling = (len(devices), 1, 1)
        tiling = tuple(int(t) for t in tiling)
        if tiling[1] != 1 or tiling[2] != 1:
            raise NotImplementedError(
                "the sharded RHD driver shards x-slabs; use tiling [N, 1, 1]")
        self.tiling = tiling
        self.n_devices = tiling[0]
        self.mesh = LocalMesh((tiling[0],), self.SPEC, devices)
        super().__init__(config, self.mesh.devices[0], log=log, seed=seed, initial=initial)
        self.generators = shard_generators(seed, self.mesh.devices)
        cfg = config
        factory = dict(
            global_shape=self.geometry.shape,
            boundaries=cfg.boundaries,
            cell_size=(self.dx,) * 3,
            gamma=cfg.gamma,
            n_photons=cfg.n_photons,
            sigma_dx=cfg.cross_section * self.dx,
            source_gpos=self._source_gpos,
            jfac_scale=(cfg.luminosity * cfg.cross_section * self.dx
                        / (cfg.n_photons * self.geometry.cell_volume)),
            alpha=cfg.recombination_rate,
            coupling=dict(
                ionised_temperature=cfg.ionised_temperature,
                neutral_temperature=cfg.neutral_temperature,
                shock_temperature=cfg.shock_temperature,
                radiative_heating=cfg.radiative_heating,
                radiative_cooling=cfg.radiative_cooling,
            ),
            riemann_solver=cfg.riemann_solver,
        )
        self._rhd_step = domain.make_domain_rhd_step(self.mesh, nloop=cfg.nloop, **factory)
        # the radiation-gated variant (radiation_time cadence): nloop = 0
        self._rhd_step_norad = domain.make_domain_rhd_step(self.mesh, nloop=0, **factory)
        self._cfl_fn = domain.domain_cfl_timestep(
            self.mesh, cell_size=(self.dx,) * 3, gamma=cfg.gamma, cfl=cfg.cfl)
        self._emit = domain.emit_from(self.generators)
        self.supersteps = []
        self.last_diagnostics = None
        self.total_diagnostics = dict.fromkeys(DIAGNOSTIC_COUNTS, 0)

    # the global view of the sharded state
    @property
    def state(self) -> hydro.HydroState:
        return hydro.HydroState(*(
            self.mesh.unshard([u[f] for u in self._u], self.SPEC) for f in range(5)))

    @state.setter
    def state(self, u: hydro.HydroState) -> None:
        parts = [self.mesh.shard(f, self.SPEC) for f in u]
        self._u = [hydro.HydroState(*fields) for fields in zip(*parts)]

    @property
    def neutral_fraction(self) -> torch.Tensor:
        return self.mesh.unshard(self._xh, self.SPEC)

    @neutral_fraction.setter
    def neutral_fraction(self, xh: torch.Tensor) -> None:
        self._xh = self.mesh.shard(xh, self.SPEC)

    @classmethod
    def from_params(cls, params: ParameterFile, tiling=None, device=None, log=None,
                    seed: int = 42) -> "ShardedRHDSimulation":
        """Parse the file as :meth:`RHDSimulation.from_params` does, then
        shard the driver, its initial state included."""
        config, initial = cls.config_from_params(params)
        return cls(config, tiling=tiling, device=device, log=log, seed=seed,
                   initial=initial)

    def _advance_steps(self, n_steps: int, dt, do_radiation: bool = True) -> None:
        step = self._rhd_step if do_radiation else self._rhd_step_norad
        total = None
        for _ in range(n_steps):
            self._u, self._xh, diag = step(self._emit, self._u, self._xh, dt)
            self.supersteps.append(diag["supersteps"])
            total = diag if total is None else {k: total[k] + diag[k] for k in diag}
        if total is not None:
            self._check_diag(total)

    def _cfl_timestep(self) -> float:
        return float(self._cfl_fn(self._u))

    def _check_diag(self, diag) -> None:
        """Keep a block's counters in ``last_diagnostics``, add them into
        ``total_diagnostics`` and log a nonzero overflow or truncation."""
        self.last_diagnostics = read_diagnostics(diag, self.total_diagnostics, self.log)

    def write_restart(self, manager) -> str:
        raise NotImplementedError(f"ShardedRHDSimulation: {RESTART_NOT_PORTED}")

    def load_restart(self, filename: str) -> None:
        raise NotImplementedError(f"ShardedRHDSimulation: {RESTART_NOT_PORTED}")


def spitzer_radius(t, stromgren_radius, sound_speed_ionized=12.85e3):
    """Spitzer D-type expansion law R(t) = R_St (1 + 7 c_i t / (4 R_St))^{4/7}
    (Bisbas et al. 2015 starbench, eq. 4)."""
    return stromgren_radius * (
        1.0 + 7.0 * sound_speed_ionized * t / (4.0 * stromgren_radius)
    ) ** (4.0 / 7.0)


def hosokawa_inutsuka_radius(t, stromgren_radius, sound_speed_ionized=12.85e3):
    """Hosokawa-Inutsuka expansion law (Bisbas et al. 2015, eq. 5)."""
    return stromgren_radius * (
        1.0
        + 7.0 * sound_speed_ionized * t / (4.0 * stromgren_radius) * np.sqrt(4.0 / 3.0)
    ) ** (4.0 / 7.0)

"""Multi-element Monte Carlo photoionization with the temperature balance.

Port of ``cmacionize_tpu/models/multifreq_simulation.py`` (the lexington
benchmark family, the reference's IonizationSimulation with its
TemperatureCalculator).  Per iteration, on one device:

    emit packets (bin from the spectrum CDF, per-packet σ_H/σ_He)
    → spectral march (K2 on the GPU; binned ℓ·w tally, H+He opacity)
    → diffuse re-emission generations (absorbed packets re-enter the march)
    → one f32 matrix product turns the binned tally into per-ion
      mean-intensity and heating integrals
    → the per-cell coupled H/He/metal ionization solve, with the
      log-secant temperature balance from ``minimum_iteration_number`` on:
      f64 (K4 on the GPU), or with ``TemperatureCalculator: backend:
      f32-device`` the scaled f32 solve (K4f on the GPU).

The march runs in f32, the solves in f64 (the f32 backend rounds its inputs
to f32 and widens its results), all on the device the driver is given; there
is no default device.  The source spectrum is a Planck curve, a line, or a
tabulated stellar atmosphere (``models/atmosphere_spectra.py``).  Optional:
a :class:`~cmacionize_torch.models.trackers.TrackerManager` fed the binned
tally of each iteration (``tracker_manager``), typed cell trackers fed every
marched generation (:meth:`attach_cell_trackers`), and per-iteration
diagnostics (``run(diagnostics=)``).  Left out of the JAX driver, because they
are bookkeeping for the TPU: the 2^19-packet batch split (the port marches
all packets at once), the width compaction of the re-emission generations
(K2 takes the full-width batch with the re-emission mask as its active
flags; no packet is dropped, so there is no overflow to count) and the
staged compaction of the temperature solve (a K4 thread stops when its cell
converges).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.models import atmosphere_spectra, ions, reemission, sources
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import cross_sections, ionization, recombination, temperature
from cmacionize_torch.ops import traversal
from cmacionize_torch.utils.logging import Log, NullLog

ATMOSPHERE_SPECTRA = ("wmbasic", "castellikurucz", "pegase3", "popstar")
# state of cells without gas: neutral, with the neutral-metal slots at 1
NEUTRAL_ONE = ("H_n", "He_n", "N_n", "O_n", "Ne_n")


def solve_cell_state(j, h, nd, T_prev, abundances, do_temp, pahfac=0.0, crfac=0.0,
                     fixed_alpha=None, backend="f64-host"):
    """Per-cell coupled ionization (+ temperature) solve on flat or shaped
    f64 tensors of one shape.

    j: dict ion → photoionization rate (s⁻¹); h: (hH, hHe) heating integrals;
    nd: number density; T_prev: the previous temperature.  With ``do_temp``
    the temperature balance runs: with ``backend == "f32-device"`` (and no
    FixedValue rates) the scaled f32 solve on j, h, nd and T_prev rounded to
    f32, its results widened to f64 (K4f on CUDA tensors); with any other
    backend string the f64 solve (K4 on CUDA tensors), as in the JAX
    package.  Otherwise T stays and the ionization state follows at T (or
    at the FixedValue rates ``fixed_alpha``), with cells without radiation
    set neutral.  Cells without gas are pinned neutral at 500 K.

    Returns (T, xion dict, sweeps): ``sweeps`` holds the secant sweeps of
    each cell, or is None without the temperature balance.
    """
    sweeps = None
    if do_temp and backend == "f32-device" and fixed_alpha is None:
        T, h0, he0, metals, sweeps = temperature.solve_temperature_device(
            T_prev, j, h, nd, abundances, pahfac=pahfac, crfac=crfac)
        T, h0, he0 = (value.to(torch.float64) for value in (T, h0, he0))
        metals = {name: value.to(torch.float64) for name, value in metals.items()}
    elif do_temp:
        T, h0, he0, metals, sweeps = temperature.solve_temperature(
            T_prev, j, h, nd, abundances, pahfac=pahfac, crfac=crfac)
    else:
        T = T_prev
        AHe = abundances["He"]
        if fixed_alpha is not None:
            fa = dict(fixed_alpha)
            alphaH = torch.full_like(T, fa.get("H_n", 0.0))
            # zero alphaHe is degenerate in the coupled solve; with inert He
            # (AHe == 0) its value is irrelevant, so keep it finite
            alphaHe = torch.full_like(T, max(fa.get("He_n", 0.0), 1e-30))
            # the floor avoids 0/0 for ions with sigma = alpha = 0
            alphas = {
                name: torch.full_like(T, max(fa.get(name, 0.0), 1e-300))
                for name in ions.METAL_NAMES
            }
        else:
            alphaH = recombination.recombination_rate("H_n", T)
            alphaHe = recombination.recombination_rate("He_n", T)
            alphas = {name: recombination.recombination_rate(name, T)
                      for name in ions.METAL_NAMES}
        h0, he0 = ionization.hydrogen_helium_neutral_fractions(
            j["H_n"], j["He_n"], nd, AHe, T, alphaH, alphaHe)
        ne = nd * (1.0 - h0 + AHe * (1.0 - he0))
        metals = ionization.metal_ion_fractions(
            {name: j[name] for name in ions.METAL_NAMES},
            ne, T, nd * h0, nd * he0 * AHe, nd * (1.0 - h0), alphas,
        )
        # cells without radiation are neutral
        no_j = j["H_n"] <= 0.0
        h0 = torch.where(no_j, 1.0, h0)
        he0 = torch.where(no_j, 1.0, he0)
        metals = {
            name: torch.where(no_j, 1.0 if name in NEUTRAL_ONE else 0.0, value)
            for name, value in metals.items()
        }

    xion = {"H_n": h0, "He_n": he0, **metals}
    # zero-density (cavity) cells carry no physical state; pin them neutral
    # so that NaNs cannot poison the opacity fields
    vacuum = nd <= 0.0
    xion = {
        name: torch.where(vacuum, 1.0 if name in NEUTRAL_ONE else 0.0, value)
        for name, value in xion.items()
    }
    return torch.where(vacuum, 500.0, T), xion, sweeps


# reference parameter names of the FixedValue / Bimodal microphysics
_SIGMA_PARAM_NAMES = {
    "H_n": "hydrogen_0", "He_n": "helium_0",
    "C_p1": "carbon_1", "C_p2": "carbon_2",
    "N_n": "nitrogen_0", "N_p1": "nitrogen_1", "N_p2": "nitrogen_2",
    "O_n": "oxygen_0", "O_p1": "oxygen_1",
    "Ne_n": "neon_0", "Ne_p1": "neon_1",
    "S_p1": "sulphur_1", "S_p2": "sulphur_2", "S_p3": "sulphur_3",
}
_ALPHA_PARAM_NAMES = {
    "H_n": "hydrogen_1", "He_n": "helium_1",
    "C_p1": "carbon_2", "C_p2": "carbon_3",
    "N_n": "nitrogen_1", "N_p1": "nitrogen_2", "N_p2": "nitrogen_3",
    "O_n": "oxygen_1", "O_p1": "oxygen_2",
    "Ne_n": "neon_1", "Ne_p1": "neon_2",
    "S_p1": "sulphur_2", "S_p2": "sulphur_3", "S_p3": "sulphur_4",
}


@dataclasses.dataclass(frozen=True)
class MultiFreqConfig:
    geometry: GridGeometry
    number_density: float
    initial_temperature: float
    source_position: Tuple[float, float, float]
    luminosity: float
    spectrum_type: str  # "planck" | "monochromatic" | a tabulated family
    spectrum_temperature: float  # for planck
    spectrum_frequency: float  # for monochromatic
    n_photons: int
    n_iterations: int
    abundances: Dict[str, float]
    do_temperature: bool = True
    minimum_iteration_number: int = 3  # the T-solve only from this loop on
    #: "f64-host" (the f64 solve, K4) or "f32-device" (the scaled f32 solve,
    #: K4f); any other string runs the f64 solve, as in the JAX package
    #: (parameter file: ``TemperatureCalculator: backend``)
    temperature_backend: str = "f64-host"
    diffuse_field: bool = True
    n_bins: int = 128
    n_reemission_rounds: int = 8
    pahfac: float = 0.0
    crfac: float = 0.0
    initial_neutral_fraction: float = 1.0e-6
    # (frequencies, cdf) arrays of a tabulated atmosphere spectrum (WMBasic,
    # CastelliKurucz, Pegase3, PopStar), read by from_params
    spectrum_table: Optional[Tuple] = None
    # FixedValue microphysics: frequency-independent cross sections and
    # temperature-independent recombination rates, keyed by ion name
    fixed_sigma: Optional[Tuple] = None  # ((name, value_m2), ...)
    fixed_alpha: Optional[Tuple] = None  # ((name, value_m3_s), ...)
    # Bimodal cross sections: per-ion (low, high) values switching at a
    # frequency limit
    bimodal_sigma: Optional[Tuple] = None  # (nu_limit, ((name, lo, hi), ...))

    @classmethod
    def from_params(cls, params) -> "MultiFreqConfig":
        """The configuration of a parameter file, as the JAX ``from_params``
        reads it.  What this port defers raises ``NotImplementedError``: the
        ``TrackerManager`` block (the command line's), ``Parallel``
        (ROADMAP.md queue 1, item 7) and ``RestartManager`` (item 3)."""
        for block in ("TrackerManager", "Parallel", "RestartManager"):
            if params.has_value(block):
                raise NotImplementedError(
                    f"{block}: block not ported yet (ROADMAP.md, queue 1)")
        geometry = GridGeometry.from_params(params)
        spectrum_type = params.get_string("PhotonSourceSpectrum:type", "Planck").lower()
        spectrum_table = None
        if spectrum_type in ATMOSPHERE_SPECTRA:
            table = atmosphere_spectra.atmosphere_spectrum_from_params(params)
            spectrum_table = (table.frequencies, table.cdf)
        abund = dict(ions.DEFAULT_ABUNDANCES)
        for element in abund:
            for key in (f"Abundances:{element}", f"AbundanceModel:{element}"):
                if params.has_value(key):
                    abund[element] = params.get_number(key)

        fixed_sigma = bimodal_sigma = fixed_alpha = None
        xsec_type = params.get_string("CrossSections:type", "Verner")
        if xsec_type == "FixedValue":
            fixed_sigma = tuple(
                (name, params.get_physical_value(
                    f"CrossSections:{pname}", "surface area", "0. m^2"))
                for name, pname in _SIGMA_PARAM_NAMES.items())
        elif xsec_type == "Bimodal":
            bimodal_sigma = (
                params.get_physical_value(
                    "CrossSections:frequency limit", "frequency", "15. eV"),
                tuple(
                    (name,
                     params.get_physical_value(
                         f"CrossSections:{pname}_low", "surface area", "0. m^2"),
                     params.get_physical_value(
                         f"CrossSections:{pname}_high", "surface area", "0. m^2"))
                    for name, pname in _SIGMA_PARAM_NAMES.items()),
            )
        if params.get_string("RecombinationRates:type", "Verner") == "FixedValue":
            fixed_alpha = tuple(
                (name, params.get_physical_value(
                    f"RecombinationRates:{pname}", "reaction rate", "0. m^3 s^-1"))
                for name, pname in _ALPHA_PARAM_NAMES.items())
        if fixed_sigma is not None and dict(fixed_sigma).get("He_n", 0.0) == 0.0:
            # inert helium (the stromgren family): no He opacity or balance
            abund["He"] = 0.0
        return cls(
            geometry=geometry,
            number_density=params.get_physical_value(
                "DensityFunction:density", "number density", "100. cm^-3"),
            initial_temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "8000. K"),
            source_position=tuple(params.get_physical_vector(
                "PhotonSourceDistribution:position", "length", ["0. m", "0. m", "0. m"])),
            luminosity=params.get_physical_value(
                "PhotonSourceDistribution:luminosity", "frequency", "4.26e49 s^-1"),
            spectrum_type=spectrum_type,
            spectrum_temperature=params.get_physical_value(
                "PhotonSourceSpectrum:temperature", "temperature", "40000. K"),
            spectrum_frequency=params.get_physical_value(
                "PhotonSourceSpectrum:frequency", "frequency", "13.6 eV"),
            n_photons=params.get_int("IonizationSimulation:number of photons", 1000000),
            n_iterations=params.get_int("IonizationSimulation:number of iterations", 20),
            abundances=abund,
            do_temperature=params.get_bool(
                "TemperatureCalculator:do temperature calculation", False),
            temperature_backend=params.get_string("TemperatureCalculator:backend", "f64-host"),
            diffuse_field=params.get_bool("IonizationSimulation:diffuse field", False),
            pahfac=params.get_number("TemperatureCalculator:PAH heating factor", 0.0),
            crfac=params.get_number(
                "TemperatureCalculator:cosmic ray heating factor", 0.0),
            spectrum_table=spectrum_table,
            fixed_sigma=fixed_sigma,
            fixed_alpha=fixed_alpha,
            bimodal_sigma=bimodal_sigma,
        )


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MultiFreqIonizationSimulation:
    """Driver of the multi-element photoionization loop on one device.

    After :meth:`run`, per iteration: ``phase_seconds`` holds (transport,
    solve) host-clock seconds, each phase ending in a synchronise;
    ``reemitted`` the re-emitted packets of each generation (a device
    tensor); ``sweeps`` the secant sweeps of every cell of each temperature
    solve (device tensors).

    ``tracker_manager``, when set to a
    :class:`~cmacionize_torch.models.trackers.TrackerManager`, accumulates
    the binned tally of every iteration.
    """

    def __init__(self, config: MultiFreqConfig, device, log: Optional[Log] = None,
                 seed: int = 42, density=None, initial_temperature=None):
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError("cubic cells required")
        self.config = config
        self.device = torch.device(device)
        self.log = log or NullLog()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.iteration = 0  # completed iterations
        self.geometry = geom
        self.dx = float(cell[0])

        # frequency grid: uniform bins over the ionizing range
        nu_min = reemission.NU_MIN
        self.bin_edges = np.linspace(nu_min, 4.0 * nu_min, config.n_bins + 1)
        self.bin_centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        # per-ion cross sections at the bin centres [n_ion, n_bins]
        if config.fixed_sigma is not None:
            fixed = dict(config.fixed_sigma)
            self.sigma_table = np.stack([
                np.full(config.n_bins, fixed.get(name, 0.0)) for name in ions.ION_NAMES])
        elif config.bimodal_sigma is not None:
            nu_limit, rows = config.bimodal_sigma
            table = {name: (lo, hi) for name, lo, hi in rows}
            self.sigma_table = np.stack([
                np.where(self.bin_centers < nu_limit,
                         table.get(name, (0.0, 0.0))[0], table.get(name, (0.0, 0.0))[1])
                for name in ions.ION_NAMES])
        else:
            self.sigma_table = cross_sections.tabulate_cross_sections(self.bin_centers)
        self.heating_weights = np.stack([
            self.sigma_table[ions.ION_H_n] * (self.bin_centers - constants.NU_ION_H),
            self.sigma_table[ions.ION_He_n] * (self.bin_centers - constants.NU_ION_HE),
        ])

        # the source spectrum as a distribution over the bins
        if config.spectrum_table is not None:
            pdf = sources.tabulated_bin_pdf(self.bin_edges, *config.spectrum_table)
        elif config.spectrum_type.startswith("mono"):
            pdf = sources.monochromatic_bin_pdf(self.bin_edges, config.spectrum_frequency)
        else:
            pdf = sources.planck_bin_pdf(self.bin_centers, config.spectrum_temperature)
        self.spectrum_cdf = sources.bin_cdf(pdf)
        self.spectra = reemission.ReemissionSpectra.build()

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        self._sig_h_tab = f32(self.sigma_table[ions.ION_H_n])
        self._sig_he_tab = f32(self.sigma_table[ions.ION_He_n])
        self._sigma_table32 = f32(self.sigma_table)
        self._heating32 = f32(self.heating_weights)
        self._spectrum_cdf32 = f32(self.spectrum_cdf)
        self._bin_edges32 = f32(self.bin_edges)
        self._spectra = self.spectra.on_device(self.device)

        # grid state: f32 density for the march, f64 temperature and
        # ionization state for the solves
        shape = geom.shape
        if density is not None:
            self.number_density = f32(density).reshape(shape)
        else:
            self.number_density = torch.full(
                shape, config.number_density, dtype=torch.float32, device=self.device)
        if initial_temperature is not None:
            self.temperature = torch.tensor(
                np.asarray(initial_temperature, np.float64), device=self.device
            ).reshape(shape)
        else:
            self.temperature = torch.full(
                shape, config.initial_temperature, dtype=torch.float64, device=self.device)
        self.xion = {
            name: torch.full(shape, config.initial_neutral_fraction,
                             dtype=torch.float64, device=self.device)
            for name in ions.ION_NAMES
        }
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position))
        self.j_fields = None
        self.phase_seconds = []
        self.reemitted = []
        self.sweeps = []
        self.tracker_manager = None
        self._cell_trackers = None

    def attach_cell_trackers(self, trackers) -> None:
        """Feed a :class:`~cmacionize_torch.models.trackers.CellTrackers` every
        marched generation from the next iteration on (it moves to the
        driver's device).  Not for periodic boxes: the segment estimator needs
        straight paths in cell coordinates."""
        if any(self.geometry.periodic):
            raise NotImplementedError("cell trackers require a non-periodic box")
        self._cell_trackers = trackers.to(self.device)

    def load_reference_state(self, xion, temperature, number_density) -> None:
        """Continue from a state given as numpy arrays (for example the JAX
        simulation's ``xion`` dict, ``temperature`` and ``number_density``)."""
        shape = tuple(self.geometry.shape)

        def tensor(value, dtype):
            value = np.asarray(value)
            if value.shape != shape:
                raise ValueError(f"state shape {value.shape} != grid {shape}")
            return torch.tensor(value, dtype=dtype, device=self.device)

        self.xion = {name: tensor(xion[name], torch.float64) for name in ions.ION_NAMES}
        self.temperature = tensor(temperature, torch.float64)
        self.number_density = tensor(number_density, torch.float32)

    # ---------------------------------------------------------------- MC core

    def _track(self, before, after, valid, slot) -> None:
        """Add one marched generation to the cell trackers, if attached."""
        trackers = self._cell_trackers
        if trackers is None:
            return

        def stack(batch, *fields):
            return torch.stack([getattr(batch, f) for f in fields], 1)

        trackers.accumulate(*trackers.contributions(
            stack(before, "px", "py", "pz"), stack(before, "dx", "dy", "dz"),
            stack(after, "px", "py", "pz"), before.fbin, before.weight, valid, slot,
        ))

    def _mc_shoot(self, xH, xHe, T):
        """Emit + march + re-emission generations → ([n_ion+2, ncell]
        integrals in raw Σ ℓσw units, [generations] re-emitted counts).
        The binned tally goes to ``tracker_manager`` and every generation to
        the cell trackers, where they are set."""
        cfg = self.config
        shape = self.geometry.shape
        ncell = self.geometry.n_cells
        nd = self.number_density
        AHe = cfg.abundances["He"]
        gen = self.generator
        n = cfg.n_photons

        xH32 = xH.to(torch.float32).reshape(-1)
        xHe32 = xHe.to(torch.float32).reshape(-1)
        T32 = T.to(torch.float32).reshape(-1)
        chi_h = (nd.reshape(-1) * xH32 * self.dx).contiguous()
        chi_he = (nd.reshape(-1) * AHe * xHe32 * self.dx).contiguous()

        fbin = sources.sample_bins(gen, n, self._spectrum_cdf32)
        px, py, pz, dx, dy, dz, tau, weight = sources.emit_point_source(
            gen, n, self._source_gpos)
        packets = traversal.make_spectral_packets(
            torch.stack([px, py, pz], 1), torch.stack([dx, dy, dz], 1), tau, weight,
            self._sig_h_tab[fbin], self._sig_he_tab[fbin], fbin, shape,
        )
        tally2d = torch.zeros(cfg.n_bins * ncell, dtype=torch.float32, device=self.device)
        march = dict(shape=shape, n_bins=cfg.n_bins, periodic=self.geometry.periodic)
        emitted = packets
        tally2d, packets = traversal.trace_packets_spectral(
            chi_h, chi_he, packets, tally2d, **march)
        self._track(emitted, packets, torch.ones_like(packets.active),
                    torch.zeros_like(packets.fbin))

        reemitted = []
        if cfg.diffuse_field:
            for _ in range(cfg.n_reemission_rounds):
                flat = torch.clamp(
                    (packets.cx * shape[1] + packets.cy) * shape[2] + packets.cz, 0, ncell - 1
                ).to(torch.int64)
                remask, new_freq, h_channel = reemission.reemit_batch(
                    gen, self._spectra, packets.absorbed, packets.sig_h, packets.sig_he,
                    xH32[flat], xHe32[flat], T32[flat], AHe,
                )
                ndx, ndy, ndz = sources.isotropic_directions(gen, n)
                ntau = sources.sample_tau_targets(gen, n)
                nbin = torch.clamp(
                    torch.searchsorted(self._bin_edges32, new_freq) - 1, 0, cfg.n_bins - 1
                ).to(torch.int32)
                # the full-width batch marches again; packets that were not
                # re-emitted are inactive and K2 returns for them at once
                packets = packets._replace(
                    dx=ndx, dy=ndy, dz=ndz, tau_left=ntau,
                    sig_h=self._sig_h_tab[nbin], sig_he=self._sig_he_tab[nbin], fbin=nbin,
                    active=remask, absorbed=torch.zeros_like(remask),
                )
                reemitted.append(remask.sum())
                emitted = packets
                tally2d, packets = traversal.trace_packets_spectral(
                    chi_h, chi_he, packets, tally2d, **march)
                # PHOTONTYPE slot: 1 diffuse H, 2 diffuse He
                self._track(emitted, packets, remask,
                            torch.where(h_channel, 1, 2).to(torch.int32))

        if self.tracker_manager is not None:
            self.tracker_manager.accumulate(tally2d)
        integrals = traversal.spectral_tallies_to_ion_integrals(
            tally2d, self._sigma_table32, self._heating32, ncell)
        counts = (torch.stack(reemitted) if reemitted
                  else torch.zeros(0, dtype=torch.int64, device=self.device))
        return integrals, counts

    # ------------------------------------------------------------ iterations

    def _solve_state(self, integrals, do_temp: bool):
        """Normalize the integrals and run the per-cell state solve (f64, on
        the driver's device).  Returns (T, xion, j, sweeps)."""
        cfg = self.config
        shape = self.geometry.shape
        jfac = cfg.luminosity * self.dx / (cfg.n_photons * self.geometry.cell_volume)
        hfac = jfac * constants.PLANCK
        integrals = integrals.to(torch.float64)
        j = {name: (integrals[i] * jfac).reshape(shape)
             for i, name in enumerate(ions.ION_NAMES)}
        h = (
            (integrals[ions.NUMBER_OF_IONS] * hfac).reshape(shape),
            (integrals[ions.NUMBER_OF_IONS + 1] * hfac).reshape(shape),
        )
        T, xion, sweeps = solve_cell_state(
            j, h, self.number_density.to(torch.float64), self.temperature,
            cfg.abundances, do_temp, pahfac=cfg.pahfac, crfac=cfg.crfac,
            fixed_alpha=cfg.fixed_alpha, backend=cfg.temperature_backend,
        )
        return T, xion, j, sweeps

    def run(self, n_iterations: Optional[int] = None, diagnostics=None):
        """Run iterations until ``n_iterations`` (total, default the
        config's) are done; returns (xion dict, temperature).

        ``diagnostics``: an optional
        :class:`~cmacionize_torch.utils.diagnostics.IterationDiagnostics`,
        given the "trace" and "solve" phases (timed to the device's
        synchronise) and the emitted packets and re-emission rounds of each
        iteration."""
        cfg = self.config
        n_iterations = n_iterations or cfg.n_iterations

        def phase(name):
            if diagnostics is None:
                return contextlib.nullcontext()
            return diagnostics.phase(name, synchronize=lambda: _synchronize(self.device))

        while self.iteration < n_iterations:
            loop = self.iteration
            # opacity fractions are physical: clamp the stored raw iterates
            xH = torch.clamp(self.xion["H_n"], 0.0, 1.0)
            xHe = torch.clamp(self.xion["He_n"], 0.0, 1.0)
            t0 = time.perf_counter()
            with phase("trace"):
                integrals, reemitted = self._mc_shoot(xH, xHe, self.temperature)
            _synchronize(self.device)
            t1 = time.perf_counter()
            if self._cell_trackers is not None:
                self._cell_trackers.end_iteration()
            do_temp = cfg.do_temperature and loop >= cfg.minimum_iteration_number
            with phase("solve"):
                self.temperature, self.xion, self.j_fields, sweeps = self._solve_state(
                    integrals, do_temp)
            _synchronize(self.device)
            t2 = time.perf_counter()
            self.phase_seconds.append((t1 - t0, t2 - t1))
            self.reemitted.append(reemitted)
            if sweeps is not None:
                self.sweeps.append(sweeps)
            if diagnostics is not None:
                diagnostics.count("photons emitted", cfg.n_photons)
                diagnostics.count("reemission rounds", cfg.n_reemission_rounds)
                diagnostics.end_iteration()
            self.iteration += 1
            if not isinstance(self.log, NullLog):
                self.log.info(
                    f"iteration {loop + 1}/{n_iterations}: "
                    f"<T> = {float(self.temperature.mean()):.1f} K, "
                    f"<xH> = {float(self.xion['H_n'].mean()):.4f}, "
                    f"re-emitted per generation {reemitted.tolist()}"
                )
        return self.xion, self.temperature

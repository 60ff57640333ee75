"""The port's photon trackers and iteration diagnostics against the JAX
package's.

Mirrors tests/test_aux.py's tracker tests (the TrackerManager, the segment
geometry against JAX ``segment_aabb_overlap``, typed trackers through a small
multi-frequency run) and its diagnostics tests (the counters and dumps, and
the H-only driver's hook), on ``cmacionize_torch/models/trackers.py`` and
``cmacionize_torch/utils/diagnostics.py``.  The driver runs are statistical
(the port's random stream is not JAX's); the geometry is held to JAX's on
the same numpy inputs.
"""

import time

import numpy as np
import pytest
import torch

from cmacionize_torch.models import ions, trackers
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_torch.utils.diagnostics import IterationDiagnostics
from cmacionize_tpu.models import trackers as jtrackers

PC = 3.086e16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tracker_manager(tmp_path):
    geometry = GridGeometry((-PC,) * 3, (2 * PC,) * 3, (8, 8, 8))
    edges = np.linspace(3.288e15, 4 * 3.288e15, 5)
    yaml_file = tmp_path / "trackers.yml"
    yaml_file.write_text(
        "positions:\n  - ['0. pc', '0. pc', '0. pc']\n  - ['0.5 pc', '0. pc', '0. pc']\n")
    manager = trackers.TrackerManager.from_yaml(geometry, str(yaml_file), edges)
    assert len(manager.cell_indices) == 2
    assert manager.cell_indices.tolist() == [(4 * 8 + 4) * 8 + 4, (6 * 8 + 4) * 8 + 4]
    # a synthetic spectral tally: bin b deposits b + 1 in every cell
    tally = np.repeat(np.arange(1, 5, dtype=np.float64), geometry.n_cells)
    manager.accumulate(torch.tensor(tally, dtype=torch.float32))
    manager.accumulate(tally)
    np.testing.assert_allclose(manager.spectra()[0], 2 * np.arange(1, 5))
    assert manager.n_iterations == 2
    out = tmp_path / "spectra.txt"
    manager.write(str(out))
    assert out.read_text().count("\n") == 5


def test_cell_tracker_geometry_matches_jax():
    """segment_aabb_overlap and cube_projected_area: the analytic cases of
    tests/test_aux.py:190, then 4096 random segments against 3 boxes on the
    same numpy inputs as JAX (f32 segments, f64 boxes as the JAX driver runs
    them under x64): overlaps within 1e-6 cells."""
    import jax.numpy as jnp

    origin = torch.tensor([[0.5, 0.5, 0.5]])
    direction = torch.tensor([[1.0, 0.0, 0.0]])
    lo = torch.tensor([[2.0, 0.0, 0.0]], dtype=torch.float64)
    hi = torch.tensor([[3.0, 1.0, 1.0]], dtype=torch.float64)
    for length, expected in ((10.0, 1.0), (1.0, 0.0), (2.0, 0.5)):
        ov = trackers.segment_aabb_overlap(origin, direction, torch.tensor([length]), lo, hi)
        np.testing.assert_allclose(ov.numpy(), [[expected]], atol=1e-6)
    ov = trackers.segment_aabb_overlap(
        torch.tensor([[0.5, 5.0, 0.5]]), direction, torch.tensor([10.0]), lo, hi)
    np.testing.assert_allclose(ov.numpy(), [[0.0]], atol=1e-6)
    assert float(trackers.cube_projected_area(1.0, 0.0, 0.0)) == 1.0
    d = 1.0 / np.sqrt(3.0)
    assert float(trackers.cube_projected_area(d, d, d)) == pytest.approx(np.sqrt(3.0))

    rng = np.random.default_rng(8)
    n = 4096
    o = np.float32(rng.uniform(0, 8, (n, 3)))
    v = rng.normal(size=(n, 3))
    v[:64, 1:] = 0.0  # axis-parallel: the degenerate-direction branch
    v = np.float32(v / np.linalg.norm(v, axis=1, keepdims=True))
    length = np.float32(rng.uniform(0, 6, n))
    boxes_lo = np.array([[3.0, 3.0, 3.0], [0.0, 4.0, 2.0], [7.0, 7.0, 7.0]])
    ref = np.asarray(jtrackers.segment_aabb_overlap(
        jnp.asarray(o), jnp.asarray(v), jnp.asarray(length), jnp.asarray(boxes_lo),
        jnp.asarray(boxes_lo + 1.0)))
    got = trackers.segment_aabb_overlap(
        torch.tensor(o), torch.tensor(v), torch.tensor(length), torch.tensor(boxes_lo),
        torch.tensor(boxes_lo + 1.0)).numpy()
    assert got.shape == (3, n) and (ref > 0).sum() > 50
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_cell_trackers_through_a_multifreq_run(tmp_path):
    """Typed trackers from a reference-format tracker file, driven through an
    8³ multi-frequency run with re-emission: all three PHOTONTYPE slots
    populate, the weighted spectrum sits within [1/√3, 1] of the counts,
    absorption volumes are positive where lengths were recorded, and the
    outputs are written in the reference layouts."""
    geometry = GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (8, 8, 8))
    tracker_file = tmp_path / "trackers.yml"
    tracker_file.write_text(
        "number of trackers: 3\n"
        "tracker[0]:\n  position: [1.9 pc, 0. pc, 0. pc]\n  type: Spectrum\n"
        "tracker[1]:\n  position: [1.9 pc, 0. pc, 0. pc]\n  type: WeightedSpectrum\n"
        "  output name: weighted.txt\n"
        "tracker[2]:\n  position: [0. pc, 1.9 pc, 0. pc]\n  type: Absorption\n")
    config = MultiFreqConfig(
        geometry=geometry, number_density=1e8, initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, spectrum_type="planck",
        spectrum_temperature=40000.0, spectrum_frequency=3.3e15, n_photons=4096,
        n_iterations=2, abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                                    "Ne": 5e-5, "S": 9e-6},
        do_temperature=False, diffuse_field=True, n_bins=8, n_reemission_rounds=2,
    )
    sim = MultiFreqIonizationSimulation(config, "cpu", seed=4)
    cell_trackers = trackers.CellTrackers.from_reference_yaml(
        geometry, str(tracker_file), sim.bin_edges)
    assert cell_trackers.n_track == 3
    sim.attach_cell_trackers(cell_trackers)
    manager = trackers.TrackerManager(geometry, [(1.9 * PC, 0.0, 0.0)], sim.bin_edges)
    sim.tracker_manager = manager
    sim.run(2)

    counts = cell_trackers.counts
    assert counts.shape == (3, 3, 8) and cell_trackers.n_iterations == 2
    assert counts[:, 0, :].sum() > 0
    assert counts[:, 1:, :].sum() > 0
    w, c = cell_trackers.weighted[1].sum(), counts[1].sum()
    assert c / np.sqrt(3.0) <= w <= c * 1.0001
    # trackers 0 and 1 watch the same cell: the same crossings
    np.testing.assert_array_equal(counts[0], counts[1])
    absorption = cell_trackers.absorption(sim.sigma_table)
    assert absorption.shape == (3, 3, len(ions.ION_NAMES))
    assert absorption[2, 0, ions.ION_H_n] > 0
    # the segment estimator's path lengths, over the three slots, are the
    # march's binned tally of the same cell (Σ ℓ·w in cell units), which the
    # TrackerManager gathered: equal up to f32 round-off (measured 8e-8)
    lengths = cell_trackers.lengths[0].sum(axis=0) / geometry.cell_size[0]
    np.testing.assert_allclose(lengths, manager.spectra()[0], rtol=1e-5, atol=1e-6)
    assert manager.n_iterations == 2
    written = cell_trackers.write_outputs(
        str(tmp_path), sigma_table=sim.sigma_table, ion_names=ions.ION_NAMES)
    assert len(written) == 3 and (tmp_path / "weighted.txt").exists()
    text = (tmp_path / "Tracker2.txt").read_text()
    assert text.startswith("# Ion") and "H_n" in text


def test_cell_trackers_refuse_a_periodic_box():
    geometry = GridGeometry((0.0,) * 3, (PC,) * 3, (4, 4, 4), periodic=(True, False, False))
    config = MultiFreqConfig(
        geometry=geometry, number_density=1e8, initial_temperature=8000.0,
        source_position=(0.5 * PC,) * 3, luminosity=1e48, spectrum_type="planck",
        spectrum_temperature=40000.0, spectrum_frequency=3.3e15, n_photons=64,
        n_iterations=1, abundances=dict(ions.DEFAULT_ABUNDANCES), do_temperature=False,
        n_bins=4)
    sim = MultiFreqIonizationSimulation(config, "cpu", seed=1)
    entries = [{"type": "Spectrum", "position": (0.5 * PC,) * 3, "output_name": "t.txt"}]
    with pytest.raises(NotImplementedError):
        sim.attach_cell_trackers(trackers.CellTrackers(geometry, entries, sim.bin_edges))


# ---------------------------------------------------------------- diagnostics


def test_diagnostics_counters_phases_and_dump(tmp_path):
    diag = IterationDiagnostics(folder=str(tmp_path))
    diag.count("photons emitted", 1000)
    diag.count("photons emitted", 500)
    synced = []
    with diag.phase("trace", synchronize=lambda: synced.append(time.time())):
        time.sleep(0.01)
    assert len(synced) == 2
    diag.record_superstep(10, 20)
    rec = diag.end_iteration()
    assert rec["counters"]["photons emitted"] == 1500
    assert rec["counters"]["packets exchanged"] == 30
    assert rec["phase_s"]["trace"] >= 0.01
    text = (tmp_path / "diagnostics_00.txt").read_text()
    assert "photons emitted: 1500" in text and "trace:" in text
    diag.count("photons emitted", 1)
    assert diag.end_iteration()["counters"]["photons emitted"] == 1
    assert (tmp_path / "diagnostics_01.txt").exists()


def test_h_only_driver_diagnostics(tmp_path):
    box = 1.0e17
    config = HOnlyConfig(
        geometry=GridGeometry((0, 0, 0), (box,) * 3, (8, 8, 8)),
        number_density=1e8, temperature=8000.0, source_position=(box / 2,) * 3,
        luminosity=1e48, cross_section=6.3e-22, recombination_rate=2.7e-19,
        n_photons=1000, n_iterations=2,
    )
    diag = IterationDiagnostics(folder=str(tmp_path))
    sim = HOnlyIonizationSimulation(config, "cpu", seed=1)
    sim.run(diagnostics=diag)
    assert len(diag.history) == 2
    c = diag.history[0]["counters"]
    assert c["photons emitted"] == 1000
    assert c["photons absorbed"] + c["photons escaped"] == 1000
    assert [h["counters"]["photons escaped"] for h in diag.history] == sim.n_escaped.tolist()
    assert "iteration" in diag.history[0]["phase_s"]
    assert (tmp_path / "diagnostics_01.txt").exists()


def test_multifreq_driver_diagnostics():
    geometry = GridGeometry((-1.5 * PC,) * 3, (3 * PC,) * 3, (8, 8, 8))
    config = MultiFreqConfig(
        geometry=geometry, number_density=1e8, initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=1e49, spectrum_type="planck",
        spectrum_temperature=40000.0, spectrum_frequency=3.3e15, n_photons=2000,
        n_iterations=2, abundances=dict(ions.DEFAULT_ABUNDANCES), do_temperature=False,
        n_bins=16, n_reemission_rounds=2)
    diag = IterationDiagnostics()
    MultiFreqIonizationSimulation(config, "cpu", seed=2).run(diagnostics=diag)
    assert [h["counters"] for h in diag.history] == [
        {"photons emitted": 2000.0, "reemission rounds": 2.0}] * 2
    assert set(diag.history[1]["phase_s"]) == {"trace", "solve"}

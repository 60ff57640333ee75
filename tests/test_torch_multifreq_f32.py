"""The port's multi-frequency driver with the f32 temperature backend.

``TemperatureCalculator: backend: f32-device`` runs the scaled f32 solve
(K4f's plain version on the CPU).  Mirror of tests/test_multifreq.py:113-162:
the same lexington-mini through the f64 and the f32 backends of the port,
from one seed, held to that test's bands.  Kept apart from
test_torch_multifreq.py so that the two files' runs spread over the test
workers.
"""

import numpy as np
import pytest
import torch

from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)

PC = 3.086e16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_f32_device_backend_matches_host():
    """tests/test_multifreq.py:113-162 on the port: a 16³ lexington-mini
    (3e4 packets, 6 iterations, 32 bins, no re-emission), the f32 backend
    against the f64 one from the same seed.  Both runs draw the same random
    numbers, so over the ionized cells (xH < 0.5 in the f64 run) the median
    |ΔT|/T must be < 5e-3 and its 95% quantile < 3e-2, the ionized cell
    counts within max(2%, 5) and the median O_n within 5% / 1e-4."""
    geometry = GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (16, 16, 16))
    common = dict(
        geometry=geometry, number_density=1e8, initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, spectrum_type="planck",
        spectrum_temperature=40000.0, spectrum_frequency=3.3e15, n_photons=30000,
        n_iterations=6, abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                                    "Ne": 5e-5, "S": 9e-6},
        do_temperature=True, diffuse_field=False, n_bins=32,
    )
    runs = {}
    for backend in ("f64-host", "f32-device"):
        sim = MultiFreqIonizationSimulation(
            MultiFreqConfig(**common, temperature_backend=backend), "cpu", seed=21)
        xion, T = sim.run(6)
        runs[backend] = ({k: v.numpy() for k, v in xion.items()}, T.numpy(), sim)
    (xion_h, T_h, _), (xion_d, T_d, sim_d) = runs["f64-host"], runs["f32-device"]
    assert T_d.dtype == np.float64 and len(sim_d.sweeps) == 3
    ion = xion_h["H_n"].ravel() < 0.5
    rel = np.abs(T_d.ravel()[ion] - T_h.ravel()[ion]) / T_h.ravel()[ion]
    assert np.median(rel) < 5e-3, np.median(rel)
    assert np.quantile(rel, 0.95) < 3e-2, np.quantile(rel, 0.95)
    v_h, v_d = (xion_h["H_n"] < 0.5).sum(), (xion_d["H_n"] < 0.5).sum()
    assert abs(v_d - v_h) <= max(0.02 * v_h, 5)
    o_h, o_d = xion_h["O_n"].ravel()[ion], xion_d["O_n"].ravel()[ion]
    np.testing.assert_allclose(np.median(o_d), np.median(o_h), rtol=0.05, atol=1e-4)

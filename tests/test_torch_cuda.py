"""K1 and the port's driver on the card (marked ``cuda``).

K1 is CUDA C++ with no CPU mode, so these tests skip where CUDA is missing;
the plain version they compare against is tested against the JAX package in
test_torch_traversal.py.  The file imports no JAX, so that it runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cmacionize_torch import kernels
from cmacionize_torch.kernels.trace_packets import trace_packets_cuda
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.ops import traversal

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _inputs(seed, shape, n, chi_neutral, device):
    """Strömgren-like opacity with an ionized cone and isotropic packets from
    the grid centre, made with numpy."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, np.float64) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0))
    x = np.where(r < 0.7 * centre.min(), rng.uniform(1.5e-3, 4.5e-3, shape), 1.0)
    x = np.where(offset[2] > r * np.cos(np.radians(25.0)), 1e-5, x)
    cos_t = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    position = centre[None, :] + 1e-4 * direction
    tau = -np.log1p(-rng.uniform(0.0, 1.0, n))
    weight = rng.uniform(0.5, 1.5, n)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    chi = t((chi_neutral * x).reshape(-1))
    return chi, traversal.make_packets(t(position), t(direction), t(tau), t(weight), shape)


@pytest.mark.parametrize(
    "shape, periodic, chi_neutral, max_steps",
    [
        ((64, 64, 64), (False, False, False), 300.0, 0),
        ((24, 24, 24), (False, False, False), 30.0, 0),
        ((16, 16, 16), (True, True, True), 0.3, 0),
        ((24, 16, 20), (True, False, True), 0.3, 0),
        ((16, 16, 16), (False, False, False), 0.3, 5),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, periodic, chi_neutral, max_steps):
    chi, packets = _inputs(0, shape, 20_000, chi_neutral, cuda)
    before = kernels.LAUNCHES["trace_packets"]
    tally_k, out_k = traversal.trace_packets(
        chi, packets, torch.zeros_like(chi), shape=shape, periodic=periodic,
        max_steps=max_steps,
    )
    assert kernels.LAUNCHES["trace_packets"] == before + 1
    tally_r, out_r = traversal.trace_packets_reference(
        chi, packets, torch.zeros_like(chi), shape=shape, periodic=periodic,
        max_steps=max_steps,
    )
    torch.cuda.synchronize()
    # same f32 operations per packet: flags, cells and positions match
    for f in ("absorbed", "active", "cx", "cy", "cz"):
        assert torch.equal(getattr(out_k, f), getattr(out_r, f)), f
    for f in ("px", "py", "pz", "tau_left"):
        diff = float((getattr(out_k, f) - getattr(out_r, f)).abs().max())
        assert diff <= 5e-4, (f, diff)
    # atomics add in another order: f32 round-off only
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4
    # the input batch is left as it was
    assert bool(packets.active.all()) and not bool(packets.absorbed.any())


def test_inactive_and_outside_packets_are_frozen(cuda):
    shape = (4, 4, 4)
    packets = traversal.make_packets(
        torch.tensor([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]], device=cuda),
        torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=cuda),
        torch.tensor([0.5, 0.5], device=cuda), torch.ones(2, device=cuda), shape,
    )
    packets = packets._replace(
        active=torch.tensor([False, True], device=cuda),
        cx=torch.tensor([1, 7], dtype=torch.int32, device=cuda),
    )
    tally, out = traversal.trace_packets(
        torch.ones(64, device=cuda), packets, torch.zeros(64, device=cuda), shape=shape
    )
    assert float(tally.sum()) == 0.0
    assert not bool(out.active.any()) and not bool(out.absorbed.any())
    assert torch.equal(out.px, packets.px) and torch.equal(out.cx, packets.cx)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    shape = (8, 8, 8)
    chi, packets = _inputs(1, shape, 64, 1.0, cuda)
    fields = packets._asdict()
    with pytest.raises(ValueError, match="opacity"):
        trace_packets_cuda(
            chi.double(), torch.zeros_like(chi), fields,
            shape=shape, periodic=(False,) * 3, max_steps=96,
        )
    with pytest.raises(ValueError, match="contiguous"):
        bad = dict(fields, px=torch.stack([packets.px, packets.py], 1)[:, 0])
        trace_packets_cuda(
            chi, torch.zeros_like(chi), bad,
            shape=shape, periodic=(False,) * 3, max_steps=96,
        )


def test_mini_stromgren_on_card(cuda):
    pc = 3.086e16
    config = HOnlyConfig(
        geometry=GridGeometry(anchor=(-5 * pc,) * 3, sides=(10 * pc,) * 3, shape=(24, 24, 24)),
        number_density=1e8, temperature=8000.0, source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49, cross_section=6.3e-22, recombination_rate=4e-19,
        n_photons=20000, n_iterations=8,
    )
    kernels.LAUNCHES.clear()
    sim = HOnlyIonizationSimulation(config, device=cuda, seed=7)
    xH = sim.run().cpu().numpy()
    assert kernels.LAUNCHES["trace_packets"] == 8
    assert sim.n_escaped.device.type == "cuda" and sim.n_escaped.shape == (8,)
    v_ion = (xH < 0.5).sum() * config.geometry.cell_volume
    r = (3 * v_ion / (4 * np.pi)) ** (1 / 3)
    assert r == pytest.approx(sim.stromgren_radius_analytic(), rel=0.1)
    assert xH[12, 12, 12] < 1e-4 and xH[0, 0, 0] > 0.99

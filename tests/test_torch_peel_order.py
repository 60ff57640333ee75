"""The peel-off's independence of the events' order, on the CPU.

K8 adds each event's contribution into its pixel with an atomic, so its
image sums the events in an order of the card's choosing, and its τ and
pixel are written at each event's own index.  The premise held here: the
plain peel-off (``ops/peel_off.py:peel_off_deposit_reference``) of the
active events, permuted (at random, reversed, or by start cell in memory
order), gives each event the τ and pixel of the unpermuted call bit for bit
(and JAX's ``_peel_off_tau`` / ``_ccd_pixel`` of the permuted positions),
and the same image within the CCD's f32 round-off; with 0 and 1 active
events too.  The intensity driver's peel-off calls are counted as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import dust_simulation as dust
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import peel_off
from cmacionize_tpu.models import dust_simulation as jax_dust
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry

KPC = dust.KPC
F32 = np.float32
# edge-on (the dusty_galaxy view), face-on, an oblique window narrower than
# the box, and an oblique view of a periodic box of unequal sides
VIEWS = {
    "edge-on": {},
    "face-on": dict(view_theta=0.0),
    "window": dict(view_theta=np.deg2rad(35.0), view_phi=0.3,
                   ccd_anchor=(-5 * KPC, -4 * KPC), ccd_sides=(9 * KPC, 7 * KPC)),
    "periodic": dict(view_theta=np.deg2rad(60.0), view_phi=1.0,
                     geometry=GridGeometry((-12 * KPC, -16 * KPC, -10 * KPC),
                                           (24 * KPC, 32 * KPC, 20 * KPC), (24, 32, 20),
                                           (True, False, True))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**kw):
    base = dict(geometry=GridGeometry((-12 * KPC,) * 3, (24 * KPC,) * 3, (32, 32, 32)),
                dust_central_density=21.9 * 1.674e-27 * 1e6, dust_scale_radius=6 * KPC,
                dust_scale_height=0.22 * KPC, stellar_scale_radius=5 * KPC,
                stellar_scale_height=0.6 * KPC, n_photons=64, ccd_pixels=(48, 40),
                view_theta=np.deg2rad(89.7), view_phi=0.0)
    base.update(kw)
    return dust.DustConfig(**base)


def _sims(view):
    config = _config(**VIEWS[view])
    fields = dataclasses.asdict(config)
    jconfig = jax_dust.DustConfig(geometry=JaxGridGeometry(**fields.pop("geometry")), **fields)
    return (config, dust.DustSimulation(config, device="cpu", seed=42),
            jax_dust.DustSimulation(jconfig, seed=42))


def _events(seed, shape, n, active_count=None):
    """Positions (cell units; an eighth on cell walls), unit directions,
    weights, and an active mask (80% of the events, or ``active_count`` of
    them), made with numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)) * (np.asarray(shape) - 1e-3)
    pos[: n // 8] = np.round(pos[: n // 8] * 4) / 4
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.uniform(0.5, 1.5, n) / n
    if active_count is None:
        active = rng.uniform(size=n) < 0.8
    else:
        active = np.zeros(n, bool)
        active[rng.choice(n, active_count, replace=False)] = True
    return (torch.tensor(pos.astype(F32)), torch.tensor(d.astype(F32)),
            torch.tensor(w.astype(F32)), torch.tensor(active))


def _start_cells(pos, shape):
    return [np.clip(np.floor(pos[:, k]).astype(np.int64), 0, shape[k] - 1) for k in range(3)]


def _permutation(kind, pos, active, shape):
    """The active events' indices (int64) in the ``kind`` order."""
    picked = np.flatnonzero(active.numpy())
    if kind == "random":
        return torch.tensor(np.random.default_rng(5).permutation(picked))
    if kind == "reversed":
        return torch.tensor(picked[::-1].copy())
    cx, cy, cz = _start_cells(pos.numpy()[picked], shape)
    keys = (cx * shape[1] + cy) * shape[2] + cz
    return torch.tensor(picked[np.argsort(keys, kind="stable")])


@pytest.mark.parametrize("kind", ["random", "reversed", "start cell"])
@pytest.mark.parametrize("active_count", [None, 0, 1])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_permuted_active_events_peel_off_as_unpermuted(view, active_count, kind):
    config, sim, jsim = _sims(view)
    pos, d, w, active = _events(2, config.geometry.shape, 2000, active_count)
    npix = config.ccd_pixels[0] * config.ccd_pixels[1]
    picked = _permutation(kind, pos, active, config.geometry.shape)
    n_active = int(active.sum())
    assert sorted(picked.tolist()) == np.flatnonzero(active.numpy()).tolist()
    for direction in (None, d):
        kw = {} if direction is None else dict(albedo=config.albedo, hgg=config.hgg)
        factor = peel_off.peel_off_factor(w, direction, view=sim.view, **kw)
        ccd, ccd_p = torch.zeros(npix), torch.zeros(npix)
        tau, pix = peel_off.peel_off_deposit_reference(sim.chi, pos, factor, active, ccd,
                                                       view=sim.view)
        tau_p, pix_p = peel_off.peel_off_deposit_reference(
            sim.chi, pos[picked], factor[picked], active[picked], ccd_p, view=sim.view)
        # each event's tau and pixel at its own index, bit for bit
        assert np.array_equal(tau_p.numpy().view(np.int32), tau[picked].numpy().view(np.int32))
        assert torch.equal(pix_p, pix[picked])
        if n_active:
            total = float(ccd.double().abs().sum())
            assert float((ccd_p.double() - ccd.double()).abs().sum()) <= 1e-6 * total
        else:
            assert float(ccd_p.abs().max()) == 0.0 and float(ccd.abs().max()) == 0.0
    if n_active:
        with jax.enable_x64(False):
            tau_j = np.asarray(jsim._peel_off_tau(jnp.asarray(pos[picked].numpy())))
            pix_j = np.asarray(jsim._ccd_pixel(jnp.asarray(pos[picked].numpy())))
        assert np.array_equal(tau_p.numpy(), tau_j) and np.array_equal(pix_p.numpy(), pix_j)


def test_the_driver_peels_off_at_emission_and_at_each_order_that_scattered(monkeypatch):
    """The intensity driver makes one peel-off call at emission and one for
    each scattering order with scattered events, with those events
    active."""
    config = _config(n_photons=2000)
    sim = dust.DustSimulation(config, device="cpu", seed=3)
    seen = []
    original = peel_off.peel_off_deposit

    def spy(chi, position, weight, active, ccd, **kw):
        seen.append((kw.get("direction") is None, int(active.sum())))
        return original(chi, position, weight, active, ccd, **kw)

    monkeypatch.setattr(peel_off, "peel_off_deposit", spy)
    sim.run()
    assert len(seen) == 1 + sum(c > 0 for c in sim.scattered_per_order)
    assert seen[0][0] and not any(emission for emission, _ in seen[1:])
    assert [count for _, count in seen[1:]] == [c for c in sim.scattered_per_order if c > 0]

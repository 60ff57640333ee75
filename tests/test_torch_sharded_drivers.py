"""The port's sharded drivers (ShardedHOnlyIonizationSimulation on 3D tiles,
ShardedRHDSimulation on x-slabs) on a LocalMesh of CPU shards, against the
port's single-device drivers and the JAX package's sharded drivers.

Mirrors tests/test_sharded_drivers.py and tests/test_domain3d.py.  Each
shard draws from its own generator, so the comparisons are statistical: the
ionized volume and the front radius to Monte Carlo noise, the mass exactly
conserved by the reflective box.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
    ShardedHOnlyIonizationSimulation,
)
from cmacionize_torch.models.rhd_simulation import (
    RHDConfig,
    RHDSimulation,
    ShardedRHDSimulation,
)
from cmacionize_tpu.models import grid as jax_grid
from cmacionize_tpu.models import ionization_simulation as jax_ionization

PC = 3.086e16
MYR = 3.15576e13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _honly_config(shape=(16, 16, 16), n_photons=16384, n_iterations=5, module=None):
    geometry = (module or GridGeometry)((-5 * PC,) * 3, (10 * PC,) * 3, shape)
    return dict(
        geometry=geometry, number_density=1e8, temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, cross_section=6.3e-22,
        recombination_rate=4e-19, n_photons=n_photons, n_iterations=n_iterations,
    )


def _rhd_config(shape=(16, 16, 16), n_photons=8192, nloop=2):
    """Small starbench-like RHD workload (tests/test_sharded_drivers.py:160)."""
    total = 0.05 * MYR
    geometry = GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, shape)
    return RHDConfig(
        geometry=geometry, gamma=1.0001, timestep=total / 64.0, total_time=total,
        luminosity=1e49, source_position=(0.0, 0.0, 0.0), cross_section=6.3e-22,
        recombination_rate=2.7e-19, n_photons=n_photons, nloop=nloop,
        background_density=3.113e9, background_temperature=100.0,
    )


_VOLUMES = {}


def _single_device_volume():
    if "single" not in _VOLUMES:
        sim = HOnlyIonizationSimulation(HOnlyConfig(**_honly_config()), device="cpu", seed=3)
        _VOLUMES["single"] = int((sim.run(5).numpy() < 0.5).sum())
    return _VOLUMES["single"]


class TestShardedHOnlyDriver:
    def test_matches_single_device_and_jax_to_mc_noise(self):
        config = HOnlyConfig(**_honly_config())
        sharded = ShardedHOnlyIonizationSimulation(config, tiling=(2, 2, 2), device="cpu", seed=3)
        xh = sharded.run(5).numpy()
        diag = sharded.last_diagnostics
        assert diag["buffer_overflow"] == 0 and diag["truncated_live"] == 0
        assert diag["packets_traced"].shape == (2, 2, 2)
        assert diag["packets_traced"].sum() >= config.n_photons  # copy phase + local traces
        assert np.all(np.isfinite(xh)) and xh.shape == (16, 16, 16)
        volume = int((xh < 0.5).sum())
        assert volume == pytest.approx(_single_device_volume(), rel=0.15)

        jax_config = jax_ionization.HOnlyConfig(
            **_honly_config(module=jax_grid.GridGeometry))
        jax_sim = jax_ionization.ShardedHOnlyIonizationSimulation(
            jax_config, tiling=(2, 2, 2), seed=3)
        jax_volume = int((np.asarray(jax_sim.run(5)) < 0.5).sum())
        assert volume == pytest.approx(jax_volume, rel=0.15)
        c = 8
        assert xh[c, c, c] < 1e-3 and xh[0, 0, 0] > 0.9

    def test_slab_tiling_matches_cube_tiling(self):
        # (8, 1, 1) slabs and (2, 2, 2) cubes are the same physics
        config = HOnlyConfig(**_honly_config())
        volumes = []
        for tiling in ((8, 1, 1), (2, 2, 2)):
            sim = ShardedHOnlyIonizationSimulation(config, tiling=tiling, device="cpu", seed=30)
            volumes.append(int((sim.run(5).numpy() < 0.5).sum()))
            assert sim.last_diagnostics["buffer_overflow"] == 0
            assert sim.last_diagnostics["truncated_live"] == 0
        assert volumes[0] == pytest.approx(volumes[1], rel=0.1)

    def test_copy_phase_keeps_every_shard_busy(self):
        # a source inside one tile: each shard traces at least its emission share
        config = HOnlyConfig(**{**_honly_config(n_photons=8192),
                                "source_position": (-2.5 * PC,) * 3})
        sim = ShardedHOnlyIonizationSimulation(config, tiling=(2, 2, 2), device="cpu", seed=5)
        xh = sim.run(1).numpy()
        traced = sim.last_diagnostics["packets_traced"].reshape(-1)
        assert np.all(traced >= 8192 // 8)
        assert sim.last_diagnostics["buffer_overflow"] == 0
        assert sim.last_diagnostics["truncated_live"] == 0
        assert xh[4, 4, 4] < 1e-2

    def test_defaults_and_what_is_not_ported(self):
        config = HOnlyConfig(**_honly_config(n_photons=1024))
        sim = ShardedHOnlyIonizationSimulation(config, device="cpu")
        assert sim.tiling == (1, 1, 1)  # one device given: one shard
        assert sim.stromgren_radius_analytic() == pytest.approx(
            HOnlyIonizationSimulation(config, device="cpu").stromgren_radius_analytic())
        with pytest.raises(NotImplementedError, match="restart"):
            sim.write_restart(None)
        with pytest.raises(NotImplementedError, match="restart"):
            sim.load_restart("x")


class TestShardedRHD:
    def test_matches_single_device_to_mc_noise(self):
        config = _rhd_config()
        sharded = ShardedRHDSimulation(config, tiling=(4, 1, 1), device="cpu", seed=5)
        sharded.advance(24, log_every=10**9)
        assert sharded.last_diagnostics["buffer_overflow"] == 0
        assert sharded.last_diagnostics["truncated_live"] == 0
        single = RHDSimulation(config, device="cpu", seed=5)
        single.advance(24, log_every=10**9)

        assert sharded.ionization_front_radius() == pytest.approx(
            single.ionization_front_radius(), rel=0.1)
        # mass conservation across the slab exchange (reflective box)
        assert float(sharded.state.rho.double().sum()) == pytest.approx(
            float(single.state.rho.double().sum()), rel=1e-4)
        rho_dd, rho_sd = sharded.state.rho.numpy(), single.state.rho.numpy()
        assert np.corrcoef(rho_dd.ravel(), rho_sd.ravel())[0, 1] > 0.97
        assert len(sharded.supersteps) == 24

    def test_min_slab_width_binds_halo(self):
        # nx_loc == 2 == the hydro halo width: the exchange sends whole slabs
        base = _rhd_config(n_photons=4096, nloop=1)
        geometry = GridGeometry((-1.256 * PC, -0.628 * PC, -0.628 * PC),
                                (2.512 * PC, 1.256 * PC, 1.256 * PC), (16, 8, 8))
        config = dataclasses.replace(base, geometry=geometry)
        sharded = ShardedRHDSimulation(config, tiling=(8, 1, 1), device="cpu", seed=11)
        single = RHDSimulation(config, device="cpu", seed=11)
        sharded.advance(12, log_every=10**9)
        single.advance(12, log_every=10**9)
        assert np.all(np.isfinite(sharded.state.rho.numpy()))
        assert float(sharded.state.rho.double().sum()) == pytest.approx(
            float(single.state.rho.double().sum()), rel=1e-4)
        assert sharded.ionization_front_radius() == pytest.approx(
            single.ionization_front_radius(), rel=0.15)
        # one cell per slab is narrower than the halo
        narrow = dataclasses.replace(base, geometry=GridGeometry(
            geometry.anchor, (1.256 * PC,) * 3, (8, 8, 8)))
        with pytest.raises(ValueError, match="halo"):
            ShardedRHDSimulation(narrow, tiling=(8, 1, 1), device="cpu")

    def test_radiation_skew_balanced(self):
        # source replication keeps the shards' traced counts balanced in the
        # mostly neutral regime
        config = _rhd_config(n_photons=16384, nloop=1)
        sim = ShardedRHDSimulation(config, tiling=(8, 1, 1), device="cpu", seed=13)
        sim.advance(4, log_every=1)
        traced = sim.last_diagnostics["packets_traced"]
        assert traced.shape == (8,)
        assert traced.sum() >= config.n_photons
        assert traced.max() / max(traced.mean(), 1.0) < 1.5, traced

    def test_run_follows_the_cfl_timeline_and_snapshots(self):
        config = dataclasses.replace(_rhd_config(n_photons=2048, nloop=1),
                                     total_time=0.01 * MYR, snapshot_time=0.005 * MYR)
        sharded = ShardedRHDSimulation(config, tiling=(4, 1, 1), device="cpu", seed=2)
        single = RHDSimulation(config, device="cpu", seed=2)
        assert sharded._cfl_timestep() == pytest.approx(single._cfl_timestep(), rel=1e-6)
        snaps = []
        sharded.run(snapshot_callback=lambda sim, i: snaps.append((i, sim.time)))
        single.run()
        assert [i for i, _ in snaps] == [1, 2]
        assert sharded.time == pytest.approx(config.total_time)
        assert sharded.ionization_front_radius() == pytest.approx(
            single.ionization_front_radius(), rel=0.15)

    def test_what_the_sharded_driver_refuses(self):
        config = _rhd_config(n_photons=1024, nloop=1)
        with pytest.raises(NotImplementedError, match="x-slabs"):
            ShardedRHDSimulation(config, tiling=(2, 2, 1), device="cpu")
        with pytest.raises(ValueError, match="divide"):
            ShardedRHDSimulation(config, tiling=(3, 1, 1), device="cpu")
        sim = ShardedRHDSimulation(config, device="cpu")
        assert sim.tiling == (1, 1, 1)
        with pytest.raises(NotImplementedError, match="restart"):
            sim.write_restart(None)
        with pytest.raises(NotImplementedError):
            sim.advance(1, restart_manager=object())

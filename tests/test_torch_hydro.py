"""cmacionize_torch hydrodynamics against the JAX package's, on the CPU.

The same numpy inputs (f32, from a seed) go through ``cmacionize_tpu.ops``
(``riemann``, ``hydro``) and the port's plain PyTorch versions, which the
port's ``hydro_step_padded`` runs on CPU tensors.  The physics tests mirror
tests/test_hydro.py against the port.

Tolerances, and why they are not 0:
* Eager JAX rounds every operation on its own, as torch does, so the slopes
  and the predictor agree bit for bit.
* Jitted JAX (``hydro_step``) runs through XLA on the CPU, which contracts
  ``a + b*c`` into fused multiply-adds; the port rounds twice there.  Those
  few-ulp differences per operation, and an occasional limiter or wave-region
  tie decided the other way, keep one step within 5e-5 of each field's
  largest magnitude (the largest seen was 2.7e-5, for a momentum component).
* The exact solver raises to powers such as 2/(γ-1); XLA's and torch's pow
  differ by an ulp, which those exponents amplify: at γ = 1.0001 the
  exponents are about 2e4, and one step agrees to 2e-3 of the field's
  largest magnitude (5.9e-4 seen, in a transonic rarefaction fan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.ops import hydro, riemann
from cmacionize_tpu.ops import hydro as jax_hydro
from cmacionize_tpu.ops import riemann as jax_riemann

GAMMA = 5.0 / 3.0
STARBENCH_GAMMA = 1.0001


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _both(arrays):
    """The same f32 numpy arrays as JAX arrays and as torch tensors."""
    return (
        [jnp.asarray(_f32(a)) for a in arrays],
        [torch.tensor(_f32(a)) for a in arrays],
    )


def _assert_close(ref, port, rel, what=""):
    """max |ref - port| <= rel * max |ref|, per field."""
    for i, (a, b) in enumerate(zip(ref, port)):
        a = np.asarray(a, dtype=np.float64)
        b = b.numpy().astype(np.float64) if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        assert np.isfinite(b).all() == np.isfinite(a).all(), (what, i)
        scale = max(np.abs(a).max(), 1e-30)
        err = np.abs(a - b).max()
        assert err <= rel * scale, (what, i, err, scale)


def _riemann_states(seed, n=4000):
    """Left/right states: random smooth pairs, strong shocks, strong
    rarefactions, dry (zero-density) and zero-pressure sides, both sides
    vacuum, and receding flows that open a vacuum."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.1, 2.0, (2, n))
    vel = rng.uniform(-1.0, 1.0, (2, 3, n))
    p = rng.uniform(0.1, 2.0, (2, n))
    k = n // 8
    p[0, :k] *= 1e3  # strong shocks to the right
    rho[1, k:2 * k] *= 1e-3  # density jumps
    vel[0, 0, 2 * k:3 * k] = -3.0  # strong rarefactions
    vel[1, 0, 2 * k:3 * k] = 3.0
    vel[0, 0, 3 * k:3 * k + 50] = -10.0  # vacuum generation
    vel[1, 0, 3 * k:3 * k + 50] = 10.0
    p[:, 3 * k:3 * k + 50] = 0.01
    rho[1, 4 * k:4 * k + 50] = 0.0  # dry right side
    p[1, 4 * k:4 * k + 50] = 0.0
    rho[0, 4 * k + 50:4 * k + 100] = 0.0  # dry left side
    p[0, 4 * k + 50:4 * k + 100] = 0.0
    p[0, 4 * k + 100:4 * k + 150] = 0.0  # cold left side
    rho[:, 4 * k + 150:4 * k + 200] = 0.0  # both dry
    p[:, 4 * k + 150:4 * k + 200] = 0.0
    left = [rho[0], *vel[0], p[0]]
    right = [rho[1], *vel[1], p[1]]
    return left + right


@pytest.mark.parametrize("gamma", [GAMMA, 1.4, STARBENCH_GAMMA])
def test_hllc_flux_matches_jax(gamma):
    ref_in, port_in = _both(_riemann_states(0))
    ref = jax_riemann.hllc_flux(*ref_in, gamma=gamma)
    port = riemann.hllc_flux(*port_in, gamma=gamma)
    # elementwise, eager on both sides: a few ulp
    _assert_close(ref, port, 2e-6, "hllc")


@pytest.mark.parametrize("gamma", [GAMMA, 1.4])
def test_exact_flux_matches_jax(gamma):
    ref_in, port_in = _both(_riemann_states(1))
    ref = jax_riemann.exact_flux(*ref_in, gamma=gamma)
    port = riemann.exact_flux(*port_in, gamma=gamma)
    # pow differs by an ulp between XLA and torch; 20 Newton steps and the
    # fan exponents (up to 2γ/(γ-1) = 5 or 7) keep it within 1e-5
    _assert_close(ref, port, 1e-5, "exact")


def test_exact_flux_vacuum_branches():
    z, one = torch.zeros(1), torch.ones(1)
    f = riemann.exact_flux(one, z, z, z, one, z, z, z, z, z)  # right vacuum
    assert torch.isfinite(torch.stack(f)).all() and float(f.mass[0]) > 0.0
    f = riemann.exact_flux(z, z, z, z, z, one, z, z, z, one)  # left vacuum
    assert torch.isfinite(torch.stack(f)).all() and float(f.mass[0]) < 0.0
    f = riemann.exact_flux(z, z, z, z, z, z, z, z, z, z)  # both vacuum
    assert float(torch.stack(f).abs().max()) == 0.0
    f = riemann.exact_flux(one, -10 * one, z, z, 0.01 * one,
                           one, 10 * one, z, z, 0.01 * one)  # vacuum generation
    assert torch.isfinite(torch.stack(f)).all() and abs(float(f.mass[0])) < 1e-6


def test_exact_star_state_and_sample_match_jax():
    # Toro test 1 (γ = 1.4): p* ≈ 0.30313, u* ≈ 0.92745
    t = [torch.tensor(v, dtype=torch.float32) for v in (1.0, 0.0, 1.0, 0.125, 0.0, 0.1)]
    p_star, u_star = riemann.exact_star_pressure(*t, gamma=1.4)
    assert float(p_star) == pytest.approx(0.30313, rel=1e-3)
    assert float(u_star) == pytest.approx(0.92745, rel=1e-3)
    s = np.linspace(-2.0, 2.0, 401)
    j = [jnp.asarray(np.float32(v)) for v in (1.0, 0.0, 1.0, 0.125, 0.0, 0.1)]
    ref = jax_riemann.exact_sample(*j, jnp.asarray(_f32(s)), gamma=GAMMA)
    port = riemann.exact_sample(*t, torch.tensor(_f32(s)), gamma=GAMMA)
    _assert_close(ref, port, 1e-5, "exact_sample")


def _primitives(seed, shape, bubble=True):
    """A starbench-like f32 state: a hot ionized bubble with an outward
    shell, in cold gas, plus a Sod-like jump along x (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, float) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0)) / shape[0]
    rho = rng.uniform(0.9, 1.1, shape) * np.where(offset[0] < 0, 1.0, 0.3)
    p = rng.uniform(0.9, 1.1, shape) * np.where(offset[0] < 0, 1.0, 0.2)
    vel = rng.uniform(-0.05, 0.05, (3,) + shape)
    if bubble:
        inside = r < 0.25
        shell = (r >= 0.25) & (r < 0.35)
        rho = np.where(inside, 0.05 * rho, np.where(shell, 3.0 * rho, rho))
        p = np.where(inside, 50.0 * p, p)
        radial = offset / np.maximum(np.sqrt((offset**2).sum(0)), 1e-9)
        vel = vel + np.where(shell, 0.8, 0.0) * radial
    return [rho, *vel, p]


BOUNDARIES = {
    "reflective": ((hydro.BC_REFLECTIVE,) * 2,) * 3,
    "periodic": ((hydro.BC_PERIODIC,) * 2,) * 3,
    "mixed": (
        (hydro.BC_OUTFLOW, hydro.BC_REFLECTIVE),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        (hydro.BC_REFLECTIVE, hydro.BC_OUTFLOW),
    ),
}


@pytest.mark.parametrize("bc", list(BOUNDARIES) + ["inflow_scalar", "inflow_array"])
def test_pad_primitives_matches_jax(bc):
    shape = (6, 5, 4)
    fields = _primitives(2, shape, bubble=False)
    ref_w, port_w = _both(fields)
    kwargs_ref, kwargs_port = {}, {}
    if bc.startswith("inflow"):
        boundaries = (
            (hydro.BC_INFLOW, hydro.BC_OUTFLOW),
            (hydro.BC_REFLECTIVE, hydro.BC_INFLOW),
            (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        )
        if bc == "inflow_scalar":
            lo = (1.5, 0.2, -0.1, 0.0, 2.5)
            hi = (0.5, 0.0, -0.3, 0.1, 0.7)
            kwargs_ref = {"inflow_states": {(0, "lo"): lo, (1, "hi"): hi}}
            kwargs_port = kwargs_ref
        else:
            rng = np.random.default_rng(3)
            lo = [rng.uniform(0.5, 1.5, (2, 5, 4)) for _ in range(5)]
            hi = [rng.uniform(0.5, 1.5, (10, 2, 4)) for _ in range(5)]
            kwargs_ref = {"inflow_states": {
                (0, "lo"): tuple(jnp.asarray(_f32(a)) for a in lo),
                (1, "hi"): tuple(jnp.asarray(_f32(a)) for a in hi)}}
            kwargs_port = {"inflow_states": {
                (0, "lo"): tuple(torch.tensor(_f32(a)) for a in lo),
                (1, "hi"): tuple(torch.tensor(_f32(a)) for a in hi)}}
    else:
        boundaries = BOUNDARIES[bc]
    ref = jax_hydro.pad_primitives(jax_hydro.Primitives(*ref_w), boundaries, **kwargs_ref)
    port = hydro.pad_primitives(hydro.Primitives(*port_w), boundaries, **kwargs_port)
    for a, b in zip(ref, port):
        assert b.shape == (10, 9, 8)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())  # copies only


@pytest.mark.parametrize("gamma", [GAMMA, STARBENCH_GAMMA])
def test_gradients_and_predictor_match_jax(gamma):
    shape = (12, 10, 8)
    fields = _primitives(4, tuple(s + 4 for s in shape))
    ref_w, port_w = _both(fields)
    ref_g = jax_hydro.limited_gradients(jax_hydro.Primitives(*ref_w))
    port_g = hydro.limited_gradients(hydro.Primitives(*port_w))
    for a, b in zip(ref_g, port_g):
        for x, y in zip(a, b):  # subtractions, halvings and selections only
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    dt, cell = 3e-3, (0.1, 0.1, 0.1)
    ref_p = jax_hydro.predict_half_step(
        jax_hydro.Primitives(*(f[1:-1, 1:-1, 1:-1] for f in ref_w)), ref_g,
        jnp.float32(dt), cell, gamma)
    port_p = hydro.predict_half_step(
        hydro.Primitives(*(f[1:-1, 1:-1, 1:-1] for f in port_w)), port_g, dt, cell, gamma)
    # eager JAX rounds each operation as torch does: at most an ulp
    _assert_close(ref_p, port_p, 1e-6, "predict")


@pytest.mark.parametrize(
    "gamma, solver, bc, rel",
    [
        (GAMMA, "HLLC", "reflective", 5e-5),
        (GAMMA, "HLLC", "mixed", 5e-5),
        (GAMMA, "Exact", "periodic", 5e-5),
        (STARBENCH_GAMMA, "HLLC", "reflective", 5e-5),
        (STARBENCH_GAMMA, "Exact", "mixed", 2e-3),
    ],
)
def test_hydro_step_matches_jax(gamma, solver, bc, rel):
    shape = (12, 12, 12)
    ref_w, port_w = _both(_primitives(5, shape))
    u_ref = jax_hydro.conserved_from_primitives(jax_hydro.Primitives(*ref_w), gamma)
    u_port = hydro.conserved_from_primitives(hydro.Primitives(*port_w), gamma)
    for a, b in zip(u_ref, u_port):  # eager on both sides: the same state
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    kwargs = dict(boundaries=BOUNDARIES[bc], cell_size=(0.1, 0.1, 0.1), gamma=gamma,
                  riemann_solver=solver)
    dt = 2e-3
    ref = jax_hydro.hydro_step(u_ref, dt, **kwargs)
    port = hydro.hydro_step(u_port, dt, **kwargs)
    _assert_close(ref, port, rel, f"{solver} {bc} γ={gamma}")
    # and the step moved the state
    assert float((port.energy - u_port.energy).abs().max()) > 1e-3


def test_cfl_timestep_matches_jax():
    ref_w, port_w = _both(_primitives(6, (10, 10, 10)))
    u_ref = jax_hydro.conserved_from_primitives(jax_hydro.Primitives(*ref_w), GAMMA)
    u_port = hydro.conserved_from_primitives(hydro.Primitives(*port_w), GAMMA)
    ref = float(jax_hydro.cfl_timestep(u_ref, (0.1, 0.1, 0.1), cfl=0.3, gamma=GAMMA))
    port = float(hydro.cfl_timestep(u_port, (0.1, 0.1, 0.1), cfl=0.3, gamma=GAMMA))
    assert port == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("heating", [True, False])
@pytest.mark.parametrize("cooling", [True, False])
def test_two_temperature_coupling_matches_jax(heating, cooling):
    shape = (8, 8, 8)
    rng = np.random.default_rng(7)
    mp, kb = 1.672621898e-27, 1.38064852e-23
    nd = rng.uniform(1e9, 5e9, shape)
    T = np.where(rng.uniform(size=shape) < 0.3, 5e4, rng.uniform(50.0, 2e4, shape))
    xh = rng.uniform(0.0, 1.0, shape)
    fields = [nd * mp, *rng.uniform(-1e3, 1e3, (3,) + shape), nd * kb * T]
    ref_w, port_w = _both(fields)
    u_ref = jax_hydro.conserved_from_primitives(jax_hydro.Primitives(*ref_w), STARBENCH_GAMMA)
    u_port = hydro.conserved_from_primitives(hydro.Primitives(*port_w), STARBENCH_GAMMA)
    kwargs = dict(gamma=STARBENCH_GAMMA, radiative_heating=heating, radiative_cooling=cooling)
    ref = jax_hydro.two_temperature_coupling(u_ref, jnp.asarray(_f32(xh)), **kwargs)
    port = hydro.two_temperature_coupling(u_port, torch.tensor(_f32(xh)), **kwargs)
    # eager elementwise on both sides: an ulp
    _assert_close(ref, port, 1e-6, "coupling")
    changed = int((port.energy != u_port.energy).sum())
    assert changed > 0 if (heating or cooling) else changed == 0


def test_isothermal_step_and_mask_match_jax():
    shape = (8, 8, 8)
    ref_w, port_w = _both(_primitives(8, shape, bubble=False))
    u_ref = jax_hydro.conserved_from_primitives(jax_hydro.Primitives(*ref_w), GAMMA)
    u_port = hydro.conserved_from_primitives(hydro.Primitives(*port_w), GAMMA)
    kwargs = dict(sound_speed=1.1, boundaries=BOUNDARIES["periodic"], cell_size=(0.1,) * 3)
    ref = jax_hydro.isothermal_hydro_step(u_ref, 1e-3, **kwargs)
    port = hydro.isothermal_hydro_step(u_port, 1e-3, **kwargs)
    _assert_close(ref, port, 5e-5, "isothermal")
    mask = np.zeros(shape, bool)
    mask[2:4, 3:6, 1:7] = True
    ref_m = jax_hydro.apply_hydro_mask(ref, jnp.asarray(mask), u_ref)
    port_m = hydro.apply_hydro_mask(port, torch.tensor(mask), u_port)
    _assert_close(ref_m, port_m, 5e-5, "mask")
    np.testing.assert_array_equal(port_m.rho.numpy()[mask], u_port.rho.numpy()[mask])


# ------------------------------------------------- mirrors of test_hydro.py


def test_hllc_consistency_uniform_flow():
    rho, u, p = 1.3, 0.7, 2.1
    state = [torch.tensor(v) for v in (rho, u, 0.2, -0.1, p)]
    f = riemann.hllc_flux(*state, *state, gamma=GAMMA)
    e = p / (GAMMA - 1) + 0.5 * rho * (u**2 + 0.2**2 + 0.1**2)
    assert float(f.mass) == pytest.approx(rho * u, rel=1e-6)
    assert float(f.mom_n) == pytest.approx(rho * u * u + p, rel=1e-6)
    assert float(f.energy) == pytest.approx((e + p) * u, rel=1e-6)


def test_hllc_symmetry():
    args_l = (1.0, 0.5, 0.0, 0.0, 1.0)
    args_r = (0.5, -0.2, 0.0, 0.0, 0.3)

    def flux(left, right):
        return riemann.hllc_flux(*(torch.tensor(v) for v in (*left, *right)), gamma=GAMMA)

    f1 = flux(args_l, args_r)
    f2 = flux((args_r[0], -args_r[1], 0.0, 0.0, args_r[4]),
              (args_l[0], -args_l[1], 0.0, 0.0, args_l[4]))
    assert float(f1.mass) == pytest.approx(-float(f2.mass), rel=1e-5, abs=1e-8)
    assert float(f1.mom_n) == pytest.approx(float(f2.mom_n), rel=1e-5)
    assert float(f1.energy) == pytest.approx(-float(f2.energy), rel=1e-5, abs=1e-8)


def _run_sod(n=128, t_end=0.2, riemann_solver="HLLC"):
    shape = (n, 4, 4)
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    rho = np.broadcast_to(np.where(x < 0.5, 1.0, 0.125)[:, None, None], shape)
    p = np.broadcast_to(np.where(x < 0.5, 1.0, 0.1)[:, None, None], shape)
    zeros = torch.zeros(shape)
    w = hydro.Primitives(torch.tensor(_f32(rho)), zeros, zeros, zeros, torch.tensor(_f32(p)))
    u = hydro.conserved_from_primitives(w, GAMMA)
    boundaries = (
        (hydro.BC_OUTFLOW, hydro.BC_OUTFLOW),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
    )
    cell_size = (dx, dx, dx)
    t = 0.0
    while t < t_end:
        dt = min(float(hydro.cfl_timestep(u, cell_size, cfl=0.4, gamma=GAMMA)), t_end - t)
        u = hydro.hydro_step(u, dt, boundaries=boundaries, cell_size=cell_size,
                             gamma=GAMMA, riemann_solver=riemann_solver)
        t += dt
    return x, u


def _sod_exact_density(x):
    t = [torch.tensor(v, dtype=torch.float32) for v in (1.0, 0.0, 1.0, 0.125, 0.0, 0.1)]
    s = torch.tensor(_f32((x - 0.5) / 0.2))
    return riemann.exact_sample(*t, s, gamma=GAMMA)[0].numpy()


@pytest.mark.parametrize("solver", ["HLLC", "Exact"])
def test_sod_tube_vs_exact(solver):
    x, u = _run_sod(riemann_solver=solver)
    w = hydro.primitives_from_conserved(u, GAMMA)
    l1 = np.abs(w.rho[:, 2, 2].numpy() - _sod_exact_density(x)).mean()
    assert l1 < 0.012, f"Sod ({solver}) L1 density error too large: {l1}"
    # mass conservation (16 y-z columns of 128 cells, dx = 1/128)
    assert float(u.rho.double().sum()) * (1.0 / 128) / 16 == pytest.approx(
        (1.0 + 0.125) / 2, rel=1e-4
    )


def test_uniform_state_is_steady():
    shape = (8, 8, 8)
    w = hydro.Primitives(*(torch.full(shape, v) for v in (1.0, 0.3, -0.1, 0.2, 2.0)))
    u = hydro.conserved_from_primitives(w, GAMMA)
    u2 = hydro.hydro_step(u, 0.01, boundaries=BOUNDARIES["periodic"],
                          cell_size=(0.1, 0.1, 0.1), gamma=GAMMA)
    for a, b in zip(u, u2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=1e-6)


def test_hydro_step_padded_dispatches_cpu_to_plain_version():
    shape = (6, 6, 6)
    _, port_w = _both(_primitives(9, shape))
    u = hydro.conserved_from_primitives(hydro.Primitives(*port_w), GAMMA)
    wp = hydro.pad_primitives(hydro.primitives_from_conserved(u, GAMMA), BOUNDARIES["mixed"])
    kwargs = dict(cell_size=(0.1,) * 3, gamma=GAMMA)
    a = hydro.hydro_step_padded(u, wp, 1e-3, **kwargs)
    b = hydro.hydro_step_padded_reference(u, wp, 1e-3, **kwargs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)

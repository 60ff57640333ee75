"""Finite-volume hydrodynamics: MUSCL-Hancock + HLLC on Cartesian grids.

Port of ``cmacionize_tpu/ops/hydro.py``.  One step is a fixed sequence of
whole-array passes:

    pad ghosts → limited gradients (3 axes) → half-dt primitive prediction
    → per-axis face reconstruction + Riemann flux → conserved update

Boundary conditions are ghost-cell paddings (periodic / reflective /
inflow / outflow).  State is a NamedTuple of ``[nx, ny, nz]`` f32 tensors.

:func:`hydro_step_padded` dispatches on the device: CPU tensors go through
the plain PyTorch version :func:`hydro_step_padded_reference`, CUDA tensors
through K3, the hand-written kernel in ``csrc/hydro_step.cu``.  There is no
fallback between the two.  On CUDA tensors :func:`hydro_step` hands K3 the
conserved state and the ghost map of its walls (:func:`ghost_map`), and K3
forms the primitives and the ghosts itself in the same launch; with inflow
ghosts (data, not indices) it pads here and takes the padded path, as a
domain-decomposed halo exchange does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.kernels.hydro_step import hydro_step_conserved_cuda, hydro_step_cuda
from cmacionize_torch.ops import riemann
from cmacionize_torch.ops.riemann import _div

GAMMA_DEFAULT = 5.0 / 3.0

# pressure/density floors (the reference's SAFE_HYDRO guards)
RHO_FLOOR = 1e-30
P_FLOOR = 1e-30


class HydroState(NamedTuple):
    """Conserved state per unit volume: mass, momentum, total energy density."""

    rho: torch.Tensor
    mom_x: torch.Tensor
    mom_y: torch.Tensor
    mom_z: torch.Tensor
    energy: torch.Tensor


class Primitives(NamedTuple):
    rho: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    p: torch.Tensor


def conserved_from_primitives(w: Primitives, gamma: float = GAMMA_DEFAULT) -> HydroState:
    kinetic = 0.5 * w.rho * (w.vx**2 + w.vy**2 + w.vz**2)
    return HydroState(
        rho=w.rho,
        mom_x=w.rho * w.vx,
        mom_y=w.rho * w.vy,
        mom_z=w.rho * w.vz,
        energy=_div(w.p, gamma - 1.0) + kinetic,
    )


def primitives_from_conserved(u: HydroState, gamma: float = GAMMA_DEFAULT) -> Primitives:
    rho = torch.clamp_min(u.rho, RHO_FLOOR)
    vx = u.mom_x / rho
    vy = u.mom_y / rho
    vz = u.mom_z / rho
    kinetic = 0.5 * rho * (vx**2 + vy**2 + vz**2)
    p = torch.clamp_min((gamma - 1.0) * (u.energy - kinetic), P_FLOOR)
    return Primitives(rho, vx, vy, vz, p)


# ---------------------------------------------------------------- boundaries

# boundary condition codes per (axis, side)
BC_PERIODIC = "periodic"
BC_REFLECTIVE = "reflective"
BC_OUTFLOW = "outflow"
BC_INFLOW = "inflow"  # fixed ghost state, provided via inflow_state


def _pad_axis(
    arr, axis, bc_lo, bc_hi, n=2, flip_sign=False,
    inflow_lo=None, inflow_hi=None,
):
    """Pad one axis with n ghost cells per side according to the BCs.

    Inflow ghost values may be scalars or full ghost-shaped arrays
    ([n, ...] along the padded axis).
    """
    lo = ghost_one_side(arr, axis, "lo", bc_lo, n, flip_sign, inflow_lo)
    hi = ghost_one_side(arr, axis, "hi", bc_hi, n, flip_sign, inflow_hi)
    return torch.cat([lo, arr, hi], dim=axis)


def ghost_one_side(a, axis, side, bc, n=2, flip_sign=False, inflow_value=None):
    """Ghost-cell slab for one side of one axis."""
    length = a.shape[axis]
    if bc == BC_PERIODIC:
        start = length - n if side == "lo" else 0
        ghost = a.narrow(axis, start, n)
    elif bc == BC_REFLECTIVE:
        start = 0 if side == "lo" else length - n
        ghost = torch.flip(a.narrow(axis, start, n), dims=(axis,))
        if flip_sign:
            ghost = -ghost
    elif bc == BC_OUTFLOW:
        edge = a.narrow(axis, 0 if side == "lo" else length - 1, 1)
        reps = [1] * a.ndim
        reps[axis] = n
        ghost = edge.repeat(*reps)
    elif bc == BC_INFLOW:
        shape = list(a.shape)
        shape[axis] = n
        ghost = torch.broadcast_to(
            torch.as_tensor(inflow_value, dtype=a.dtype, device=a.device), shape
        )
    else:
        raise ValueError(f"unknown boundary condition {bc!r}")
    return ghost


def pad_primitives(
    w: Primitives,
    boundaries,
    n: int = 2,
    inflow_states: Optional[dict] = None,
) -> Primitives:
    """Pad all three axes with ghost cells.

    ``boundaries``: ((bc_x_lo, bc_x_hi), (bc_y_lo, bc_y_hi), (bc_z_lo, bc_z_hi)).
    ``inflow_states``: {(axis, "lo"|"hi"): 5-tuple of scalar or ghost-shaped
    arrays (rho, vx, vy, vz, p)}.
    """
    fields = list(w)
    normal = {0: 1, 1: 2, 2: 3}  # field index of the normal velocity per axis
    for axis in range(3):
        bc_lo, bc_hi = boundaries[axis]
        for i, field in enumerate(fields):
            lo_val = hi_val = None
            if inflow_states is not None:
                state_lo = inflow_states.get((axis, "lo"))
                state_hi = inflow_states.get((axis, "hi"))
                if state_lo is not None:
                    lo_val = state_lo[i]
                if state_hi is not None:
                    hi_val = state_hi[i]
            fields[i] = _pad_axis(
                field, axis, bc_lo, bc_hi, n=n,
                flip_sign=(i == normal[axis]),
                inflow_lo=lo_val, inflow_hi=hi_val,
            )
    return Primitives(*fields)


def ghost_map(bc_lo, bc_hi, length: int, n: int = 2) -> torch.Tensor:
    """K3's ghost map of one axis: int32 [length + 2n], for each padded index
    its source cell along the axis, bit-inverted (``~i``) where a reflective
    wall flips the sign of that axis's velocity.  It is :func:`_pad_axis`
    applied to the cell indices and to the signs, so a gather by it gives
    :func:`pad_primitives`' values; inflow ghosts are data, not indices, and
    are refused."""
    if BC_INFLOW in (bc_lo, bc_hi):
        raise ValueError("ghost_map: inflow ghosts are data, not indices; pad them")
    src = _pad_axis(torch.arange(length, dtype=torch.int32), 0, bc_lo, bc_hi, n)
    sign = _pad_axis(torch.ones(length, dtype=torch.int32), 0, bc_lo, bc_hi, n,
                     flip_sign=True)
    return torch.where(sign < 0, ~src, src)


_GHOST_MAPS: dict = {}  # (boundaries, shape, device) → K3's ghost map on the device


def ghost_maps(boundaries, shape, device) -> torch.Tensor:
    """The three axes' :func:`ghost_map` of ``boundaries`` on a grid of
    ``shape``, concatenated (int32 [Σ (n_a + 4)]) on ``device``, made once
    and kept."""
    key = (tuple(tuple(b) for b in boundaries), tuple(shape), str(device))
    table = _GHOST_MAPS.get(key)
    if table is None:
        table = torch.cat([ghost_map(*boundaries[a], shape[a]) for a in range(3)]).to(device)
        _GHOST_MAPS[key] = table
    return table


def ghost_primitives(u: HydroState, boundaries, gamma: float = GAMMA_DEFAULT) -> Primitives:
    """K3's first step in plain torch: the primitives padded with 2 ghosts
    per side, each padded cell's formed by :func:`primitives_from_conserved`
    from the conserved state of its source cell (:func:`ghost_map`), the
    normal velocity negated where a reflective wall flips it.  The same bits
    as ``pad_primitives(primitives_from_conserved(u), boundaries)``."""
    maps = [ghost_map(*boundaries[a], u.rho.shape[a]).to(u.rho.device).long()
            for a in range(3)]
    src = [torch.where(m < 0, ~m, m) for m in maps]
    index = (src[0][:, None, None], src[1][None, :, None], src[2][None, None, :])
    w = primitives_from_conserved(HydroState(*(f[index] for f in u)), gamma)
    flips = (maps[0][:, None, None] < 0, maps[1][None, :, None] < 0,
             maps[2][None, None, :] < 0)
    return w._replace(**{name: torch.where(flip, -v, v) for name, v, flip in
                         zip(("vx", "vy", "vz"), (w.vx, w.vy, w.vz), flips)})


# ----------------------------------------------------------------- gradients


def _limited_slope(w_m, w_0, w_p):
    """Monotonized-central limited difference per cell (in units of one cell):
    slopes never create new extrema between neighbours."""
    dl = w_0 - w_m
    dr = w_p - w_0
    dc = 0.5 * (w_p - w_m)
    slope = torch.sign(dc) * torch.minimum(
        torch.abs(dc), 2.0 * torch.minimum(torch.abs(dl), torch.abs(dr))
    )
    return torch.where(dl * dr > 0.0, slope, 0.0)


def _shift(arr, axis, offset):
    """A ±1 shifted pad-1 window along `axis` (offset ∈ {-1, 0, +1})."""
    return arr.narrow(axis, 1 + offset, arr.shape[axis] - 2)


def limited_gradients(wp: Primitives):
    """Per-axis limited differences of each primitive on the padded array.

    Input: padded primitives (each axis +2).  Output: for each axis, a
    Primitives of slopes valid on the pad-1 interior region.
    """
    grads = []
    for axis in range(3):
        slopes = []
        for field in wp:
            # crop the other axes to the pad-1 region, diff along `axis`
            w_m = field
            for a in range(3):
                if a != axis:
                    w_m = w_m.narrow(a, 1, w_m.shape[a] - 2)
            slopes.append(
                _limited_slope(_shift(w_m, axis, -1), _shift(w_m, axis, 0),
                               _shift(w_m, axis, 1))
            )
        grads.append(Primitives(*slopes))
    return grads


def predict_half_step(
    wp1: Primitives, grads, dt, cell_size, gamma: float
) -> Primitives:
    """Half-dt primitive prediction (MUSCL-Hancock predictor):
        ρ' = ρ - dt/2 (v·∇ρ + ρ ∇·v)
        v' = v - dt/2 (v·∇v + ∇P/ρ)
        P' = P - dt/2 (v·∇P + γP ∇·v)
    ``dt`` is rounded to f32 first, as the JAX step's traced f32 scalar.
    """
    gx, gy, gz = grads  # slopes per cell width on the pad-1 region
    inv = [1.0 / float(cell_size[a]) for a in range(3)]
    rho, vx, vy, vz, p = wp1
    half = 0.5 * _f32(dt)

    drho = (
        vx * gx.rho * inv[0] + vy * gy.rho * inv[1] + vz * gz.rho * inv[2]
        + rho * (gx.vx * inv[0] + gy.vy * inv[1] + gz.vz * inv[2])
    )
    dvx = (
        vx * gx.vx * inv[0] + vy * gy.vx * inv[1] + vz * gz.vx * inv[2]
        + gx.p * inv[0] / rho
    )
    dvy = (
        vx * gx.vy * inv[0] + vy * gy.vy * inv[1] + vz * gz.vy * inv[2]
        + gy.p * inv[1] / rho
    )
    dvz = (
        vx * gx.vz * inv[0] + vy * gy.vz * inv[1] + vz * gz.vz * inv[2]
        + gz.p * inv[2] / rho
    )
    dp = (
        vx * gx.p * inv[0] + vy * gy.p * inv[1] + vz * gz.p * inv[2]
        + gamma * p * (gx.vx * inv[0] + gy.vy * inv[1] + gz.vz * inv[2])
    )
    return Primitives(
        torch.clamp_min(rho - half * drho, RHO_FLOOR),
        vx - half * dvx,
        vy - half * dvy,
        vz - half * dvz,
        torch.clamp_min(p - half * dp, P_FLOOR),
    )


def _f32(x) -> float:
    """A Python number rounded to f32 (the JAX drivers pass dt as
    ``jnp.float32(dt)``); 0.5·dt and dt·div then round as in JAX."""
    return float(np.float32(x))


def _axis_faces(w: Primitives, slopes: Primitives, axis: int):
    """Left/right states at the faces along `axis` (N+1 faces from N+2 cells)."""
    m = w.rho.shape[axis] - 1
    left = Primitives(*(f.narrow(axis, 0, m) + 0.5 * s.narrow(axis, 0, m)
                        for f, s in zip(w, slopes)))
    right = Primitives(*(f.narrow(axis, 1, m) - 0.5 * s.narrow(axis, 1, m)
                         for f, s in zip(w, slopes)))
    return left, right


_VEL_PERM = {
    # (normal, tangential1, tangential2) velocity field order per axis
    0: (1, 2, 3),
    1: (2, 3, 1),
    2: (3, 1, 2),
}

RIEMANN_SOLVERS = ("HLLC", "Exact")


def _face_flux(left: Primitives, right: Primitives, axis: int, gamma: float,
               solver: str = "HLLC"):
    """Interface flux at the faces along `axis`, rotated back to (x,y,z)
    order; ``solver`` selects HLLC or the exact Riemann solver.

    Returns a 5-tuple (mass, mom_x, mom_y, mom_z, energy) flux arrays.
    """
    n, t1, t2 = _VEL_PERM[axis]
    flux_fn = {"HLLC": riemann.hllc_flux, "Exact": riemann.exact_flux}[solver]
    flux = flux_fn(
        left[0], left[n], left[t1], left[t2], left[4],
        right[0], right[n], right[t1], right[t2], right[4],
        gamma=gamma,
    )
    mom = [None, None, None]
    mom[n - 1] = flux.mom_n
    mom[t1 - 1] = flux.mom_t1
    mom[t2 - 1] = flux.mom_t2
    return (flux.mass, mom[0], mom[1], mom[2], flux.energy)


def hydro_step(
    u: HydroState,
    dt,
    *,
    boundaries,
    cell_size: Tuple[float, float, float],
    gamma: float = GAMMA_DEFAULT,
    riemann_solver: str = "HLLC",
    gravity=None,
    inflow_states: Optional[dict] = None,
) -> HydroState:
    """One MUSCL-Hancock step: U^{n+1} = U^n - dt ∇·F + dt S.

    ``gravity``: optional (gx, gy, gz) acceleration fields for the source
    term (kick + energy work).  On CUDA tensors without ``inflow_states``,
    K3 forms the primitives and the ghosts itself from ``u`` and the walls'
    :func:`ghost_maps` (one launch, counted in
    ``kernels.LAUNCHES["hydro_step"]``); otherwise the primitives are padded
    here and the step goes through :func:`hydro_step_padded`.
    """
    if inflow_states is None and u.rho.device.type != "cpu":
        out = HydroState(*hydro_step_conserved_cuda(
            tuple(u), ghost_maps(boundaries, u.rho.shape, u.rho.device), _f32(dt),
            cell_size=cell_size, gamma=gamma, riemann_solver=riemann_solver,
        ))
        if gravity is not None:
            out = _gravity_kick(out, u, dt, gravity)
        return out
    w = primitives_from_conserved(u, gamma)
    wp = pad_primitives(w, boundaries, n=2, inflow_states=inflow_states)
    return hydro_step_padded(
        u, wp, dt, cell_size=cell_size, gamma=gamma, gravity=gravity,
        riemann_solver=riemann_solver,
    )


def _gravity_kick(out: HydroState, u: HydroState, dt, gravity) -> HydroState:
    gx, gy, gz = gravity
    dt = _f32(dt)
    rho = u.rho
    return out._replace(
        mom_x=out.mom_x + dt * rho * gx,
        mom_y=out.mom_y + dt * rho * gy,
        mom_z=out.mom_z + dt * rho * gz,
        energy=out.energy + dt * (u.mom_x * gx + u.mom_y * gy + u.mom_z * gz),
    )


def hydro_step_padded_reference(
    u: HydroState,
    wp: Primitives,
    dt,
    *,
    cell_size,
    gamma: float = GAMMA_DEFAULT,
    gravity=None,
    riemann_solver: str = "HLLC",
) -> HydroState:
    """Plain PyTorch MUSCL-Hancock update from pre-padded primitives (2
    ghosts per side), the JAX ``hydro_step_padded`` op for op."""
    dt = _f32(dt)
    grads = limited_gradients(wp)  # pad-1 region
    wp1 = Primitives(*(f[1:-1, 1:-1, 1:-1] for f in wp))
    w_pred = predict_half_step(wp1, grads, dt, cell_size, gamma)

    new_fields = list(u)
    for axis in range(3):
        left, right = _axis_faces(w_pred, grads[axis], axis)
        fluxes = _face_flux(left, right, axis, gamma, riemann_solver)
        inv_dx = 1.0 / float(cell_size[axis])
        for i in range(5):
            f = fluxes[i]
            # crop the other (padded) axes to the domain, diff along `axis`
            for a in range(3):
                if a != axis:
                    f = f.narrow(a, 1, f.shape[a] - 2)
            m = f.shape[axis] - 1
            div = (f.narrow(axis, 1, m) - f.narrow(axis, 0, m)) * inv_dx
            new_fields[i] = new_fields[i] - dt * div

    out = HydroState(*new_fields)
    if gravity is not None:
        out = _gravity_kick(out, u, dt, gravity)
    # enforce positivity (SAFE_HYDRO)
    return out._replace(rho=torch.clamp_min(out.rho, RHO_FLOOR))


def hydro_step_padded(
    u: HydroState,
    wp: Primitives,
    dt,
    *,
    cell_size,
    gamma: float = GAMMA_DEFAULT,
    gravity=None,
    riemann_solver: str = "HLLC",
) -> HydroState:
    """MUSCL-Hancock update from pre-padded primitives (2 ghosts per side).

    CPU tensors run :func:`hydro_step_padded_reference`; CUDA tensors
    launch K3 (``kernels.hydro_step.hydro_step_cuda``), which counts its
    launches in ``kernels.LAUNCHES["hydro_step"]``.  K3 applies the density
    floor itself; the gravity kick, which leaves ρ alone and so commutes
    with the floor, follows it here as elementwise torch.
    """
    if u.rho.device.type == "cpu":
        return hydro_step_padded_reference(
            u, wp, dt, cell_size=cell_size, gamma=gamma, gravity=gravity,
            riemann_solver=riemann_solver,
        )
    out = HydroState(*hydro_step_cuda(
        tuple(u), tuple(wp), _f32(dt), cell_size=cell_size, gamma=gamma,
        riemann_solver=riemann_solver,
    ))
    if gravity is not None:
        out = _gravity_kick(out, u, dt, gravity)
    return out


def cfl_timestep(
    u: HydroState,
    cell_size,
    cfl: float = 0.2,
    gamma: float = GAMMA_DEFAULT,
):
    """CFL-limited timestep (a 0-d tensor on the state's device)."""
    w = primitives_from_conserved(u, gamma)
    cs = torch.sqrt(gamma * w.p / w.rho)
    dt_axes = [
        _div(float(cell_size[a]), torch.abs((w.vx, w.vy, w.vz)[a]) + cs)
        for a in range(3)
    ]
    return cfl * torch.min(
        torch.minimum(dt_axes[0], torch.minimum(dt_axes[1], dt_axes[2]))
    )


# ----------------------------------------------------------- isothermal mode


def isothermal_hydro_step(
    u: HydroState,
    dt,
    *,
    sound_speed: float,
    boundaries,
    cell_size,
    gravity=None,
    inflow_states: Optional[dict] = None,
    gamma_eff: float = 1.0 + 1e-6,
) -> HydroState:
    """Isothermal (γ = 1) step: P = c_s² ρ enforced before and after; the
    step itself runs with γ_eff = 1 + ε (sound speed reduces to c_s)."""
    w = primitives_from_conserved(u, gamma_eff)
    w = w._replace(p=sound_speed**2 * w.rho)
    u = conserved_from_primitives(w, gamma_eff)
    u = hydro_step(
        u, dt,
        boundaries=boundaries, cell_size=cell_size, gamma=gamma_eff,
        gravity=gravity, inflow_states=inflow_states,
    )
    w = primitives_from_conserved(u, gamma_eff)
    w = w._replace(p=sound_speed**2 * w.rho)
    return conserved_from_primitives(w, gamma_eff)


def two_temperature_coupling(
    u: HydroState,
    neutral_fraction,
    *,
    gamma: float,
    ionised_temperature: float = 1.0e4,
    neutral_temperature: float = 100.0,
    shock_temperature: float = 3.0e4,
    radiative_heating: bool = True,
    radiative_cooling: bool = False,
) -> HydroState:
    """Ionization → gas-energy coupling: ionized gas is driven to T_ion,
    neutral gas to T_neutral, shock-heated gas (T > T_shock) is left alone.
    Per-cell elementwise."""
    xH = neutral_fraction
    w = primitives_from_conserved(u, gamma)

    k_over_mp = constants.BOLTZMANN / constants.PROTON_MASS
    T_target = ionised_temperature * (1.0 - xH) + neutral_temperature * xH
    # current gas temperature with mean-particle-mass correction
    T_old = 0.5 * (1.0 + xH) * w.p / (w.rho * k_over_mp)
    shock_heated = T_old > shock_temperature

    ufac = _div(2.0 * k_over_mp, (gamma - 1.0) * (1.0 + xH))
    u_target = ufac * T_target
    u_old = w.p / ((gamma - 1.0) * w.rho)
    du = u_target - u_old
    dE = w.rho * du  # per unit volume

    delta = torch.zeros_like(dE)
    if radiative_heating:
        delta = torch.where(dE > 0.0, dE, delta)
    if radiative_cooling:
        dE_lim = torch.maximum(
            dE, 2.0 * ufac * (neutral_temperature - ionised_temperature) * w.rho
        )
        # factor 1/2 for the mean-particle-mass change
        delta = torch.where(dE < 0.0, 0.5 * dE_lim, delta)
    delta = torch.where(shock_heated, 0.0, delta)
    return u._replace(energy=u.energy + delta)


def apply_hydro_mask(u: HydroState, mask, u_masked: HydroState) -> HydroState:
    """Reset the state inside ``mask`` to fixed values (HydroMask)."""
    return HydroState(*(
        torch.where(mask, masked_field, field)
        for field, masked_field in zip(u, u_masked)
    ))

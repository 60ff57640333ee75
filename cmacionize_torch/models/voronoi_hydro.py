"""Moving-mesh finite-volume hydrodynamics on the Voronoi grid, and the
coupled RHD driver on it (the starbench_voronoi benchmark class).

Port of ``cmacionize_tpu/models/voronoi_hydro.py``.  Re-tessellation stays on
the host (scipy Qhull); the flux update runs on the device over the padded
cell-graph rows:

* the state is INTENSIVE per cell (densities of mass, momentum, energy):
  SI cell volumes (~1e44-1e47 m³) overflow f32, so the geometric factors
  A_face/V_cell are formed on the host in f64 and the update is
  dU_i = -dt Σ_k (A_ik/V_i) F_ik; after a mesh evolve, totals are restored
  by rescaling with V_old/V_new (:func:`remap_after_evolve`);
* per face, the HLLC flux is solved in the face frame (normal velocities
  shifted by the face speed w_n = ½(v_i + v_j)·n̂) and de-boosted back;
  wall faces take the mirror state;
* second order: least-squares cell gradients, Barth-Jespersen limiting with
  a slope factor, per-face pair clamping, half-dt prediction, and a
  face-symmetric first-order fallback on faces of cells that a trial update
  would drain.

:func:`voronoi_flux_update` dispatches on the device: CPU tensors go through
the plain PyTorch version :func:`voronoi_flux_update_reference`, CUDA
tensors through K7 (``csrc/voronoi_flux.cu``).  The plain version keeps the
JAX package's operation order where it can, and writes its sums over a
cell's faces in face order and its 3-term dot products left to right, so
that K7, which repeats those operations one for one, agrees with it on the
card.  Its 3×3 solve is an explicit LU with partial pivoting in LAPACK's
getrf/getrs order; JAX's ``jnp.linalg.solve`` goes through LAPACK, so the
two agree to a stated tolerance, not bit for bit.

Like the JAX function, the gradients form ``w·ΔW`` first with w = 1/|d|² in
m⁻²: in SI units this product underflows f32 for density differences (and
is subnormal for pressure ones), so the density gradients are zero on
starbench-like states (ROADMAP.md, queue 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.kernels.voronoi_flux import voronoi_flux_update_cuda
from cmacionize_torch.models import voronoi
from cmacionize_torch.models.voronoi import VoronoiGrid
from cmacionize_torch.ops import ionization, riemann

_TINY_W = 1e-12  # limiter threshold on a face extrapolation
_DEGENERATE_T1 = 1e-6


class VoronoiHydroState(NamedTuple):
    """Intensive conserved state per cell (SI densities: kg/m³, kg/(m²s),
    J/m³)."""

    rho: torch.Tensor
    mom_x: torch.Tensor
    mom_y: torch.Tensor
    mom_z: torch.Tensor
    energy: torch.Tensor


def conserved_from_primitives(rho, vx, vy, vz, p, volumes, gamma):
    """``volumes`` is accepted for API symmetry but unused (intensive)."""
    del volumes
    return VoronoiHydroState(
        rho=rho,
        mom_x=rho * vx,
        mom_y=rho * vy,
        mom_z=rho * vz,
        energy=riemann._div(p, gamma - 1.0) + 0.5 * rho * (vx**2 + vy**2 + vz**2),
    )


def primitives_from_conserved(state: VoronoiHydroState, volumes, gamma):
    """``volumes`` accepted for API symmetry but unused (intensive).  The
    JAX function's ``jnp.maximum(rho, 1e-300)`` is ``max(rho, 0)`` in f32."""
    del volumes
    rho = state.rho
    inv_rho = 1.0 / torch.clamp_min(rho, 1e-300)
    vx = state.mom_x * inv_rho
    vy = state.mom_y * inv_rho
    vz = state.mom_z * inv_rho
    ekin = 0.5 * (state.mom_x * vx + state.mom_y * vy + state.mom_z * vz)
    p = torch.clamp_min((state.energy - ekin) * (gamma - 1.0), 1e-30)
    return rho, vx, vy, vz, p


def total_mass(state: VoronoiHydroState, volumes) -> float:
    """Σ ρ_i V_i in f64 on the host (volumes overflow f32 on device)."""
    return float(
        (state.rho.cpu().numpy().astype(np.float64) * np.asarray(volumes, np.float64)).sum())


def remap_after_evolve(state: VoronoiHydroState, old_volumes, new_volumes):
    """Restore totals conservation after a mesh evolve: each cell's totals
    ride with its generator, so densities rescale by V_old/V_new."""
    ratio = torch.tensor(
        (np.asarray(old_volumes, np.float64) / np.asarray(new_volumes, np.float64))
        .astype(np.float32), device=state.rho.device)
    return VoronoiHydroState(*(f * ratio for f in state))


# ---------------------------------------------------------------------------
# The plain flux update
# ---------------------------------------------------------------------------


def _ksum(x):
    """Σ over the face axis (dim 1) in face order, as K7 sums."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _dot(a, b):
    """Σ over the last axis of 3, left to right: (a0·b0 + a1·b1) + a2·b2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def lu_solve3(G, b):
    """Solve G x = b for [..., 3, 3] / [..., 3] by LU with partial pivoting in
    LAPACK's order (getrf: first largest |pivot|, the column scaled by the
    pivot's reciprocal, rank-1 updates; getrs: unit-lower then upper
    substitution, column by column), as K7 solves."""
    A = [[G[..., i, j] for j in range(3)] for i in range(3)]
    x = [b[..., i] for i in range(3)]
    for j in range(3):
        # pivot: the first row of largest |A[i][j]|, i >= j
        best = torch.full_like(A[j][j], j, dtype=torch.int64)
        big = A[j][j].abs()
        for i in range(j + 1, 3):
            take = A[i][j].abs() > big
            best = torch.where(take, i, best)
            big = torch.where(take, A[i][j].abs(), big)
        for i in range(j + 1, 3):
            swap = best == i
            for col in range(3):
                A[j][col], A[i][col] = (torch.where(swap, A[i][col], A[j][col]),
                                        torch.where(swap, A[j][col], A[i][col]))
            x[j], x[i] = torch.where(swap, x[i], x[j]), torch.where(swap, x[j], x[i])
        recip = 1.0 / A[j][j]
        for i in range(j + 1, 3):
            A[i][j] = A[i][j] * recip
            for col in range(j + 1, 3):
                A[i][col] = A[i][col] - A[i][j] * A[j][col]
    for k in range(3):  # L y = P b (unit lower)
        for i in range(k + 1, 3):
            x[i] = x[i] - x[k] * A[i][k]
    for k in (2, 1, 0):  # U x = y
        x[k] = x[k] / A[k][k]
        for i in range(k):
            x[i] = x[i] - x[k] * A[i][k]
    return torch.stack(x, -1)


def _lsq_gradients(W, rel_pos, is_cell, dW):
    """Weighted least-squares cell gradients over the neighbour graph:
    G = Σ w d dᵀ, b = Σ w d ΔW, ∇W = G⁻¹ b with w = 1/|d|² (``rel_pos``
    [C,K,3] neighbour − cell generator offsets in meters; ``dW`` [C,K] value
    jumps).  Returns [C,3].  ``w·ΔW`` is rounded before it meets d, as in
    the JAX function."""
    del W
    w = torch.where(is_cell, 1.0 / torch.clamp_min(_dot(rel_pos, rel_pos), 1e-30), 0.0)
    wd = w[..., None] * rel_pos  # [C, K, 3]
    G = torch.stack([
        torch.stack([_ksum(wd[..., a] * rel_pos[..., b]) for b in range(3)], -1)
        for a in range(3)
    ], -2)
    # Tikhonov floor keeps degenerate stencils (boundary cells with < 3
    # independent directions) finite; their gradients limit toward zero
    tr = G[:, 0, 0] + G[:, 1, 1] + G[:, 2, 2]
    floor = 1e-8 * torch.clamp_min(tr, 1e-30)
    G = G + floor[:, None, None] * torch.eye(3, dtype=G.dtype, device=G.device)
    wdw = w * torch.where(is_cell, dW, 0.0)
    b = torch.stack([_ksum(wdw * rel_pos[..., a]) for a in range(3)], -1)
    return lu_solve3(G, b)


def face_basis(normals):
    """(n, t1, t2) per face, [C, K, 3] each: t1 = (-n_y, n_x, 0), or
    (0, -n_z, n_y) where that is shorter than 1e-6, normalised; t2 = n × t1."""
    n = normals
    zero = torch.zeros_like(n[..., 0])
    t1 = torch.stack([-n[..., 1], n[..., 0], zero], -1)
    degen = torch.sqrt(_dot(t1, t1))[..., None] < _DEGENERATE_T1
    t1 = torch.where(degen, torch.stack([zero, -n[..., 2], n[..., 1]], -1), t1)
    t1 = t1 / torch.clamp_min(torch.sqrt(_dot(t1, t1)), 1e-30)[..., None]
    t2 = torch.stack([
        n[..., 1] * t1[..., 2] - n[..., 2] * t1[..., 1],
        n[..., 2] * t1[..., 0] - n[..., 0] * t1[..., 2],
        n[..., 0] * t1[..., 1] - n[..., 1] * t1[..., 0],
    ], -1)
    return n, t1, t2


def voronoi_flux_update_reference(
    neighbors, normals, area_over_vol, face_rel, nbr_rel, state, gen_vel,
    dt, gamma, second_order: bool = True, slope_factor: float = 0.5,
    stats: Optional[dict] = None,
):
    """One moving-face Godunov update of the intensive state, in plain
    PyTorch: the JAX ``_voronoi_flux_update``, step for step.

    ``neighbors`` [C,K] int32; ``normals`` [C,K,3] f32; ``area_over_vol``
    [C,K] f32 A_face/V_cell (1/m); ``face_rel`` [C,K,3] f32 face point − cell
    generator (m); ``nbr_rel`` [C,K,3] f32 neighbour − cell generator (m);
    ``gen_vel`` [C,3] f32 grid velocity; ``dt`` rounded to f32.  With
    ``stats``, ``stats["flag"]`` receives the trial flags (second order) and
    ``stats["gradients"]`` the limited gradients [5, C, 3].
    """
    dt = float(np.float32(dt))
    rho, vx, vy, vz, p = primitives_from_conserved(state, None, gamma)
    nbr = neighbors
    safe_nbr = torch.clamp_min(nbr, 0).to(torch.int64)
    is_cell = nbr >= 0
    is_wall = nbr == -1

    def gather(f):
        return f[safe_nbr]  # [C, K]

    n, t1, t2 = face_basis(normals)

    def project(fx, fy, fz):
        v = torch.stack([fx, fy, fz], -1)
        return _dot(v, n), _dot(v, t1), _dot(v, t2)

    ones = torch.ones_like(area_over_vol)
    if second_order:
        rel = nbr_rel

        def limited_gradient(W):
            dW = gather(W) - W[:, None]
            g = _lsq_gradients(W, rel, is_cell, dW)
            ext = _dot(face_rel, g[:, None, :])
            nbrW = torch.where(is_cell, gather(W), W[:, None])
            Wmax = torch.maximum(torch.amax(nbrW, 1), W)
            Wmin = torch.minimum(torch.amin(nbrW, 1), W)
            hi = (Wmax - W)[:, None]
            lo = (Wmin - W)[:, None]
            a = torch.where(
                ext > _TINY_W, hi / torch.clamp_min(ext, _TINY_W),
                torch.where(ext < -_TINY_W, lo / torch.clamp_max(ext, -_TINY_W), 1.0),
            )
            a = torch.where(is_cell | is_wall, a, 1.0)
            alpha = slope_factor * torch.clamp(torch.amin(a, dim=1), 0.0, 1.0)
            return g * alpha[:, None]

        gr_rho, gr_vx, gr_vy, gr_vz, gr_p = (
            limited_gradient(W) for W in (rho, vx, vy, vz, p))
        if stats is not None:
            stats["gradients"] = torch.stack([gr_rho, gr_vx, gr_vy, gr_vz, gr_p])

        # half-dt primitive prediction (predict_primitive_variables)
        half = 0.5 * dt
        div_v = gr_vx[:, 0] + gr_vy[:, 1] + gr_vz[:, 2]
        inv_rho_c = 1.0 / torch.clamp_min(rho, 1e-300)

        def vdot(g):
            return vx * g[:, 0] + vy * g[:, 1] + vz * g[:, 2]

        rho_p = rho - half * (vdot(gr_rho) + rho * div_v)
        vx_p = vx - half * (vdot(gr_vx) + gr_p[:, 0] * inv_rho_c)
        vy_p = vy - half * (vdot(gr_vy) + gr_p[:, 1] * inv_rho_c)
        vz_p = vz - half * (vdot(gr_vz) + gr_p[:, 2] * inv_rho_c)
        p_p = p - half * (vdot(gr_p) + gamma * p * div_v)
        # positivity: fall back to the unpredicted value (SAFE_HYDRO)
        rho_p = torch.where(rho_p > 0.0, rho_p, rho)
        p_p = torch.where(p_p > 0.0, p_p, p)

        arm_j = face_rel - nbr_rel  # the neighbour's arm to the face point

        def face_L(Wp, g):
            return Wp[:, None] + _dot(face_rel, g[:, None, :])

        def face_R(Wp, g):
            return gather(Wp) + _dot(arm_j, g[safe_nbr])

        def pair_clamp(L, R, Wi, Wj):
            # per-face pair limiting (Hydro.hpp:108 ``limit``): face values
            # stay within the envelope of the two cell values
            lo = torch.minimum(Wi[:, None], Wj)
            hi = torch.maximum(Wi[:, None], Wj)
            return (torch.minimum(torch.maximum(L, lo), hi),
                    torch.minimum(torch.maximum(R, lo), hi))

        rhoL, rhoR_c = pair_clamp(
            face_L(rho_p, gr_rho), face_R(rho_p, gr_rho), rho, gather(rho))
        pL, pR_c = pair_clamp(face_L(p_p, gr_p), face_R(p_p, gr_p), p, gather(p))
        vxL, vxR = pair_clamp(face_L(vx_p, gr_vx), face_R(vx_p, gr_vx), vx, gather(vx))
        vyL, vyR = pair_clamp(face_L(vy_p, gr_vy), face_R(vy_p, gr_vy), vy, gather(vy))
        vzL, vzR = pair_clamp(face_L(vz_p, gr_vz), face_R(vz_p, gr_vz), vz, gather(vz))
        rhoL2 = torch.clamp_min(rhoL, 1e-30)
        pL2 = torch.clamp_min(pL, 1e-30)
        uL2, ut1L2, ut2L2 = project(vxL, vyL, vzL)
        rhoR2 = torch.where(is_cell, torch.clamp_min(rhoR_c, 1e-30), rhoL2)
        pR2 = torch.where(is_cell, torch.clamp_min(pR_c, 1e-30), pL2)
        uRn, ut1R2, ut2R2 = project(vxR, vyR, vzR)
        uR2 = torch.where(is_cell, uRn, -uL2)
        ut1R2 = torch.where(is_cell, ut1R2, ut1L2)
        ut2R2 = torch.where(is_cell, ut2R2, ut2L2)

    # first-order left/right states (also the per-cell fallback below)
    rhoL1 = rho[:, None] * ones
    pL1 = p[:, None] * ones
    uL1, ut1L1, ut2L1 = project(vx[:, None] * ones, vy[:, None] * ones, vz[:, None] * ones)
    # right (neighbour) state; wall → mirror (flip normal velocity)
    rhoR1 = torch.where(is_cell, gather(rho), rhoL1)
    pR1 = torch.where(is_cell, gather(p), pL1)
    uRn1, ut1R1, ut2R1 = project(gather(vx), gather(vy), gather(vz))
    uR1 = torch.where(is_cell, uRn1, -uL1)
    ut1R1 = torch.where(is_cell, ut1R1, ut1L1)
    ut2R1 = torch.where(is_cell, ut2R1, ut2L1)

    # face speed along the normal (moving mesh); walls don't move
    gvn, _, _ = project(gen_vel[:, 0][:, None] * ones, gen_vel[:, 1][:, None] * ones,
                        gen_vel[:, 2][:, None] * ones)
    gvn_nbr, _, _ = project(gather(gen_vel[:, 0]), gather(gen_vel[:, 1]),
                            gather(gen_vel[:, 2]))
    w_n = torch.where(is_cell, 0.5 * (gvn + gvn_nbr), 0.0)
    wA = area_over_vol * (is_cell | is_wall).to(area_over_vol.dtype) * dt

    def deltas(rhoL, uL, ut1L, ut2L, pL, rhoR, uR, ut1R, ut2R, pR):
        flux = riemann.hllc_flux(
            rhoL, uL - w_n, ut1L, ut2L, pL,
            rhoR, uR - w_n, ut1R, ut2R, pR,
            gamma=gamma,
        )
        f_rho, f_un, f_ut1, f_ut2, f_e = flux
        # de-boost to the lab frame
        f_e = f_e + w_n * (f_un + 0.5 * w_n * f_rho)
        f_un = f_un + w_n * f_rho
        # rotate momentum flux back to xyz
        fm = f_un[..., None] * n + f_ut1[..., None] * t1 + f_ut2[..., None] * t2
        return (
            -_ksum(f_rho * wA),
            torch.stack([-_ksum(fm[..., a] * wA) for a in range(3)], -1),
            -_ksum(f_e * wA),
        )

    if second_order:
        # trial second-order update → flag cells it would strongly drain;
        # then recompute with first-order states on every face touching a
        # flagged cell (symmetric, so conservation is untouched)
        d2 = deltas(rhoL2, uL2, ut1L2, ut2L2, pL2, rhoR2, uR2, ut1R2, ut2R2, pR2)
        rho2 = state.rho + d2[0]
        e2 = state.energy + d2[2]
        flag = ((rho2 < 0.25 * state.rho) | (e2 < 0.25 * state.energy)
                | ~torch.isfinite(rho2) | ~torch.isfinite(e2))
        if stats is not None:
            stats["flag"] = flag
        bad_face = flag[:, None] | torch.where(is_cell, flag[safe_nbr], False)

        def pick(a1, a2):
            return torch.where(bad_face, a1, a2)

        d_rho, d_mom, d_energy = deltas(
            pick(rhoL1, rhoL2), pick(uL1, uL2), pick(ut1L1, ut1L2),
            pick(ut2L1, ut2L2), pick(pL1, pL2),
            pick(rhoR1, rhoR2), pick(uR1, uR2), pick(ut1R1, ut1R2),
            pick(ut2R1, ut2R2), pick(pR1, pR2),
        )
    else:
        d_rho, d_mom, d_energy = deltas(
            rhoL1, uL1, ut1L1, ut2L1, pL1, rhoR1, uR1, ut1R1, ut2R1, pR1)
    return VoronoiHydroState(
        rho=state.rho + d_rho,
        mom_x=state.mom_x + d_mom[:, 0],
        mom_y=state.mom_y + d_mom[:, 1],
        mom_z=state.mom_z + d_mom[:, 2],
        energy=state.energy + d_energy,
    )


def voronoi_flux_update(neighbors, normals, area_over_vol, face_rel, nbr_rel, state,
                        gen_vel, dt, gamma, second_order: bool = True,
                        slope_factor: float = 0.5, stats: Optional[dict] = None):
    """One moving-face Godunov update (arguments as
    :func:`voronoi_flux_update_reference`).

    CPU tensors run :func:`voronoi_flux_update_reference`; CUDA tensors
    launch K7 (``kernels.voronoi_flux``), which counts its launches in
    ``kernels.LAUNCHES["voronoi_flux"]``.
    """
    if state.rho.device.type == "cpu":
        return voronoi_flux_update_reference(
            neighbors, normals, area_over_vol, face_rel, nbr_rel, state, gen_vel, dt,
            gamma, second_order, slope_factor, stats)
    return VoronoiHydroState(*voronoi_flux_update_cuda(
        neighbors, normals, area_over_vol, face_rel, nbr_rel, tuple(state), gen_vel,
        dt, gamma=gamma, second_order=second_order, slope_factor=slope_factor,
        stats=stats))


# ---------------------------------------------------------------------------
# Per-grid tables and the step
# ---------------------------------------------------------------------------


def neighbor_offsets(grid: VoronoiGrid) -> np.ndarray:
    """[C, K, 3] f32 apparent neighbour generator − cell generator (meters);
    zero on wall/padding faces."""
    g = np.asarray(grid.generators, np.float64)
    nbr = grid.neighbors
    safe = np.maximum(nbr, 0)
    rel = g[safe] - g[:, None, :]
    if grid.shifts is not None:
        # crossing shifts map into the true neighbour frame (pos += shift),
        # so the APPARENT neighbour position is g_true − shift
        rel = rel - np.asarray(grid.shifts, np.float64)
    rel = np.where((nbr >= 0)[..., None], rel, 0.0)
    return (rel * grid.scale).astype(np.float32)


def face_arms(grid: VoronoiGrid) -> np.ndarray:
    """[C, K, 3] f32 face point − cell generator (meters): the TRUE face
    polygon centroid where the grid carries it, else the bisector midpoint
    for cell faces and the generator's wall projection for wall faces."""
    g = np.asarray(grid.generators, np.float64)
    nbr = grid.neighbors
    rel = neighbor_offsets(grid).astype(np.float64) / grid.scale
    n = np.asarray(grid.normals, np.float64)
    dist = np.asarray(grid.offsets, np.float64) - np.einsum("cka,ca->ck", n, g)
    wall_arm = dist[..., None] * n
    arm = np.where((nbr >= 0)[..., None], 0.5 * rel, wall_arm)
    if grid.face_centroids is not None:
        fc_arm = np.asarray(grid.face_centroids, np.float64) - g[:, None, :]
        arm = np.where((nbr != -2)[..., None], fc_arm, arm)
    arm = np.where((nbr != -2)[..., None], arm, 0.0)
    return (arm * grid.scale).astype(np.float32)


class HydroTables(NamedTuple):
    """The per-grid inputs of the flux update, on one device."""

    neighbors: torch.Tensor  # [C, K] int32
    normals: torch.Tensor  # [C, K, 3] f32
    area_over_vol: torch.Tensor  # [C, K] f32, formed in f64 on the host
    face_rel: torch.Tensor  # [C, K, 3] f32 (m)
    nbr_rel: torch.Tensor  # [C, K, 3] f32 (m)


def hydro_tables(grid: VoronoiGrid, device) -> HydroTables:
    """``grid``'s flux-update tables on ``device``, as the JAX
    ``voronoi_hydro_step`` forms them on every call."""
    area_over_vol = (np.asarray(grid.areas, np.float64) * grid.scale**2
                     / np.asarray(grid.volumes, np.float64)[:, None]).astype(np.float32)

    def put(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return HydroTables(
        put(grid.neighbors, torch.int32), put(grid.normals), put(area_over_vol),
        put(face_arms(grid)), put(neighbor_offsets(grid)),
    )


def voronoi_hydro_step(
    grid: VoronoiGrid,
    state: VoronoiHydroState,
    gen_velocities_si,  # [C, 3] m/s — the grid velocity (set_grid_velocity)
    dt: float,
    gamma: float = 5.0 / 3.0,
    second_order: bool = True,
    slope_factor: float = 0.5,
    *,
    tables: Optional[HydroTables] = None,
) -> VoronoiHydroState:
    """Advance the intensive state one step on the (possibly moving) mesh.
    ``tables`` (from :func:`hydro_tables`) saves forming the per-grid
    tables on every call."""
    device = state.rho.device
    if tables is None:
        tables = hydro_tables(grid, device)
    gen_vel = torch.as_tensor(gen_velocities_si, dtype=torch.float32, device=device)
    return voronoi_flux_update(
        *tables, state, gen_vel.contiguous(), dt, gamma, second_order, slope_factor)


def evolve_voronoi_grid(grid: VoronoiGrid, gen_velocities_si, dt: float) -> VoronoiGrid:
    """Drift the generators with the grid velocity and re-tessellate (the
    VoronoiDensityGrid::evolve equivalent).  Non-periodic axes clamp
    generators inside the box; periodic axes wrap."""
    sides = np.asarray(grid.geometry.sides, np.float64)
    box = sides / grid.scale
    pts = grid.generators + np.asarray(gen_velocities_si) * dt / grid.scale
    eps = 1e-6
    for axis in range(3):
        if grid.geometry.periodic[axis]:
            pts[:, axis] = np.mod(pts[:, axis], box[axis])
        else:
            pts[:, axis] = np.clip(pts[:, axis], eps * box[axis], (1.0 - eps) * box[axis])
    return voronoi._tessellate_with_fallback(grid.geometry, pts, box, grid.scale)


def grid_velocity_from_fluid(grid: VoronoiGrid, state: VoronoiHydroState, gamma: float,
                             damp: float = 1.0) -> np.ndarray:
    """set_grid_velocity: generators follow the local fluid velocity, as a
    [C, 3] numpy array (one host readback)."""
    _, vx, vy, vz, _ = primitives_from_conserved(state, None, gamma)
    return damp * torch.stack([vx, vy, vz], 1).cpu().numpy()


# ---------------------------------------------------------------------------
# Coupled RHD on the Voronoi grid (starbench_voronoi)
# ---------------------------------------------------------------------------


class VoronoiRHDSimulation(voronoi._NoRestart):
    """Coupled MC photoionization + finite-volume hydro on a Voronoi mesh.

    Per fixed-dt step: ``nloop`` MC ionization iterations over the cell
    graph (K6 on the card) → the two-temperature ionization/energy coupling
    per cell → the moving-face Godunov update (K7 on the card).
    ``mesh_motion`` turns on the Lagrangian mesh: generators follow the
    fluid and the grid is re-tessellated on the host every step.

    The JAX driver forms the per-grid tables (A/V, the arms, the neighbour
    offsets), the source cell and the normalisation on every step; the port
    forms them once per grid, again only after a re-tessellation.
    """

    STATE_FIELDS = ("rho", "mom_x", "mom_y", "mom_z", "energy", "neutral_fraction")

    def __init__(self, grid: VoronoiGrid, *, device, gamma, timestep, luminosity,
                 source_position, cross_section, recombination_rate,
                 n_photons, nloop, number_density, temperature,
                 neutral_temperature=100.0, ionised_temperature=1.0e4,
                 shock_temperature=3.0e4, mesh_motion=False,
                 second_order=True, seed=42, mesh=None):
        if mesh is not None:
            raise NotImplementedError(f"VoronoiRHDSimulation: {voronoi.MESH_NOT_PORTED}")
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.gamma = float(gamma)
        self.dt = float(timestep)
        self.luminosity = luminosity
        self.source_position = np.asarray(source_position, float)
        self.sigma = cross_section
        self.alpha = recombination_rate
        self.n_photons = n_photons
        self.nloop = nloop
        self.neutral_temperature = neutral_temperature
        self.ionised_temperature = ionised_temperature
        self.shock_temperature = shock_temperature
        self.mesh_motion = bool(mesh_motion)
        self.second_order = bool(second_order)
        self._set_grid(grid)

        C = grid.n_cells
        # scalars OR per-cell [C] arrays, cast to f32 as the JAX driver does
        nd0 = np.broadcast_to(np.asarray(number_density, np.float32), (C,))
        T0 = np.broadcast_to(np.asarray(temperature, np.float32), (C,))
        nd0 = torch.tensor(nd0, device=self.device)
        T0 = torch.tensor(T0, device=self.device)
        rho0 = nd0 * constants.PROTON_MASS
        p0 = nd0 * constants.BOLTZMANN * T0
        zeros = torch.zeros(C, dtype=torch.float32, device=self.device)
        self.state = conserved_from_primitives(rho0, zeros, zeros, zeros, p0, None, self.gamma)
        self.neutral_fraction = torch.ones(C, dtype=torch.float32, device=self.device)
        self.time = 0.0

    def _set_grid(self, grid: VoronoiGrid) -> None:
        """Take ``grid`` and form its device tables once."""
        self.grid = grid
        self._march_tables = voronoi.voronoi_tables(grid, self.device)
        self._hydro_tables = hydro_tables(grid, self.device)
        self._src_u = voronoi._source_in_box_units(grid, self.source_position)
        self._src_cell = int(grid.locate(self._src_u)[0])
        self._jfac = torch.tensor(
            np.asarray(self.luminosity * self.sigma
                       / (self.n_photons * np.asarray(grid.volumes, np.float64)), np.float32),
            device=self.device)

    def load_reference_state(self, arrays: dict, time: Optional[float] = None) -> None:
        """Continue from the JAX driver's ``rho, mom_x, mom_y, mom_z, energy``
        (``sim.state``) and ``neutral_fraction`` as numpy arrays, and
        optionally its ``time``."""
        fields = {}
        for name in self.STATE_FIELDS:
            value = np.asarray(arrays[name], np.float32)
            if value.shape != (self.grid.n_cells,):
                raise ValueError(f"{name}: shape {value.shape} != ({self.grid.n_cells},)")
            fields[name] = torch.tensor(value, device=self.device)
        self.neutral_fraction = fields.pop("neutral_fraction")
        self.state = VoronoiHydroState(**fields)
        if time is not None:
            self.time = float(time)

    def _radiation(self):
        nd = riemann._div(self.state.rho, constants.PROTON_MASS)
        xh = self.neutral_fraction
        for _ in range(self.nloop):
            chi_si = nd * xh * self.sigma
            packets = voronoi.emit_voronoi_point_source(
                self.generator, self.n_photons, self._src_u, self._src_cell)
            tally, _ = voronoi.trace_packets_voronoi(
                self.grid, chi_si, packets, tables=self._march_tables)
            xh = ionization.hydrogen_neutral_fraction(tally * self._jfac, nd, self.alpha)
        return xh

    def _couple(self, state, xh):
        """Two-temperature ionization → energy coupling (heating only), per
        cell on the intensive state."""
        rho = state.rho
        k_over_mp = constants.BOLTZMANN / constants.PROTON_MASS
        inv_rho = 1.0 / torch.clamp_min(rho, 1e-300)
        vx = state.mom_x * inv_rho
        vy = state.mom_y * inv_rho
        vz = state.mom_z * inv_rho
        ekin = 0.5 * (state.mom_x * vx + state.mom_y * vy + state.mom_z * vz)
        u_spec = torch.clamp_min((state.energy - ekin) * inv_rho, 0.0)
        T_target = (self.ionised_temperature * (1.0 - xh) + self.neutral_temperature * xh)
        ufac = riemann._div(2.0 * k_over_mp, (self.gamma - 1.0) * (1.0 + xh))
        T_old = u_spec / torch.clamp_min(ufac, 1e-300)
        du = ufac * T_target - u_spec
        heat = torch.where((du > 0.0) & (T_old < self.shock_temperature), du, 0.0)
        return state._replace(energy=state.energy + heat * rho)

    def run(self, n_steps: int, log=None):
        """Take ``n_steps`` more fixed-dt steps; returns (state, xH)."""
        for step in range(n_steps):
            if self.nloop > 0:
                self.neutral_fraction = self._radiation()
                self.state = self._couple(self.state, self.neutral_fraction)
            if self.mesh_motion:
                vel = grid_velocity_from_fluid(self.grid, self.state, self.gamma)
            else:
                vel = torch.zeros((self.grid.n_cells, 3), dtype=torch.float32,
                                  device=self.device)
            self.state = voronoi_hydro_step(
                self.grid, self.state, vel, self.dt, self.gamma,
                second_order=self.second_order, tables=self._hydro_tables)
            if self.mesh_motion:
                old_volumes = self.grid.volumes
                self._set_grid(evolve_voronoi_grid(self.grid, vel, self.dt))
                self.state = remap_after_evolve(self.state, old_volumes, self.grid.volumes)
            self.time += self.dt
            if log is not None and (step + 1) % 32 == 0:
                log(f"step {step + 1}/{n_steps} "
                    f"<xH>={float(torch.mean(self.neutral_fraction)):.3f}")
        return self.state, self.neutral_fraction

    def ionization_front_radius(self) -> float:
        """Radius of the sphere with the ionized volume (m)."""
        xh = self.neutral_fraction.cpu().numpy()
        v_ion = float(((xh < 0.5) * np.asarray(self.grid.volumes)).sum())
        return (3.0 * v_ion / (4.0 * np.pi)) ** (1.0 / 3.0)

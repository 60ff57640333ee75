"""K13h, K13e, K13w and K13f, the deposit and DDA-step probes
(``csrc/probe_deposit.cu``), with their plain versions.

:func:`shifted_histogram` (``out[c] = Σ_t Σ_{i<nstep} dep[t]·[(lidx[t] + i)
mod 128 = c]``), :func:`dda_math` (``tools/probe_deposit.py``'s E body),
:func:`dda_incremental` (``tools/probe_deposit2.py``'s W2 body) and
:func:`fill_first` (its D12 body) dispatch on the device: CPU tensors run
their ``*_reference``, CUDA tensors launch the kernel, which counts its
launches in ``kernels.LAUNCHES`` under the wrapper's name.  There is no
fallback between the two.  The wrappers check devices, dtypes and
contiguity.

K13f launches through :mod:`kernels.launch` (a launcher typed once, PyTorch's
raw stream, an identity check of its tensor), the others through the ctypes
path of :mod:`kernels.gather`.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.gather import _check, _function, _launch
from cmacionize_torch.kernels.launch import Launcher, check_one
from cmacionize_torch.ops.traversal import _fma

NAME = "probe_deposit"
CELLS = 128
_FILL_FIRST = Launcher(NAME, "cmi_fill_first", 2, 0)
HISTOGRAM_STEP_CHUNK = 128  # steps the plain histogram deposits per index_add_


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of f32 ``x``, as ``sqrtf`` on the
    card and XLA on the CPU give it: torch's CPU f32 ``sqrt`` (AVX-512) is off
    by an ulp in ~0.6% of inputs, and an f64 root rounded once to f32 is
    exact."""
    return torch.sqrt(x.double()).to(x.dtype)


def shifted_histogram_reference(dep: torch.Tensor, lidx: torch.Tensor, nstep: int):
    """Plain version of K13h: every deposit of every step, added in f64 by
    ``index_add_`` over chunks of steps, rounded once to f32."""
    dep64 = dep.reshape(-1).double()
    lidx64 = lidx.reshape(-1).long()
    acc = torch.zeros(CELLS, dtype=torch.float64, device=dep.device)
    for first in range(0, nstep, HISTOGRAM_STEP_CHUNK):
        steps = torch.arange(first, min(first + HISTOGRAM_STEP_CHUNK, nstep), device=dep.device)
        cells = (lidx64[None, :] + steps[:, None]) % CELLS
        acc.index_add_(0, cells.reshape(-1), dep64.expand(steps.numel(), -1).reshape(-1))
    return acc.float()


def dda_math_reference(a: torch.Tensor, b: torch.Tensor, nstep: int) -> torch.Tensor:
    """Plain version of K13e: e_kernel's loop in torch, its three position
    updates and its radicand rounded once (``_fma``), as XLA fuses them."""
    dx, dy = a, b
    dz = _sqrt(torch.clamp(_fma(-dy, dy, _fma(-dx, dx, torch.ones_like(dx))), min=0.0))
    # the three axes stacked: one torch op per step serves all three
    d = torch.stack((dx, dy, dz))
    denominator = torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
    px = a * 32.0
    p = torch.stack((px, px + 1.0, px + 2.0))
    tau = px * 9.0
    for _ in range(nstep):
        l_exit = ((torch.floor(p) + 1.0 - p) / denominator).abs().amin(0)
        chi = torch.clamp(p[0] * 0.01, min=1e-30)
        tau_cell = chi * l_exit
        absorbed = tau_cell >= tau
        lt = torch.where(absorbed, tau / chi, l_exit)
        p = _fma(d, lt.expand_as(d), p)
        tau = torch.where(absorbed, 0.0, tau - tau_cell)
    return p[0] + tau


def dda_incremental_reference(a: torch.Tensor, b: torch.Tensor, nstep: int) -> torch.Tensor:
    """Plain version of K13w: w2_kernel's loop in torch.  It divides by
    tensors: torch's CUDA division by a Python scalar multiplies by the
    reciprocal."""
    dx, dy = a, b
    one = torch.ones_like(dx)
    dz = _sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=1e-6))
    td_x, td_y, td_z = (one / d for d in (dx, dy, dz))
    td_x, td_y, td_z = td_x.abs(), td_y.abs(), td_z.abs()
    tmx, tmy, tmz = td_x, td_y * 1.1, td_z * 1.2
    tau, t_cur = a * 9.0, torch.zeros_like(dx)
    for _ in range(nstep):
        t_exit = torch.minimum(tmx, torch.minimum(tmy, tmz))
        chi = torch.clamp(tmx * 0.01, min=1e-30)
        tau_cell = chi * (t_exit - t_cur)
        absorbed = tau_cell >= tau
        cx = t_exit == tmx
        cy = ~cx & (t_exit == tmy)
        cz = ~cx & ~cy
        tmx = torch.where(cx, tmx + td_x, tmx)
        tmy = torch.where(cy, tmy + td_y, tmy)
        tmz = torch.where(cz, tmz + td_z, tmz)
        tau = torch.where(absorbed, tau, tau - tau_cell)
        t_cur = t_exit
    return tmx + tau


def fill_first_reference(dep: torch.Tensor) -> torch.Tensor:
    """Plain version of K13f: ``dep.flat[0]`` in every cell of [1, 128]."""
    return dep.reshape(-1)[:1].expand(1, CELLS).clone()


def _check_pair(label, names, x, y, dtypes):
    """x and y: contiguous, of ``dtypes``, on one device, of one shape with
    fewer than 2^31 elements (any number of dimensions)."""
    _check(label, ((names[0], x, dtypes[0], None), (names[1], y, dtypes[1], None)), x.device)
    if x.shape != y.shape:
        raise ValueError(f"{label}: {names[0]} and {names[1]} must have one shape; got "
                         f"{list(x.shape)} and {list(y.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{label}: sizes must fit int32")


def _check_nstep(label, nstep):
    if not 0 <= nstep < 2**31 - CELLS:
        raise ValueError(f"{label}: nstep must lie in [0, 2^31 - 128); got {nstep}")


def shifted_histogram(dep: torch.Tensor, lidx: torch.Tensor, nstep: int) -> torch.Tensor:
    """``out[c] = Σ_t Σ_{i<nstep} dep[t]·[(lidx[t] + i) mod 128 = c]``: dep
    f32 and lidx int32 of one shape (read flat), out f32 [128].  On the card
    the sums are taken in the atomics' order, the blocks' partial sums added
    in f64: exact for integer weights, within ~1e-7 otherwise."""
    if dep.device.type == "cpu":
        return shifted_histogram_reference(dep, lidx, nstep)
    _check_pair("shifted_histogram", ("dep", "lidx"), dep, lidx, (torch.float32, torch.int32))
    _check_nstep("shifted_histogram", nstep)
    out = torch.empty(CELLS, dtype=torch.float32, device=dep.device)
    scratch = torch.empty(CELLS, dtype=torch.float64, device=dep.device)
    _launch("shifted_histogram", _function("cmi_shifted_histogram", 4, 2, NAME), dep, lidx, out,
            scratch, dep.numel(), nstep)
    LAUNCHES["shifted_histogram"] += 1
    return out


def dda_math(a: torch.Tensor, b: torch.Tensor, nstep: int) -> torch.Tensor:
    """``tools/probe_deposit.py``'s E body: ``px + τ`` after ``nstep`` DDA
    steps per lane, direction (a, b, √(1 − a² − b²)) from px = 32a; f32 of
    the inputs' shape."""
    if a.device.type == "cpu":
        return dda_math_reference(a, b, nstep)
    _check_pair("dda_math", ("a", "b"), a, b, (torch.float32, torch.float32))
    _check_nstep("dda_math", nstep)
    out = torch.empty_like(a)
    _launch("dda_math", _function("cmi_dda_math", 3, 2, NAME), a, b, out, a.numel(), nstep)
    LAUNCHES["dda_math"] += 1
    return out


def dda_incremental(a: torch.Tensor, b: torch.Tensor, nstep: int) -> torch.Tensor:
    """``tools/probe_deposit2.py``'s W2 body: ``tmx + τ`` after ``nstep``
    Amanatides-Woo steps per lane; f32 of the inputs' shape."""
    if a.device.type == "cpu":
        return dda_incremental_reference(a, b, nstep)
    _check_pair("dda_incremental", ("a", "b"), a, b, (torch.float32, torch.float32))
    _check_nstep("dda_incremental", nstep)
    out = torch.empty_like(a)
    _launch("dda_incremental", _function("cmi_dda_incremental", 3, 2, NAME), a, b, out,
            a.numel(), nstep)
    LAUNCHES["dda_incremental"] += 1
    return out


def check_fill_first(dep: torch.Tensor) -> tuple:
    """K13f's checks: (device index,) of its launch, which takes no size, or
    ValueError.  ``dep`` has any number of dimensions, at least one
    element and, as every tensor of this module's wrappers, fewer than 2^31."""
    index = check_one("fill_first", "dep", dep, torch.float32, None)
    if not 0 < dep.numel() < 2**31:
        raise ValueError("fill_first: dep must not be empty" if dep.numel() == 0 else
                         "fill_first: sizes must fit int32")
    return (index,)


def fill_first(dep: torch.Tensor) -> torch.Tensor:
    """``tools/probe_deposit2.py``'s D12 body, ``zeros + dep[0, 0]`` as
    [1, 128]: f32 [1, 128] filled with ``dep.flat[0]`` (its bits: XLA folds
    the addition of zero, so a −0.0 stays −0.0)."""
    if dep.device.type == "cpu":
        return fill_first_reference(dep)
    (index,) = check_fill_first(dep)
    out = dep.new_empty(1, CELLS)
    _FILL_FIRST(index, dep.data_ptr(), out.data_ptr())
    LAUNCHES["fill_first"] += 1
    return out

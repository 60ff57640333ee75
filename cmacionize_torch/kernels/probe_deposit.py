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

K13h, K13f and K13e launch through :mod:`kernels.launch` (a launcher typed
once, PyTorch's raw stream, identity checks of the tensors), K13w through the
ctypes path of :mod:`kernels.gather`.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.gather import _check, _function, _launch
from cmacionize_torch.kernels.launch import Launcher, check_one, check_pair, raw_stream
from cmacionize_torch.ops.traversal import _fma

NAME = "probe_deposit"
CELLS = 128
DDA_THREADS = 32  # K13e's threads a block (csrc/probe_deposit.cu: kDdaThreads)
_FILL_FIRST = Launcher(NAME, "cmi_fill_first", 2, 0)
_DDA_MATH = Launcher(NAME, "cmi_dda_math", 3, 2)
_SHIFTED_HISTOGRAM = Launcher(NAME, "cmi_shifted_histogram", 5, 3)
HISTOGRAM_STEP_CHUNK = 128  # steps the plain histogram deposits per index_add_
# K13h's grid (csrc/probe_deposit.cu: kHistThreads, kHistBlocks): blocks of
# 1024 packets, the steps split while the grid has at most 128 blocks
HISTOGRAM_THREADS, HISTOGRAM_BLOCKS = 1024, 128
# K13h's scratch by (CUDA device index, raw stream): (f64 rows of 128, the
# ticket, whether it was made in a CUDA graph's capture)
_HISTOGRAM_SCRATCH: dict = {}


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


def histogram_scratch(index: int, n: int) -> tuple:
    """K13h's scratch on PyTorch's current stream of CUDA device ``index``
    for ``n`` packets: f64 rows of 128, one a block of its grid (at most 128
    blocks, or one a block of packets where there are more; grown as calls
    need), and the ticket, zeroed on that stream with each new scratch; K13h
    leaves the ticket at 0 after each launch.  A scratch made while the
    stream was being captured into a CUDA graph was zeroed only in the
    graph, so a call outside a capture makes its own."""
    rows = max(HISTOGRAM_BLOCKS, -(-n // HISTOGRAM_THREADS))
    key = (index, raw_stream(index))
    kept = _HISTOGRAM_SCRATCH.get(key)
    if kept is not None and kept[2] and not torch.cuda.is_current_stream_capturing():
        kept = None
    if kept is None or kept[0].shape[0] < rows:
        device = torch.device("cuda", index)
        kept = (torch.empty((rows, CELLS), dtype=torch.float64, device=device),
                torch.zeros(1, dtype=torch.int32, device=device),
                torch.cuda.is_current_stream_capturing())
        _HISTOGRAM_SCRATCH[key] = kept
    return kept


def check_shifted_histogram(dep: torch.Tensor, lidx: torch.Tensor, nstep: int) -> tuple:
    """K13h's checks: (device index, n, nstep) of its launch, or ValueError.
    ``dep`` f32 and ``lidx`` int32: contiguous, on one CUDA device, of one
    shape (any number of dimensions) with fewer than 2^31 elements;
    0 <= nstep < 2^31 - 128."""
    index = check_pair("shifted_histogram", "dep", dep, torch.float32, dep.ndim, "lidx", lidx,
                       torch.int32, None)
    if dep.shape != lidx.shape:
        raise ValueError(f"shifted_histogram: dep and lidx must have one shape; got "
                         f"{list(dep.shape)} and {list(lidx.shape)}")
    if dep.numel() >= 2**31:
        raise ValueError("shifted_histogram: sizes must fit int32")
    _check_nstep("shifted_histogram", nstep)
    return index, dep.numel(), nstep


def shifted_histogram(dep: torch.Tensor, lidx: torch.Tensor, nstep: int) -> torch.Tensor:
    """``out[c] = Σ_t Σ_{i<nstep} dep[t]·[(lidx[t] + i) mod 128 = c]``: dep
    f32 and lidx int32 of one shape (read flat), out f32 [128].  On the card
    one launch sums each warp's deposits into f32 bins, the bins of a block
    in f64, and the blocks' rows in f64 in a fixed order, then rounds once:
    exact for integer weights, within ~1e-7 otherwise, and the same bits from
    every call on the same inputs.

    The scratch rows and the ticket are kept per device and stream
    (:func:`histogram_scratch`): the calls of one stream run one after
    another, and calls on two streams use scratches of their own.  A launch
    that fails drops its stream's scratch, so no later call reads its
    ticket."""
    if dep.device.type == "cpu":
        return shifted_histogram_reference(dep, lidx, nstep)
    index, n, nstep = check_shifted_histogram(dep, lidx, nstep)
    out = dep.new_empty(CELLS)
    rows, ticket, _ = histogram_scratch(index, n)
    try:
        _SHIFTED_HISTOGRAM(index, dep.data_ptr(), lidx.data_ptr(), out.data_ptr(),
                           rows.data_ptr(), ticket.data_ptr(), n, nstep, rows.shape[0])
    except RuntimeError:
        _HISTOGRAM_SCRATCH.pop((index, raw_stream(index)), None)
        raise
    LAUNCHES["shifted_histogram"] += 1
    return out


def dda_math(a: torch.Tensor, b: torch.Tensor, nstep: int) -> torch.Tensor:
    """``tools/probe_deposit.py``'s E body: ``px + τ`` after ``nstep`` DDA
    steps per lane, direction (a, b, √(1 − a² − b²)) from px = 32a; f32 of
    the inputs' shape."""
    if a.device.type == "cpu":
        return dda_math_reference(a, b, nstep)
    (index,) = check_dda_math(a, b, nstep)
    out = torch.empty_like(a)
    _DDA_MATH(index, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), nstep)
    LAUNCHES["dda_math"] += 1
    return out


def check_dda_math(a: torch.Tensor, b: torch.Tensor, nstep: int) -> tuple:
    """K13e's checks: (device index,) of its launch, or ValueError.  ``a`` and
    ``b``: f32, contiguous, on one CUDA device, of one shape (any number of
    dimensions) with fewer than 2^31 elements; 0 <= nstep < 2^31 - 128."""
    index = check_pair("dda_math", "a", a, torch.float32, a.ndim, "b", b, torch.float32, None)
    if a.shape != b.shape:
        raise ValueError(f"dda_math: a and b must have one shape; got {list(a.shape)} and "
                         f"{list(b.shape)}")
    if a.numel() >= 2**31:
        raise ValueError("dda_math: sizes must fit int32")
    _check_nstep("dda_math", nstep)
    return (index,)


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

"""A lean ctypes launch path, for kernels whose launch is most of a call.

The ctypes path of :mod:`cmacionize_torch.kernels.gather` (``_check``,
``torch.empty``, ``_function``, ``_launch``) costs two to three times the
host time of one ``torch.gather`` call.  ``tools/launch_cost.py`` times its
steps alone on the card's host (PERF.md §6): ``torch.empty(...,
device=)``, the ``Stream`` object of ``torch.cuda.current_stream`` and
``torch.cuda.device``'s enter and exit take most of it, then the launch, the
tuple-driven checks and ctypes.  This path cuts each of them:

- a :class:`Launcher` loads its library and types its ``extern "C"``
  function once, at its first call;
- the stream is PyTorch's current raw stream of the tensors' device as an int
  (:data:`raw_stream`, no ``Stream`` object), and ``torch.cuda.device`` is
  entered only when that device is not the current one;
- :func:`check_pair` (two tensors) and :func:`check_one` compare each
  tensor's dtype by identity and its device index, dimension count (any,
  where it is given as None) and contiguity, and build a message only when
  one of them is wrong;
- the wrapper allocates its output with ``torch.empty_like``, the cheapest
  of the allocations timed.

What it keeps: outputs allocated by torch (nothing by ``cudaMalloc``), the
launch on PyTorch's current stream of the tensors' device with no
synchronise, so the calls can be captured into a CUDA graph; ``ValueError`` on
a wrong device, dtype, dimension count, shape, contiguity or int32 overflow;
``RuntimeError`` when the launcher's ``cudaGetLastError()`` is not 0; the
launch counted in ``kernels.LAUNCHES`` by the wrapper.  There is no fallback:
a library that cannot be built, or a launch that fails, raises.

Used by K1 (``kernels/trace_packets.py``), K2
(``kernels/trace_packets_spectral.py``), K3 (``kernels/hydro_step.py``), K4
and K4f (``kernels/temperature.py``), K5s (``kernels/trace_octree_spectral.py``), K6
(``kernels/trace_voronoi.py``), K7 (``kernels/voronoi_flux.py``), K9c and K9p
(``kernels/compact.py``), K11 and K11r
(``kernels/gather.py``), K12s, K12t and K12r (``kernels/probe_gather.py``),
K13f (``kernels/probe_deposit.py``) and K14c (``kernels/probe_cohort.py``);
every other kernel keeps its own launch code.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels.build import load_library

# PyTorch's current raw stream of a device index and the current device's
# index, as ints (None where torch is built without CUDA: the wrappers never
# launch there)
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
current_device = getattr(torch._C, "_cuda_getDevice", None)


class Launcher:
    """The ``extern "C"`` launcher ``symbol`` of ``csrc/<library>.cu``, which
    takes ``n_pointers`` pointers, ``n_ints`` ints, ``n_floats`` floats and
    the stream and returns ``cudaGetLastError()``: ``launcher(index,
    *pointers_ints_and_floats)`` launches on PyTorch's current stream of CUDA
    device ``index``, with that device current, and raises RuntimeError if
    the launch fails.  The library is built (on first use), loaded and typed
    at the first call."""

    __slots__ = ("library", "symbol", "argtypes", "function")

    def __init__(self, library: str, symbol: str, n_pointers: int, n_ints: int,
                 n_floats: int = 0):
        self.library, self.symbol = library, symbol
        self.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                         + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        self.function = None

    def bind(self):
        """Build (on first use) and load the library; type, keep and return
        the launcher."""
        function = getattr(load_library(self.library), self.symbol)
        function.argtypes, function.restype = self.argtypes, ctypes.c_int
        self.function = function
        return function

    def __call__(self, index: int, *args: int) -> None:
        function = self.function
        if function is None:
            function = self.bind()
        stream = raw_stream(index)
        if index == current_device():
            err = function(*args, stream)
        else:
            with torch.cuda.device(index):
                err = function(*args, stream)
        if err:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")


def check_pair(label: str, a_name: str, a: torch.Tensor, a_dtype, a_dim: int,
               b_name: str, b: torch.Tensor, b_dtype, b_dim: int | None) -> int:
    """The CUDA device index of ``a`` and ``b``, which must have those dtypes
    and numbers of dimensions (``b`` any where ``b_dim`` is None), lie on one
    CUDA device and be contiguous; raises ValueError naming the first that
    does not."""
    index = a.get_device()
    if (a.dtype is a_dtype and b.dtype is b_dtype and a.ndim == a_dim
            and (b_dim is None or b.ndim == b_dim) and a.is_cuda and b.get_device() == index
            and b.is_cuda and a.is_contiguous() and b.is_contiguous()):
        return index
    raise ValueError(_first_wrong(label, a.device if a.is_cuda else "a CUDA device",
                                  ((a_name, a, a_dtype, a_dim), (b_name, b, b_dtype, b_dim))))


def check_one(label: str, name: str, t: torch.Tensor, dtype, dim: int | None) -> int:
    """The CUDA device index of ``t``, which must have that dtype and number
    of dimensions (any where ``dim`` is None) and be contiguous; raises
    ValueError if it does not."""
    if t.dtype is dtype and (dim is None or t.ndim == dim) and t.is_cuda and t.is_contiguous():
        return t.get_device()
    raise ValueError(_first_wrong(label, t.device if t.is_cuda else "a CUDA device",
                                  ((name, t, dtype, dim),)))


def _first_wrong(label: str, device, tensors) -> str:
    """The message of the first of ``tensors`` (name, tensor, dtype, dim)
    that is not on ``device`` with its dtype and dim (any where dim is None),
    or not contiguous."""
    for name, t, dtype, dim in tensors:
        if str(t.device) != str(device) or t.dtype != dtype or dim not in (None, t.dim()):
            shape = "" if dim is None else f"{dim}D "
            return (f"{label}: {name} must be a {shape}{dtype} tensor on {device}; "
                    f"got {t.dim()}D {t.dtype} on {t.device}")
        if not t.is_contiguous():
            return f"{label}: {name} must be contiguous"
    return f"{label}: the arguments must lie on one CUDA device"


def kernel_occupancy(library: str, symbol: str, device) -> dict:
    """Registers per thread and blocks resident per SM of a kernel, and the
    SM count of CUDA ``device``, from the ``extern "C"`` query ``symbol`` of
    ``csrc/<library>.cu`` (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; ``csrc/occupancy.cuh``)."""
    fn = getattr(load_library(library), symbol)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    values = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(*(ctypes.byref(v) for v in values))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return dict(zip(("registers", "blocks_per_sm", "sms"), (v.value for v in values)))

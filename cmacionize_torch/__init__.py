"""cmacionize_torch: the PyTorch + CUDA port of cmacionize_tpu.

A second package beside the JAX package ``cmacionize_tpu``, which stays the
reference it is held against.  Plain tensor code is PyTorch; the device
kernels are written by hand for Hopper (``sm_90a``) in ``csrc/`` and are
built on first use (``kernels/``).  The port imports ``torch`` and numpy and
never JAX or any ``cmacionize_tpu`` module.

Package layout (module and function names follow the JAX package):
    utils/     parameter files (a YAML-subset reader), units, logging, TimeLine,
               iteration diagnostics
    ops/       photon traversal (K1 and K2 dispatch + plain versions), the
               H, H-He and metal balances, atomic rates and line cooling,
               the temperature balance (K4 and K4f dispatch + plain
               version),
               Riemann solvers and the MUSCL-Hancock step (K3 dispatch +
               plain version)
    models/    grid geometry, point sources and spectra (tabulated stellar
               atmospheres too), density functions, re-emission, trackers,
               the H-only, multi-frequency and RHD drivers
    kernels/   nvcc build + ctypes loader, kernel wrappers, launch counts
    csrc/      CUDA C++ sources of the kernels
    data.py    the atomic tables, read by path from cmacionize_tpu/data/
    device.py  the CUDA device the port runs on
"""

__version__ = "0.1.0"

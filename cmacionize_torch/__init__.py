"""cmacionize_torch: the PyTorch + CUDA port of cmacionize_tpu.

A second package beside the JAX package ``cmacionize_tpu``, which stays the
reference it is held against.  Plain tensor code is PyTorch; the device
kernels are written by hand for Hopper (``sm_90a``) in ``csrc/`` and are
built on first use (``kernels/``).  The port imports ``torch`` and numpy and
never JAX or any ``cmacionize_tpu`` module.

Package layout (module and function names follow the JAX package):
    utils/     parameter files (a YAML-subset reader), units, logging, TimeLine
    ops/       photon traversal (K1 dispatch + plain version), H balance,
               Riemann solvers and the MUSCL-Hancock step (K3 dispatch +
               plain version)
    models/    grid geometry, point sources, density functions, the H-only
               and the RHD drivers
    kernels/   nvcc build + ctypes loader, kernel wrappers, launch counts
    csrc/      CUDA C++ sources of the kernels
    device.py  the CUDA device the port runs on
"""

__version__ = "0.1.0"

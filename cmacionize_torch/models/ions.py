"""Element and ion bookkeeping.

A copy of ``cmacionize_tpu/models/ions.py`` (pure Python), so that the port
imports no JAX.  The tracked ions are the ionizable states of the reference's
default element set (its src/ElementNames.hpp); for H and He the tracked
fraction is the neutral one, for the metals the reference's stage-storage
convention applies (see ``ops/ionization.metal_ion_fractions``).
"""

from __future__ import annotations

# The default (full) ion set, in reference order.
ION_NAMES = (
    "H_n",
    "He_n",
    "C_p1",
    "C_p2",
    "N_n",
    "N_p1",
    "N_p2",
    "O_n",
    "O_p1",
    "Ne_n",
    "Ne_p1",
    "S_p1",
    "S_p2",
    "S_p3",
)

# index constants (full set)
ION_H_n = 0
ION_He_n = 1
ION_C_p1 = 2
ION_C_p2 = 3
ION_N_n = 4
ION_N_p1 = 5
ION_N_p2 = 6
ION_O_n = 7
ION_O_p1 = 8
ION_Ne_n = 9
ION_Ne_p1 = 10
ION_S_p1 = 11
ION_S_p2 = 12
ION_S_p3 = 13
NUMBER_OF_IONS = len(ION_NAMES)

ELEMENT_NAMES = ("H", "He", "C", "N", "O", "Ne", "S")

# element of each ion (index into ELEMENT_NAMES)
ION_ELEMENT = (0, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 6, 6)

# number of heating tally channels (H and He photo-heating)
HEATING_H = 0
HEATING_He = 1
NUMBER_OF_HEATING_TERMS = 2

# default metal abundances used by the Lexington benchmarks (number relative
# to hydrogen), cf. benchmarks/lexingtonHII20.param
DEFAULT_ABUNDANCES = {
    "He": 0.1,
    "C": 2.2e-4,
    "N": 4.0e-5,
    "O": 3.3e-4,
    "Ne": 5.0e-5,
    "S": 9.0e-6,
}

# the twelve metal slots, in ION_NAMES order
METAL_NAMES = ION_NAMES[2:]

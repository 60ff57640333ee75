"""Physical constants in SI units.

Values match the reference implementation's constant table
(the reference's src/PhysicalConstants.hpp:74-125) so that benchmark results
are numerically comparable.

A copy of ``cmacionize_tpu/constants.py``, so that the port imports no JAX.
"""

# Planck constant (J s)
PLANCK = 6.626070040e-34
# Boltzmann constant (J K^-1)
BOLTZMANN = 1.38064852e-23
# speed of light (m s^-1)
LIGHTSPEED = 299792458.0
# electron volt (J)
ELECTRONVOLT = 1.6021766208e-19
# proton mass (kg)
PROTON_MASS = 1.672621898e-27
# electron mass (kg)
ELECTRON_MASS = 9.10938356e-31
# Rydberg energy (J)
RYDBERG_ENERGY = 2.179872325e-18
# Newton gravitational constant (m^3 kg^-1 s^-2)
NEWTON_CONSTANT = 6.67408e-11
# solar mass (kg)
SOLAR_MASS = 1.9891e30
# astronomical unit (m)
ASTRONOMICAL_UNIT = 1.496e11

# parsec (m)
PARSEC = 3.086e16
# Julian year (s)
YEAR = 365.25 * 24.0 * 3600.0

# ionization threshold frequencies (Hz) used for photo-heating tallies,
# cf. the reference's src/DensitySubGrid.hpp:600-610 (3.288e15 for H,
# 5.948e15 for He)
NU_ION_H = 3.288e15
NU_ION_HE = 5.948e15

# frequency of a 13.6 eV photon (Hz): the hydrogen ionization edge
FREQ_13P6_EV = 13.6 * ELECTRONVOLT / PLANCK

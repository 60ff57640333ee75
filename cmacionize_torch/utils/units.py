"""Physical unit parsing and conversion.

Replaces the reference's UnitConverter/Unit system
(src/UnitConverter.hpp:62-89, src/Unit.hpp)
with a general dimensional-analysis parser: a unit string is a space-separated
product of `symbol^exponent` tokens ("cm^3 s^-1", "erg cm^-3 K^-1", "pc").

Every unit is represented as a scale factor to SI plus a dimension vector over
the base dimensions (m, kg, s, K, A). Parsing a quantity string like
"100. cm^-3" yields the SI value and its dimensions; callers may assert the
expected dimensions.

The port's own copy of ``cmacionize_tpu/utils/units.py`` (pure Python):
importing any ``cmacionize_tpu`` module can import JAX, which the port never
does.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction

# base dimension order: length, mass, time, temperature, current
_NDIM = 5


@dataclass(frozen=True)
class Unit:
    """A unit: SI scale factor + dimension exponents (m, kg, s, K, A)."""

    factor: float
    dims: tuple

    def __mul__(self, other: "Unit") -> "Unit":
        return Unit(
            self.factor * other.factor,
            tuple(a + b for a, b in zip(self.dims, other.dims)),
        )

    def __pow__(self, exp) -> "Unit":
        return Unit(self.factor**exp, tuple(d * exp for d in self.dims))

    def is_dimensionless(self) -> bool:
        return all(d == 0 for d in self.dims)


def _u(factor, m=0, kg=0, s=0, K=0, A=0) -> Unit:
    return Unit(factor, (m, kg, s, K, A))


DIMENSIONLESS = _u(1.0)

# Base + derived unit symbols.  SI factors for the astronomy units match the
# reference's UnitConverter table (src/UnitConverter.hpp).
_UNITS = {
    # base
    "m": _u(1.0, m=1),
    "kg": _u(1.0, kg=1),
    "s": _u(1.0, s=1),
    "K": _u(1.0, K=1),
    "A": _u(1.0, A=1),
    # length
    "cm": _u(1e-2, m=1),
    "mm": _u(1e-3, m=1),
    "km": _u(1e3, m=1),
    "pc": _u(3.086e16, m=1),
    "kpc": _u(3.086e19, m=1),
    "Mpc": _u(3.086e22, m=1),
    "au": _u(1.496e11, m=1),
    "AU": _u(1.496e11, m=1),
    "angstrom": _u(1e-10, m=1),
    "nm": _u(1e-9, m=1),
    # mass
    "g": _u(1e-3, kg=1),
    "Msol": _u(1.9891e30, kg=1),
    "Msun": _u(1.9891e30, kg=1),
    "amu": _u(1.66053904e-27, kg=1),
    # time
    "h": _u(3600.0, s=1),
    "yr": _u(365.25 * 24.0 * 3600.0, s=1),
    "kyr": _u(365.25 * 24.0 * 3600.0 * 1e3, s=1),
    "Myr": _u(365.25 * 24.0 * 3600.0 * 1e6, s=1),
    "Gyr": _u(365.25 * 24.0 * 3600.0 * 1e9, s=1),
    "hr": _u(3600.0, s=1),
    "min": _u(60.0, s=1),
    "day": _u(86400.0, s=1),
    # frequency
    "Hz": _u(1.0, s=-1),
    # energy
    "J": _u(1.0, m=2, kg=1, s=-2),
    "erg": _u(1e-7, m=2, kg=1, s=-2),
    "eV": _u(1.6021766208e-19, m=2, kg=1, s=-2),
    "keV": _u(1.6021766208e-16, m=2, kg=1, s=-2),
    # force / pressure
    "N": _u(1.0, m=1, kg=1, s=-2),
    "Pa": _u(1.0, m=-1, kg=1, s=-2),
    "bar": _u(1e5, m=-1, kg=1, s=-2),
    "ba": _u(0.1, m=-1, kg=1, s=-2),  # barye (cgs pressure)
    # power / luminosity
    "W": _u(1.0, m=2, kg=1, s=-3),
    "Lsol": _u(3.828e26, m=2, kg=1, s=-3),
    # velocity convenience
    "c": _u(299792458.0, m=1, s=-1),
    # temperature-like energies are handled by eV / K directly
    # angle (dimensionless)
    "rad": _u(1.0),
    "radians": _u(1.0),
    "degrees": _u(3.141592653589793 / 180.0),
}

# Dimension vectors for common named quantities, used for optional validation.
QUANTITY_DIMS = {
    "length": (1, 0, 0, 0, 0),
    "mass": (0, 1, 0, 0, 0),
    "time": (0, 0, 1, 0, 0),
    "temperature": (0, 0, 0, 1, 0),
    "frequency": (0, 0, -1, 0, 0),
    "frequency per time": (0, 0, -2, 0, 0),
    "number density": (-3, 0, 0, 0, 0),
    "density": (-3, 1, 0, 0, 0),
    "surface area": (2, 0, 0, 0, 0),
    "surface density": (-2, 1, 0, 0, 0),
    "volume": (3, 0, 0, 0, 0),
    "reaction rate": (3, 0, -1, 0, 0),
    "velocity": (1, 0, -1, 0, 0),
    "acceleration": (1, 0, -2, 0, 0),
    "momentum": (1, 1, -1, 0, 0),
    "energy": (2, 1, -2, 0, 0),
    "pressure": (-1, 1, -2, 0, 0),
    "energy rate": (2, 1, -3, 0, 0),
    "energy change rate": (2, 1, -3, 0, 0),
    "luminosity": (2, 1, -3, 0, 0),
    "flux": (0, 1, -3, 0, 0),
    "opacity": (-1, 0, 0, 0, 0),  # m^-1, cf. UnitConverter.hpp:214
    "angle": (0, 0, 0, 0, 0),
    "dimensionless": (0, 0, 0, 0, 0),
}

_TOKEN_RE = re.compile(r"^([A-Za-z]+)(?:\^(-?\d+(?:\.\d+)?(?:/\d+)?))?$")


def parse_unit(text: str) -> Unit:
    """Parse a unit expression like "cm^3 s^-1" into a :class:`Unit`."""
    text = text.strip()
    if not text:
        return DIMENSIONLESS
    unit = DIMENSIONLESS
    for token in text.split():
        mo = _TOKEN_RE.match(token)
        if mo is None:
            raise ValueError(f"cannot parse unit token {token!r} in {text!r}")
        symbol, exp_str = mo.group(1), mo.group(2)
        if symbol not in _UNITS:
            raise ValueError(f"unknown unit symbol {symbol!r} in {text!r}")
        if exp_str is None:
            exp = 1
        elif "/" in exp_str:
            exp = Fraction(exp_str)
        elif "." in exp_str:
            exp = float(exp_str)
        else:
            exp = int(exp_str)
        unit = unit * (_UNITS[symbol] ** exp)
    return unit


_NUMBER_RE = re.compile(
    r"^\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)\s*(.*)$"
)


def parse_quantity(text, expected_dims=None):
    """Parse "100. cm^-3" → SI float.

    Accepts plain numbers (int/float) as already-SI/dimensionless values.
    ``expected_dims`` may be a quantity name from :data:`QUANTITY_DIMS` or a
    dimension tuple; a mismatch raises ``ValueError``.
    """
    if isinstance(text, (int, float)):
        return float(text)
    mo = _NUMBER_RE.match(str(text))
    if mo is None:
        raise ValueError(f"cannot parse quantity {text!r}")
    value = float(mo.group(1))
    unit = parse_unit(mo.group(2))
    if expected_dims is not None:
        if isinstance(expected_dims, str):
            expected_dims = QUANTITY_DIMS[expected_dims]
        if not unit.is_dimensionless() and tuple(unit.dims) != tuple(expected_dims):
            # photon energies are accepted where frequencies are expected
            # (E = hν), matching the reference's UnitConverter special case
            # for QUANTITY_FREQUENCY (src/UnitConverter.hpp)
            planck = 6.626070040e-34
            if (
                tuple(expected_dims) == QUANTITY_DIMS["frequency"]
                and tuple(unit.dims) == QUANTITY_DIMS["energy"]
            ):
                return value * unit.factor / planck
            raise ValueError(
                f"quantity {text!r} has dimensions {unit.dims}, "
                f"expected {expected_dims}"
            )
    return value * unit.factor


def to_si(value: float, unit_str: str) -> float:
    """Convert ``value`` expressed in ``unit_str`` to SI."""
    return value * parse_unit(unit_str).factor


def convert(value: float, from_unit: str, to_unit: str) -> float:
    """Convert between two unit strings (must share dimensions)."""
    fu, tu = parse_unit(from_unit), parse_unit(to_unit)
    if fu.dims != tu.dims:
        raise ValueError(f"incompatible units {from_unit!r} → {to_unit!r}")
    return value * fu.factor / tu.factor

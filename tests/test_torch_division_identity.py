"""The division that K13e and K10 take without ``__fdiv_rn``, held to IEEE
division on the CPU in exact rational arithmetic.

Both kernels divide by a loop-invariant divisor s: K13e its wall distances
``(floor(p) + 1 - p) / s`` by the lane's direction components (1e-12 where a
component is smaller), K10 its plane times ``(g + e - q) / ds`` and its slab
exit ``(8 or 0 - q) / ds`` by the lane's clamped direction (|ds| >= 1e-9).
Each lane forms ``r = RN(1 / s)`` once and takes every quotient as
``q0 = RN(a r)``, ``e = RN(fma(-s, q0, a))``, ``q = RN(fma(e, r, q0))``.  By
Markstein's theorem that is ``RN(a / s)`` when the remainder is exact and no
step under- or overflows; the kernels take it for a = 0 and |a| >= 2^-64 and
divide a smaller numerator with ``__fdiv_rn``.  Here the two fused
multiply-adds are computed exactly with ``fractions.Fraction`` and rounded to
f32 once (ties to even), and every quotient is compared with numpy's f32
division (IEEE, correctly rounded) bit for bit, on seeded samples of the
operands each kernel divides.
"""

import pathlib
from fractions import Fraction

import numpy as np
import pytest

CSRC = pathlib.Path(__file__).resolve().parent.parent / "cmacionize_torch" / "csrc"
F32 = np.float32
LEAST_NUMERATOR = F32(2.0**-64)


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded to the nearest f32, ties to even (subnormals included)."""
    if x == 0:
        return F32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    unit = Fraction(2) ** (max(e, -126) - 23)  # the spacing of f32 at x
    m = x / unit
    whole = m.numerator // m.denominator
    rest = m - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2 == 1):
        whole += 1
    return F32(sign * float(whole * unit))


def _fma(a, b, c) -> np.float32:
    """fma(a, b, c) rounded once; an exact zero takes IEEE's sign (negative
    only where a·b and c are both zeros of that sign)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    if exact == 0:
        product_negative = bool(np.signbit(F32(a)) != np.signbit(F32(b)))
        both = a * b == 0 and c == 0 and product_negative and bool(np.signbit(F32(c)))
        return F32(-0.0) if both else F32(0.0)
    return _round_f32(exact)


def _two_fma_quotient(a, s) -> np.float32:
    r = F32(1.0) / F32(s)
    q0 = F32(a) * r
    e = _fma(-F32(s), q0, a)
    return _fma(e, r, q0)


def _assert_identity(numerators, divisors):
    bad = []
    for a, s in zip(numerators, divisors):
        a, s = F32(a), F32(s)
        if not (a == 0 or abs(a) >= LEAST_NUMERATOR):
            continue  # the kernels divide these with __fdiv_rn
        got, want = _two_fma_quotient(a, s), a / s
        if got.view(np.int32) != want.view(np.int32):
            bad.append((float(a), float(s), float(got), float(want)))
    assert not bad, bad[:5]


def _all_ones(rng, n, lo, hi):
    """Divisors whose significand is all ones (the f32 just below a power of
    two), with random signs: the hardest case of a correctly rounded
    reciprocal."""
    powers = F32(2.0) ** rng.integers(lo, hi, n).astype(F32)
    return np.nextafter(powers, F32(0.0)) * rng.choice(F32([-1.0, 1.0]), n)


def test_the_kernels_take_the_quotient_above_the_same_least_numerator():
    for name in ("probe_deposit.cu", "trace_packets_cone.cu"):
        source = (CSRC / name).read_text()
        assert "constexpr float kLeastNumerator = 0x1p-64f;" in source, name
        assert "__fmaf_rn(-" in source and "__frcp_rn(" in source, name


@pytest.mark.parametrize("seed", [0, 1])
def test_k13e_wall_quotients_equal_ieee_division(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    # positions over the probe's range and beyond, and just below integers
    p = rng.uniform(-40.0, 400.0, n).astype(F32)
    p[: n // 10] = np.nextafter(np.floor(p[: n // 10]) + F32(1.0), F32(-np.inf))
    p[n // 10: n // 5] = -rng.uniform(0.0, 1.0, n // 10).astype(F32) * F32(2.0) ** rng.integers(
        -60, 0, n // 10).astype(F32)
    numerators = (np.floor(p) + F32(1.0)) - p
    # direction components a, b and dz = sqrt(1 - a^2 - b^2), each divisor
    # replaced by 1e-12 below it in magnitude
    d = rng.uniform(-1.0, 1.0, n).astype(F32)
    d[: n // 8] = rng.uniform(0.0, 1e-3, n // 8).astype(F32)
    d[n // 8: n // 4] = 0.0
    d[n // 4: n // 3] = _all_ones(rng, n // 3 - n // 4, -20, 1)
    divisors = np.where(np.abs(d) > F32(1e-12), d, F32(1e-12))
    assert (divisors == F32(1e-12)).sum() > 0
    _assert_identity(numerators, rng.permutation(divisors))
    _assert_identity(numerators, divisors)


@pytest.mark.parametrize("seed", [2, 3])
def test_k10_plane_time_quotients_equal_ieee_division(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    # slab-local positions q = p - corner: in and just outside the 8^3 slab,
    # on and beside its planes, and 0
    p = rng.uniform(0.0, 64.0, n).astype(F32)
    corner = rng.integers(0, 57, n).astype(F32)
    q = p - corner
    q[: n // 10] = rng.integers(0, 9, n // 10).astype(F32)
    q[n // 10: n // 5] = np.nextafter(q[n // 10: n // 5], F32(np.inf))
    q[n // 5: n // 4] = rng.uniform(-1.0, 9.0, n // 4 - n // 5).astype(F32)
    pos = rng.random(n) < 0.5
    g = rng.integers(0, 8, n).astype(F32)
    entry = (g + np.where(pos, F32(0.0), F32(1.0))) - q
    exit_ = np.where(pos, F32(8.0), F32(0.0)) - q
    # clamped unit-vector components: |ds| >= 1e-9
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True))[:, 0].astype(F32)
    d[: n // 10] = rng.uniform(-1e-8, 1e-8, n // 10).astype(F32)
    d[n // 10: n // 6] = _all_ones(rng, n // 6 - n // 10, -29, 1)
    ds = np.where(d > 0, np.maximum(d, F32(1e-9)), np.minimum(d, F32(-1e-9)))
    assert (np.abs(ds) == F32(1e-9)).sum() > 0
    _assert_identity(entry, ds)
    _assert_identity(exit_, ds)
    _assert_identity(np.zeros(64, F32), ds[:64])  # a plane through the position: ±0


def test_signed_zero_quotients_keep_their_sign():
    for s in (F32(0.5), F32(-0.5), F32(1e-9), F32(-1e-9)):
        got, want = _two_fma_quotient(F32(0.0), s), F32(0.0) / s
        assert got.view(np.int32) == want.view(np.int32), s


def test_k8_march_takes_the_quotient_in_the_same_range():
    source = (CSRC / "peel_march.cuh").read_text()
    assert "constexpr float kLeastNumerator = 0x1p-64f;" in source
    assert "constexpr float kGreatestNumerator = 2.0f;" in source
    assert "__fmaf_rn(-s, q0, a)" in source and "__frcp_rn(" in source
    assert "__fdiv_rn(" in source  # the batches whose numerators leave the range
    # the range test on the bits: |a| in [2^-64, 2] exactly where
    # bits(|a|) - bits(2^-64) <= bits(2) - bits(2^-64), unsigned
    least = int(F32(2.0**-64).view(np.uint32))
    span = int(F32(2.0).view(np.uint32)) - least
    assert f"constexpr unsigned kLeastBits = {least:#010x}u;" in source
    assert "constexpr unsigned kNumeratorSpan = 0x40000000u - kLeastBits;" in source
    a = np.concatenate([F32([0.0, 2.0**-64, 2.0**-65, 2.0, 3.0, np.inf, np.nan]),
                        np.nextafter(F32([2.0**-64, 2.0]), F32([0.0, 4.0])),
                        np.random.default_rng(6).standard_normal(4000).astype(F32)])
    bits = (a.view(np.uint32) & np.uint32(0x7FFFFFFF)).astype(np.uint64)
    in_range = ((bits - least) % 2**32) <= span
    with np.errstate(invalid="ignore"):
        want = (np.abs(a) >= F32(2.0**-64)) & (np.abs(a) <= F32(2.0))
    assert np.array_equal(in_range, want)


def _k8_divisors(rng):
    """The march direction's components of the dusty_galaxy observer
    (θ = 89.7°, φ = 0, as the port's driver forms it), and seeded unit
    directions with one component near 1e-12; only the components that the
    march divides by (|s| > 1e-12)."""
    from cmacionize_torch.ops.peel_off import observer_march_direction

    theta = np.radians(89.7)
    observer = (np.sin(theta), 0.0, np.cos(theta))
    divisors = [np.asarray(observer_march_direction(observer), F32)]
    for _ in range(100):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        d[rng.integers(0, 3)] = rng.choice([-1.0, 1.0]) * rng.uniform(1.0, 8.0) * 1e-12
        divisors.append(d.astype(F32))
    divisors = np.concatenate(divisors)
    return divisors[np.abs(divisors) > F32(1e-12)]


@pytest.mark.parametrize("seed", [4, 5])
def test_k8_wall_quotients_equal_ieee_division(seed):
    rng = np.random.default_rng(seed)
    divisors = _k8_divisors(rng)
    theta = np.radians(89.7)
    assert abs(divisors[1] - F32(np.cos(theta))) < 1e-6  # the observer's z component
    assert (np.abs(divisors) < F32(1e-11)).sum() > 0
    n = 2000
    # wall - pos in cell units: a position in its cell (0 < a <= 1 toward
    # the wall ahead), snapped onto the wall behind (a = ±1), just past the
    # wall by round-off (a in [-1e-6, 0)), on the wall ahead (a = 0)
    a = rng.uniform(-1e-6, 1.0, n).astype(F32)
    cells = rng.integers(0, 201, n).astype(F32)
    pos = cells + rng.uniform(0.0, 1.0, n).astype(F32)
    a[: n // 4] = (cells[: n // 4] + F32(1.0)) - pos[: n // 4]
    special = np.array([0.0, 2.0**-64, -(2.0**-64), 1.0, -1.0, np.nextafter(F32(1), F32(2)),
                        np.nextafter(F32(1), F32(0)), -np.nextafter(F32(1), F32(2)),
                        -np.nextafter(F32(1), F32(0)), 2.0**-63, 1e-6, -1e-6], F32)
    a[: special.size] = special
    # every numerator by the observer's components, by the seeded ones in
    # turn, and the special numerators by every divisor
    for s in divisors[:2]:
        _assert_identity(a, np.full(n, s, F32))
    _assert_identity(a, rng.choice(divisors[2:], n))
    _assert_identity(np.tile(special, divisors.size), np.repeat(divisors, special.size))

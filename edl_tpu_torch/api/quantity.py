"""Kubernetes-style resource quantity parsing and arithmetic — the port's
copy of edl_tpu.api.quantity, unchanged.

The reference scheduler does all of its accounting in k8s
``resource.Quantity`` units: CPU scaled to milli-cores and memory scaled to
megabytes, both rounded *up* (reference pkg/autoscaler.go:44-52 —
``ScaledValue(resource.Milli)`` / ``ScaledValue(resource.Mega)``), and exact
comparison for the sort tiebreaks (pkg/autoscaler.go:103-125).  This module
reproduces those semantics exactly (the JAX package's tests/test_quantity.py ports
the reference's accounting assertions from pkg/autoscaler_internal_test.go:96-101)
so the planner's arithmetic is bit-for-bit compatible, while staying a tiny
dependency-free implementation on top of ``fractions.Fraction``.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from functools import total_ordering

# Decimal-SI and binary suffixes accepted by k8s quantities.
_SUFFIX_MULTIPLIERS: dict[str, Fraction] = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}

# Binary suffixes are uppercase-first only (Ki..Ei); 'ki'/'ni'/'mi'/'ui'
# are invalid, as in k8s.
_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>[KMGTPE]i|[numkMGTPE])|[eE](?P<exp>[+-]?\d+))?$"
)

# Scales mirroring k8s resource.Scale constants.
MILLI = -3
NONE = 0
KILO = 3
MEGA = 6
GIGA = 9


@total_ordering
class Quantity:
    """An exact resource quantity ("1", "250m", "100Mi", "1k", "2e3", ...)."""

    __slots__ = ("_value",)

    def __init__(self, value: "Quantity | Fraction | int | float | str" = 0):
        if isinstance(value, Quantity):
            self._value = value._value
        elif isinstance(value, str):
            self._value = _parse(value)
        elif isinstance(value, (int, Fraction)):
            self._value = Fraction(value)
        elif isinstance(value, float):
            self._value = Fraction(value).limit_denominator(10**9)
        else:
            raise TypeError(f"cannot build Quantity from {type(value)!r}")

    # -- accessors ---------------------------------------------------------

    @property
    def exact(self) -> Fraction:
        return self._value

    def value(self) -> int:
        """Whole-unit value, rounded away from zero (k8s ``Value()``)."""
        return self.scaled_value(NONE)

    def milli_value(self) -> int:
        return self.scaled_value(MILLI)

    def scaled_value(self, scale: int) -> int:
        """Value at 10**scale, rounded away from zero (k8s ``ScaledValue``)."""
        scaled = self._value / Fraction(10) ** scale
        if scaled >= 0:
            return math.ceil(scaled)
        return math.floor(scaled)

    def is_zero(self) -> bool:
        return self._value == 0

    # -- arithmetic / comparison ------------------------------------------

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self._value + Quantity(other)._value)

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self._value - Quantity(other)._value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, (Quantity, int, float, str, Fraction)):
            try:
                return self._value == Quantity(other)._value
            except ValueError:  # unparsable string: unequal, never raise
                return False
        return NotImplemented

    def __lt__(self, other: "Quantity") -> bool:
        return self._value < Quantity(other)._value

    def __hash__(self) -> int:
        return hash(self._value)

    def __bool__(self) -> bool:
        return not self.is_zero()

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"

    def __str__(self) -> str:
        v = self._value
        if v == v.numerator:  # integral
            return str(v.numerator)
        milli = v * 1000
        if milli == milli.numerator:
            return f"{milli.numerator}m"
        return f"{float(v):g}"


def _parse(text: str) -> Fraction:
    s = text.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {text!r}")
    num = Fraction(m.group("num"))
    if m.group("exp") is not None:
        mult = Fraction(10) ** int(m.group("exp"))
    else:
        suffix = m.group("suffix") or ""
        mult = _SUFFIX_MULTIPLIERS[suffix]
    value = num * mult
    if m.group("sign") == "-":
        value = -value
    return value


def parse_quantity(text: "str | int | float | Quantity") -> Quantity:
    return Quantity(text)

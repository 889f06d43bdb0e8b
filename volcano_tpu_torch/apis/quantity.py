"""Kubernetes resource-quantity parsing.

A copy of ``volcano_tpu/apis/quantity.py``.

Mirrors the subset of k8s.io/apimachinery resource.Quantity semantics the
reference scheduler relies on (reference: pkg/scheduler/api/resource_info.go
NewResource — MilliValue for cpu/scalars, Value for memory/pods).

Quantities are decimal strings; ``milli_value``/``int_value`` must be exact
like Go's infinite-precision Quantity math, so they scale with Fraction
rather than float multiplication (float 13*1e-3 = 0.013000000000000001,
which a naive ceil would inflate to 14m).
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}


def _parse_exact(value) -> Fraction:
    """Parse a k8s quantity ("100m", "1Gi", 2, "1.5") exactly."""
    if isinstance(value, int):
        return Fraction(value)
    if isinstance(value, float):
        return Fraction(str(value))
    s = str(value).strip()
    if not s:
        return Fraction(0)
    for suffix, mult in _BINARY_SUFFIXES.items():
        if s.endswith(suffix):
            return Fraction(s[: -len(suffix)]) * mult
    if s[-1] in _DECIMAL_SUFFIXES and not s[-1].isdigit():
        return Fraction(s[:-1]) * _DECIMAL_SUFFIXES[s[-1]]
    # Scientific notation ("1e3") and plain decimals both land here.
    if "e" in s or "E" in s:
        mantissa, _, exp = s.partition("e" if "e" in s else "E")
        return Fraction(mantissa) * Fraction(10) ** int(exp)
    return Fraction(s)


# Quantity inputs are immutable scalars (str/int/float) drawn from a
# small vocabulary in practice ("250m", "1Gi", ... repeated across every
# pod of a template), and Fraction arithmetic is the single hottest part
# of feeding 50k pods into the cache — cache the exact results.
@functools.lru_cache(maxsize=4096)
def parse_quantity(value) -> float:
    """Parse a k8s quantity to a float base value."""
    return float(_parse_exact(value))


@functools.lru_cache(maxsize=4096)
def milli_value(value) -> float:
    """Quantity → milli units, rounded up (resource.Quantity.MilliValue)."""
    return float(math.ceil(_parse_exact(value) * 1000))


@functools.lru_cache(maxsize=4096)
def int_value(value) -> float:
    """Quantity → integer base value, rounded up (resource.Quantity.Value)."""
    return float(math.ceil(_parse_exact(value)))

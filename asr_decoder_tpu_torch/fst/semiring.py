"""Semirings: tropical float weight and the (graph, acoustic) lattice weight.

Capability parity with the reference's ``FloatWeightTpl`` /
``LatticeWeightTpl`` (ref: src/newfst/weigth.h:32-358).  Implemented both as a
tiny value class for host lattice code and as vectorized numpy helpers used by
the array-based algorithms.

LatticeWeight semantics (ref: weigth.h:293-346):
  * Zero = (+inf, +inf), One = (0, 0)
  * Plus picks the member with smaller total cost, tie-broken by smaller
    value1 (graph cost)
  * Times adds componentwise; Divide subtracts, mapping invalid results to Zero.
"""

from __future__ import annotations

import math
from typing import NamedTuple

INF = float("inf")
KDELTA = 1.0 / 1024.0


class LatticeWeight(NamedTuple):
    value1: float = 0.0   # graph (lm) cost
    value2: float = 0.0   # acoustic cost

    @property
    def value(self) -> float:
        return self.value1 + self.value2

    @staticmethod
    def zero() -> "LatticeWeight":
        return LatticeWeight(INF, INF)

    @staticmethod
    def one() -> "LatticeWeight":
        return LatticeWeight(0.0, 0.0)

    def is_zero(self) -> bool:
        return math.isinf(self.value1) and math.isinf(self.value2)


def compare(w1: LatticeWeight, w2: LatticeWeight) -> int:
    """-1 if w1 < w2 in the semiring order (bigger = lower cost = better);
    ref: LatticeWeightCompare (weigth.h:296-310)."""
    f1, f2 = w1.value, w2.value
    if f1 < f2:
        return 1
    if f1 > f2:
        return -1
    if w1.value1 < w2.value1:
        return 1
    if w1.value1 > w2.value1:
        return -1
    return 0


def plus(w1: LatticeWeight, w2: LatticeWeight) -> LatticeWeight:
    return w1 if compare(w1, w2) >= 0 else w2


def times(w1: LatticeWeight, w2: LatticeWeight) -> LatticeWeight:
    return LatticeWeight(w1.value1 + w2.value1, w1.value2 + w2.value2)


def divide(w1: LatticeWeight, w2: LatticeWeight) -> LatticeWeight:
    a = w1.value1 - w2.value1
    b = w1.value2 - w2.value2
    if (a != a or b != b or a == -INF or b == -INF
            or a == INF or b == INF):
        return LatticeWeight.zero()
    return LatticeWeight(a, b)


def approx_equal(w1: LatticeWeight, w2: LatticeWeight,
                 delta: float = KDELTA) -> bool:
    if w1 == w2:
        return True
    return abs(w1.value - w2.value) <= delta

"""Deferred fraction for batched inversion (util/arithmetic.rs:164-242).

Holds numerator/denominator; callers collect `denom_mut()`s, batch-invert
them in one shot via the loader, then `evaluate()` caches numer * denom^-1.
"""

from __future__ import annotations

from typing import Optional


class Fraction:
    __slots__ = ("numer", "denom", "eval", "inv")

    def __init__(self, numer, denom):
        self.numer = numer
        self.denom = denom
        self.eval = None
        self.inv = False

    @staticmethod
    def one_over(denom) -> "Fraction":
        return Fraction(None, denom)

    def denom_value(self) -> Optional[object]:
        return None if self.inv else self.denom

    def mark_inverted(self):
        """Record that the denominator slot now holds its inverse."""
        self.inv = True

    def set_denom(self, value):
        self.denom = value

    def evaluate(self):
        assert self.inv, "denominator not inverted yet"
        if self.eval is None:
            self.eval = self.denom if self.numer is None else self.numer * self.denom
        return self.eval

    def evaluated(self):
        assert self.eval is not None, "evaluate() not called"
        return self.eval


def batch_invert_fractions(loader, fractions):
    """Invert all un-inverted denominators with one loader batch inversion."""
    pending = [f for f in fractions if not f.inv]
    if not pending:
        return
    inverted = loader.batch_invert([f.denom for f in pending])
    for f, inv in zip(pending, inverted):
        f.set_denom(inv)
        f.mark_inverted()

"""Core definitions: dtype vocabulary + numeric tuple algebra.

The single home of the scalar-dtype vocabulary every layer shares
(reference: src/gt4py/_core/definitions.py:146-453 -- the reference
machine-enforces that cartesian and next both sit on _core, tach.toml),
plus the TPU-native re-design of the reference's ``Extent``/``Boundary``
concepts (reference: src/gt4py/cartesian/gtc/definitions.py:18-629).
An ``Extent`` records, per axis, the (lo, hi) offsets by which a
computation or field access region extends beyond the compute domain;
``lo <= 0 <= hi`` after union with the zero extent.  Boundaries (halo
widths) are the non-negative mirror ``(-lo, hi)``.

This module imports nothing from the rest of the package (the layering
test enforces it): higher layers (cartesian, next, storage, parallel)
import the vocabulary from here, never from each other.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

# --------------------------------------------------------------------------- #
# dtype vocabulary (shared by cartesian/ and storage/)
# --------------------------------------------------------------------------- #

#: bfloat16 (float32's exponent, 8 significant bits).  numpy has no such
#: dtype without ml_dtypes, which the port does not need, so the token is
#: a named 2-byte structured dtype: its ``kind`` is ``'V'``, as
#: ml_dtypes.bfloat16's, every layer compares against this one object,
#: and ``core.dtypes`` maps it to ``torch.bfloat16``.  Float-ness must be
#: tested with :func:`is_float_dtype`, not ``kind``.
BFLOAT16 = np.dtype([("bfloat16", "<u2")])

#: 16-bit float dtypes that are storage formats only: statements compute
#: in float32 (``passes.widen_f16_compute``).
F16_DTYPES = frozenset({BFLOAT16, np.dtype(np.float16)})


def is_float_dtype(dt) -> bool:
    """True for IEEE floats AND bfloat16 (whose numpy kind is 'V')."""
    dt = np.dtype(dt)
    return dt.kind == "f" or dt == BFLOAT16


#: C-style promotion ranks: all integer ranks sit below every float;
#: float16 and bfloat16 share a rank (neither holds the other).
PROMOTION_RANK = {
    np.dtype(np.bool_): 0,
    np.dtype(np.int8): 1,
    np.dtype(np.int16): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.int64): 4,
    np.dtype(np.uint8): 1,
    np.dtype(np.uint16): 2,
    np.dtype(np.uint32): 3,
    np.dtype(np.uint64): 4,
    np.dtype(np.float16): 5,
    BFLOAT16: 5,
    np.dtype(np.float32): 6,
    np.dtype(np.float64): 7,
}


def promote_dtypes(*dtypes) -> np.dtype:
    """C-style promotion: highest rank wins; all integer ranks < float32.

    This reproduces the reference's ufunc-signature upcasting for the types
    GTScript supports (gtc/passes/gtir_upcaster._numpy_ufunc_upcasting_rule).
    """
    best = dtypes[0]
    for dt in dtypes[1:]:
        ra = PROMOTION_RANK.get(np.dtype(dt))
        rb = PROMOTION_RANK.get(np.dtype(best))
        if ra is None or rb is None:
            # Unknown dtype: defer to numpy's lattice rather than letting
            # an unrecognized dtype silently win every promotion.
            try:
                best = np.promote_types(np.dtype(dt), np.dtype(best))
            except TypeError as ex:
                raise TypeError(
                    f"cannot promote {np.dtype(dt)} with {np.dtype(best)}: "
                    "dtype outside the supported vocabulary"
                ) from ex
            continue
        if ra > rb:
            best = dt
        elif np.dtype(dt) != np.dtype(best) and ra == 5 and rb == 5:
            # float16 vs bfloat16: neither holds the other -- promote to
            # float32 (same rule as numpy/jax promotion lattices)
            best = np.dtype(np.float32)
    return np.dtype(best)


@dataclasses.dataclass(frozen=True)
class Extent:
    """Per-axis (lo, hi) growth of a region relative to the compute domain."""

    i: Tuple[int, int] = (0, 0)
    j: Tuple[int, int] = (0, 0)
    k: Tuple[int, int] = (0, 0)

    @classmethod
    def zeros(cls) -> "Extent":
        return cls()

    @classmethod
    def from_offset(cls, di: int = 0, dj: int = 0, dk: int = 0) -> "Extent":
        return cls(i=(di, di), j=(dj, dj), k=(dk, dk))

    def __or__(self, other: "Extent") -> "Extent":
        """Union (hull) of two extents."""
        return Extent(
            i=(min(self.i[0], other.i[0]), max(self.i[1], other.i[1])),
            j=(min(self.j[0], other.j[0]), max(self.j[1], other.j[1])),
            k=(min(self.k[0], other.k[0]), max(self.k[1], other.k[1])),
        )

    def __add__(self, other: "Extent") -> "Extent":
        """Compose extents (access at offset within an extended region)."""
        return Extent(
            i=(self.i[0] + other.i[0], self.i[1] + other.i[1]),
            j=(self.j[0] + other.j[0], self.j[1] + other.j[1]),
            k=(self.k[0] + other.k[0], self.k[1] + other.k[1]),
        )

    def union_zero(self) -> "Extent":
        return self | Extent.zeros()

    @property
    def horizontal(self) -> "Extent":
        return Extent(i=self.i, j=self.j)

    def to_boundary(self) -> "Boundary":
        e = self.union_zero()
        return Boundary(
            i=(-e.i[0], e.i[1]), j=(-e.j[0], e.j[1]), k=(-e.k[0], e.k[1])
        )

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return iter((self.i, self.j, self.k))


@dataclasses.dataclass(frozen=True)
class Boundary:
    """Non-negative halo widths per axis: (lower, upper)."""

    i: Tuple[int, int] = (0, 0)
    j: Tuple[int, int] = (0, 0)
    k: Tuple[int, int] = (0, 0)

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return iter((self.i, self.j, self.k))

    @property
    def lower_indices(self) -> Tuple[int, int, int]:
        return (self.i[0], self.j[0], self.k[0])

    @property
    def upper_indices(self) -> Tuple[int, int, int]:
        return (self.i[1], self.j[1], self.k[1])

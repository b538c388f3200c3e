"""Bounded, trim-stable event logs for fallback observability.

Both kernel paths (``cartesian.backend.pallas_backend.FALLBACK_EVENTS``
and ``next.pallas_bridge.FALLBACK_EVENTS``) record every silent
fall-back to the slower staged executor.  Long-running sweeps must not
grow the log unboundedly, but trimming from the head breaks the naive
``before = len(log); log[before:]`` diff idiom.  :class:`EventLog`
keeps a monotonic count of everything ever recorded so consumers can
diff reliably across trims::

    cur = log.cursor()
    ... run ...
    new_events = log.since(cur)

``len()`` / slicing still work (the log IS a list of the retained
tail); ``total`` is the monotonic all-time count.
"""

from __future__ import annotations

from typing import Any, List


class EventLog(list):
    """A list that drops its oldest half past ``maxlen`` while keeping a
    monotonic cursor so ``since(cursor)`` never misses or repeats events
    (unless more than ``maxlen`` events landed since the cursor, in which
    case the oldest of them were trimmed away -- the retained tail is
    still correct and ``dropped_since(cursor)`` reports the loss)."""

    def __init__(self, maxlen: int = 4096):
        super().__init__()
        self.maxlen = maxlen
        #: number of events trimmed off the head so far
        self.trimmed = 0

    @property
    def total(self) -> int:
        """All-time number of recorded events (monotonic)."""
        return self.trimmed + len(self)

    def record(self, event: Any) -> None:
        self.append(event)
        if len(self) > self.maxlen:
            drop = len(self) - self.maxlen // 2
            del self[:drop]
            self.trimmed += drop

    def cursor(self) -> int:
        """A monotonic position for later :meth:`since` diffs."""
        return self.total

    def since(self, cursor: int) -> List[Any]:
        """Events recorded after ``cursor``, robust to head trims."""
        return list(self[max(0, cursor - self.trimmed) :])

    def dropped_since(self, cursor: int) -> int:
        """How many post-``cursor`` events were already trimmed away."""
        return max(0, self.trimmed - max(cursor, 0))

    def clear(self) -> None:  # keep `total` monotonic across clears
        self.trimmed += len(self)
        del self[:]

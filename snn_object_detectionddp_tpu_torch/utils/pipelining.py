"""One-slot dispatch->fetch pipelining for device loops.

A loop that enqueues a step on the card and then reads its (tiny) results
back would stall the host on every iteration: the blocking copy sits
between step k and batch k+1's host preparation and upload. Keeping exactly
one result in flight and fetching it only after the next step has been
enqueued overlaps the two. ``push()`` drains the *previous* item,
``flush()`` drains the last one after the loop.
"""

from __future__ import annotations

from typing import Callable


class DelayedFetch:
    """Hold one in-flight item; drain it through ``fn`` on the next push.

    ``fn`` receives whatever was pushed (positionally). Results therefore
    arrive exactly one iteration late — callers displaying per-step values
    lag one step, by design.
    """

    def __init__(self, fn: Callable):
        self._fn = fn
        self._pending: tuple | None = None

    def push(self, *item) -> None:
        prev, self._pending = self._pending, item
        if prev is not None:
            self._fn(*prev)

    def flush(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._fn(*prev)

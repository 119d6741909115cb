"""Device time of named regions of a training step, forward and backward,
from CUDA events — no synchronisation inside the step.

A region is marked at its input and at its output with ``mark``, an
identity whose forward records an event and whose backward records one
too: going forward the input's mark opens the region and the output's
closes it; going backward the output's mark opens it (the gradient
arrives there first) and the input's closes it. A layer recomputed in
the backward pass (``torch.utils.checkpoint``) records its forward marks
again, nested inside whatever region the backward pass has open.

Every event lands in one list in the order the host enqueued it, and
all of them are on the one stream the step runs on, so the device time
between two consecutive events belongs to the innermost region open
between them. ``RegionTimer.seconds`` walks the list once the step has
synchronised (its loss read back) and sums each region's share.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

OPEN, CLOSE = 1, -1


class RegionTimer:
    """Events of one step; ``make_event`` is the event factory (CUDA
    events on a card; tests pass their own)."""

    def __init__(self, make_event: Optional[Callable] = None):
        self._make = make_event or (
            lambda: torch.cuda.Event(enable_timing=True))
        self.events: List[tuple] = []

    def record(self, region: str, edge: int) -> None:
        ev = self._make()
        ev.record()
        self.events.append((ev, region, edge))

    def seconds(self) -> Dict[str, float]:
        """Device seconds by region; call after the step's work has
        finished on the device."""
        out: Dict[str, float] = {}
        stack: List[str] = []
        prev = None
        for ev, region, edge in self.events:
            if prev is not None and stack:
                out[stack[-1]] = (out.get(stack[-1], 0.0)
                                  + prev.elapsed_time(ev) / 1e3)
            if edge == OPEN:
                stack.append(region)
            elif region in stack:
                # The innermost open instance of the region closes.
                del stack[len(stack) - 1 - stack[::-1].index(region)]
            prev = ev
        return out


class _Mark(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, timer, region, edge):
        timer.record(region, edge)
        ctx.mark = (timer, region, edge)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        timer, region, edge = ctx.mark
        # Backward runs the region from its output to its input.
        timer.record(region, -edge)
        return g, None, None, None


def mark(x: torch.Tensor, timer: Optional[RegionTimer], region: str,
         edge: int) -> torch.Tensor:
    """``x`` itself; with a timer, an event at this edge of ``region``
    going forward and at the opposite edge going backward."""
    return x if timer is None else _Mark.apply(x, timer, region, edge)

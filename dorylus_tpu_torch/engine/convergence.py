"""(The port's own copy of dorylus_tpu/engine/convergence.py, pinned to
the original by tests/test_torch_port_copies.py.)

Converge state machine: EARLY -> CLOSE -> DONE.

Port of the weight-server master's tryEarlyStop
(src/weight-server/weightserver.cpp:270-294): while validation accuracy is
below switch_threshold * targetAcc the system runs in its EARLY state (async
pipeline allowed, chunks up to `staleness` epochs ahead); once accuracy
crosses that threshold it upgrades to CLOSE, which switches the pipeline to
synchronous execution for the final approach (the reference broadcasts the
new CONVERGE_STATE with OP::TERM to every graph server, pipeline.cpp:53-92
reacts by draining the async queues); at targetAcc it upgrades to DONE and
training stops.

Here the async pipeline is the bounded-staleness gradient window, so the
EARLY->CLOSE transition collapses the window to synchronous (staleness 0)
and DONE breaks the epoch loop. States never downgrade, exactly like the
reference (`max(convergeState, ...)` semantics).
"""

from __future__ import annotations

import enum
from typing import Optional


class ConvergeState(enum.IntEnum):
    EARLY = 0
    CLOSE = 1
    DONE = 2


class ConvergeMonitor:
    """Tracks the converge state across epochs.

    target_acc None OR 0 disables the machine entirely (state stays
    EARLY and training runs the full epoch budget), matching the
    reference's targetAcc=0 default where tryEarlyStop never upgrades —
    a user porting `--t 0` from run-onnode must not get an instant stop
    at the first eval (round-5 review).
    """

    def __init__(self, target_acc: Optional[float],
                 switch_threshold: float = 0.9):
        self.target_acc = target_acc
        self.switch_threshold = switch_threshold
        self.state = ConvergeState.EARLY

    def update(self, accuracy: Optional[float]) -> ConvergeState:
        """Feed a validation accuracy (None = no eval this epoch); returns
        the (possibly upgraded) state. Monotone non-decreasing."""
        if not self.target_acc or accuracy is None:  # None or 0 = off
            return self.state
        if accuracy >= self.target_acc:
            self.state = ConvergeState.DONE
        elif accuracy >= self.switch_threshold * self.target_acc:
            self.state = max(self.state, ConvergeState.CLOSE)
        return self.state

    @property
    def synchronous(self) -> bool:
        """True once the async (stale-gradient) window must be closed."""
        return self.state >= ConvergeState.CLOSE

    @property
    def done(self) -> bool:
        return self.state >= ConvergeState.DONE

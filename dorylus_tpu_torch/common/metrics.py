"""Per-stage timing + per-epoch metrics reporting.

Reproduces the reference's observability surface: per-stage accumulators
(vecTimeAggregate/ApplyVtx/Scatter/ApplyEdg, engine.hpp:217-224), per-epoch
wall times logged by the scheduler (pipeline.cpp:41-47), and the final
report written to output_<node> (engine/utils.cpp:109-212).

The port's own copy of dorylus_tpu/common/metrics.py.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class StageTimer:
    """Accumulates wall-time per named stage, like the reference's
    vecTime* arrays sized 2*numLayers (engine/engine.cpp:75-82)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._open.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "avg_ms": 1e3 * self.totals[k] / max(1, self.counts[k])}
            for k in sorted(self.totals)
        }


@dataclass
class EpochRecord:
    epoch: int
    time_ms: float
    loss: Optional[float] = None
    accuracy: Optional[float] = None


@dataclass
class RunReport:
    """Final run report, the analog of output_<node>
    (engine/utils.cpp:139-291 printEngineMetrics)."""

    epochs: List[EpochRecord] = field(default_factory=list)
    stage_times: Dict[str, Dict[str, float]] = field(default_factory=dict)
    final_accuracy: Optional[float] = None
    test_accuracy: Optional[float] = None
    total_time_s: float = 0.0
    notes: Dict[str, object] = field(default_factory=dict)

    def add_epoch(self, rec: EpochRecord) -> None:
        self.epochs.append(rec)

    @property
    def avg_epoch_ms(self) -> float:
        # Skip the whole FIRST COMPILED GROUP, not just epoch 0: engines
        # smear a group's wall time (compile included) across all k of
        # its records as identical time_ms values, so dropping one
        # record still left k-1 compile-inflated entries in the average
        # (round-5 review). The leading run of equal time_ms IS the
        # first group; keep everything after it, falling back to the
        # old behavior when that would drop every record.
        if not self.epochs:
            return 0.0
        t0 = self.epochs[0].time_ms
        i = 0
        while i < len(self.epochs) and self.epochs[i].time_ms == t0:
            i += 1
        timed = self.epochs[i:]
        if not timed:
            timed = (self.epochs[1:] if len(self.epochs) > 1
                     else self.epochs)
        return sum(e.time_ms for e in timed) / len(timed)

    def to_json(self) -> str:
        return json.dumps(
            {
                "avg_epoch_ms": self.avg_epoch_ms,
                "final_accuracy": self.final_accuracy,
                "test_accuracy": self.test_accuracy,
                "total_time_s": self.total_time_s,
                "stage_times": self.stage_times,
                "epochs": [vars(e) for e in self.epochs],
                "notes": self.notes,
            },
            indent=2,
        )

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def summary(self) -> str:
        min_ms = min((e.time_ms for e in self.epochs), default=0.0)
        lines = [
            f"epochs run        : {len(self.epochs)}",
            f"avg epoch time    : {self.avg_epoch_ms:.2f} ms",
            # The first epoch group includes compilation; min is the
            # closest single-run proxy for the warm epoch time.
            f"min epoch time    : {min_ms:.2f} ms",
            f"final val accuracy: {self.final_accuracy}",
            f"test accuracy     : {self.test_accuracy}",
            f"total time        : {self.total_time_s:.2f} s",
        ]
        for k, v in sorted(self.stage_times.items()):
            lines.append(f"stage {k:<18}: {v['avg_ms']:.3f} ms avg x{v['count']}")
        return "\n".join(lines)

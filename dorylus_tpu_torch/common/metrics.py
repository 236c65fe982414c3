"""The run report, per-epoch records, and the port's one recorder of
spans, counters and gauges.

The report reproduces the reference's observability surface: per-epoch
wall times logged by the scheduler (pipeline.cpp:41-47) and the final
report written to output_<node> (engine/utils.cpp:109-212); `RunReport` is
the port's own copy of dorylus_tpu/common/metrics.py's.

The recorder times the host's stages from inside the program.
`span(name, **attrs)` is a context manager: each span keeps its name, its
attributes (the body may add more through the record it yields), the name
of the span that encloses it in the same thread (its parent), and its start
and end on `time.perf_counter`. The recorder keeps, per name, the count,
the total seconds and the self seconds (the duration less what child spans
cover), and the last RECENT_SPANS spans, so that a process that trains for
days does not grow. `count(name, n)` adds to a counter, `gauge(name,
value)` keeps a last value. While a `torch.profiler` session records, each
span also enters `torch.profiler.record_function(name)`, which puts it into
the device trace on the trace's own clock; the check is one flag read, and
without a session a span costs two clock reads and a dict update.

Spans are coarse by rule: one per host stage, per `run()`, per group of
epochs and per capture; none per epoch, per kernel launch or inside a
captured body. `spans()`, `recent()`, `counters()`, `gauges()` and
`reset()` read and clear the process's record (`RECORDER`), and
`RunReport.write` adds it to the report file. `set_enabled(False)` turns
the record and the annotations off in the process; a span still reads the
clock twice, so its `seconds` stays true for the code that reads it. It
exists to measure what the recorder costs.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

# the spans `recent()` keeps, newest last
RECENT_SPANS = 4096


class SpanRecord:
    """One span, and the context manager that times it: `name`, `attrs`,
    `parent` (the enclosing span's name, None at the top and while the
    recorder is off), `start` and `end` (perf_counter seconds) and
    `child_s` (the seconds its child spans covered)."""

    __slots__ = ("name", "attrs", "parent", "start", "end", "child_s", "_recorder",
                 "_annotation", "_recorded")

    def __init__(self, recorder: "Recorder", name: str, attrs: dict):
        self.name, self.attrs, self._recorder = name, attrs, recorder
        self.parent = self.start = self.end = self._annotation = None
        self.child_s = 0.0
        self._recorded = False

    @property
    def seconds(self) -> float:
        """The span's duration, once it has closed."""
        return 0.0 if self.start is None or self.end is None else self.end - self.start

    def __enter__(self) -> "SpanRecord":
        return self._recorder._open(self)

    def __exit__(self, *exc) -> bool:
        self._recorder._close(self)
        return False


class Recorder:
    """Spans, counters and gauges of one process (module docstring)."""

    def __init__(self, recent: int = RECENT_SPANS):
        self.enabled = True
        self._lock = threading.Lock()
        self._local = threading.local()  # each thread's open spans
        self._agg: Dict[str, list] = {}  # name -> [count, total_s, self_s]
        self._recent: deque = deque(maxlen=recent)
        self._counts: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}

    def span(self, name: str, **attrs) -> SpanRecord:
        return SpanRecord(self, name, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, rec: SpanRecord) -> SpanRecord:
        if not self.enabled:
            rec.start = time.perf_counter()
            return rec
        rec._recorded = True
        stack = self._stack()
        rec.parent = stack[-1].name if stack else None
        stack.append(rec)
        if _profiler._is_profiler_enabled:
            rec._annotation = _profiler.record_function(rec.name)
            rec._annotation.__enter__()
        rec.start = time.perf_counter()
        return rec

    def _close(self, rec: SpanRecord) -> None:
        rec.end = time.perf_counter()
        if not rec._recorded:
            return
        if rec._annotation is not None:
            rec._annotation.__exit__(None, None, None)
            rec._annotation = None
        stack = self._stack()
        stack.pop()  # rec: `with` closes a thread's spans in the order they opened
        d = rec.end - rec.start
        if stack:
            stack[-1].child_s += d
        with self._lock:
            agg = self._agg.get(rec.name)
            if agg is None:
                self._agg[rec.name] = [1, d, d - rec.child_s]
            else:
                agg[0] += 1
                agg[1] += d
                agg[2] += d - rec.child_s
            self._recent.append(rec)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        if self.enabled:
            self._gauges[name] = value

    def spans(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, total_s and self_s."""
        with self._lock:
            return {k: {"count": a[0], "total_s": a[1], "self_s": a[2]}
                    for k, a in sorted(self._agg.items())}

    def recent(self) -> List[dict]:
        """The last spans that closed, oldest first."""
        with self._lock:
            recs = list(self._recent)
        return [{"name": r.name, "parent": r.parent, "start": r.start, "end": r.end,
                 "attrs": dict(r.attrs)} for r in recs]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._counts.items()))

    def gauges(self) -> Dict[str, float]:
        return dict(sorted(self._gauges.items()))

    def reset(self) -> None:
        """Forget every span, counter and gauge recorded so far (spans open
        now still record when they close)."""
        with self._lock:
            self._agg.clear()
            self._recent.clear()
            self._counts.clear()
            self._gauges.clear()

    def set_enabled(self, on: bool) -> bool:
        """Turn the recorder on or off; returns whether it was on."""
        was, self.enabled = self.enabled, bool(on)
        return was


# The process's recorder, which the program's spans, counters and gauges use.
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
gauge = RECORDER.gauge
spans = RECORDER.spans
recent = RECORDER.recent
counters = RECORDER.counters
gauges = RECORDER.gauges
reset = RECORDER.reset
set_enabled = RECORDER.set_enabled


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

    def to_json(self, notes: Optional[dict] = None) -> str:
        return json.dumps(
            {
                "avg_epoch_ms": self.avg_epoch_ms,
                "final_accuracy": self.final_accuracy,
                "test_accuracy": self.test_accuracy,
                "total_time_s": self.total_time_s,
                "stage_times": self.stage_times,
                "epochs": [vars(e) for e in self.epochs],
                "notes": self.notes if notes is None else notes,
            },
            indent=2,
        )

    def write(self, path: str) -> None:
        """The report file: to_json's, its notes with the recorder's record
        added: "spans" (per name: count, total_s, self_s), "counters" and
        "gauges"."""
        notes = dict(self.notes, spans=spans(), counters=counters(), gauges=gauges())
        with open(path, "w") as f:
            f.write(self.to_json(notes))

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

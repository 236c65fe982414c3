"""What a cell is made of, found by name: `BENCHMARK.json` at the root of the
checkout names each cell's configuration and traffic; the configuration is
the file its entry names, the traffic `traffic/<name>.json`, the limits of
its output check `limits/<cell>.json`, and each metric `metrics/<name>.py`,
a module with `read(ctx) -> float | None`. A later cell, traffic mix or
metric is added by adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, repo: Path = REPO, here: Path = HERE):
        self.bench = json.loads((repo / "BENCHMARK.json").read_text())
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry, self.here = name, entry, here
        cfg = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        self.config = json.loads((repo / cfg["file"]).read_text())
        self.traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
        self.limits = json.loads((here / "limits" / f"{name}.json").read_text())["limits"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries this cell reports: its end-to-end metrics in
        an untraced run, its per-layer metrics in a traced one."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def metric_reader(self, name: str):
        path = self.here / "metrics" / f"{name}.py"
        module_name = "perfbench_metric_" + name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

"""The benchmark's import and layout guards: nothing it loads is JAX or the
JAX package (top-level names compared whole, so that dorylus_tpu_torch
passes), the reference loads nothing of the program, and a cell, its
configuration, traffic, limits and a new metric are found by name with no
existing file edited."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

from conftest import REPO, write_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "dorylus_tpu"}


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after `code`
    and did not hold before it."""
    probe = (f"import sys; sys.path.insert(0, {str(REPO)!r}); before = set(sys.modules)\n"
             f"{code}\n"
             "print(' '.join(sorted({m.split('.')[0] for m in set(sys.modules) - before})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, check=True, cwd=REPO)
    return set(out.stdout.split())


def test_benchmark_loads_no_jax():
    names = loaded_after(
        "import runpy, glob\n"
        "import perfbench.harness, perfbench.calibrate, perfbench.work\n"
        "runpy.run_path('perfbench/run.py', run_name='not_main')\n"
        "from perfbench.spec import Cell\n"
        "c = Cell('gcn-reddit.full')\n"
        "[c.metric_reader(m['name']) for m in c.metrics(False) + c.metrics(True)]")
    assert "dorylus_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import perfbench.reference.gnn")
    assert not names & (FORBIDDEN | {"dorylus_tpu_torch"}), names
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "import dorylus" not in text and "from dorylus" not in text, path
        assert "perfbench" not in text, path


def digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in [root / "BENCHMARK.json", *sorted((root / "perfbench").rglob("*"))]
            if p.is_file()}


def test_new_cell_and_metric_found_by_name(tmp_path):
    write_cell(tmp_path, "gcn")  # the copy, with one cell added
    before = digests(tmp_path)
    here = tmp_path / "perfbench"
    cfg = json.loads((here / "configs" / "gcn-reddit.json").read_text())
    (here / "configs" / "later.json").write_text(json.dumps(dict(cfg, name="later")))
    (here / "traffic" / "later.json").write_text(
        (here / "traffic" / "sparse.json").read_text())
    (here / "limits" / "later.sparse.json").write_text(
        (here / "limits" / "gcn-reddit.sparse.json").read_text())
    (here / "metrics" / "later_metric.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.trace is not None else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="later",
                                 file="perfbench/configs/later.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="later.sparse",
                                   config="later", traffic="later"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="later_metric",
                                   workloads=["later.sparse"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    from perfbench.spec import Cell

    cell = Cell("later.sparse", tmp_path, here)
    assert cell.config["name"] == "later" and cell.traffic["edges"] == 11_648_250
    assert cell.limits == json.loads(
        (REPO / "perfbench/limits/gcn-reddit.sparse.json").read_text())["limits"]
    names = [m["name"] for m in cell.metrics(True)]
    assert "later_metric" in names and "later_metric" not in [
        m["name"] for m in Cell("tiny.t", tmp_path, here).metrics(True)]

    class Ctx:
        trace = object()

    assert cell.metric_reader("later_metric")(Ctx()) == 42.0
    after = digests(tmp_path)
    assert all(after[p] == d for p, d in before.items() if p.name != "BENCHMARK.json")

"""Find configurations, cells and metrics by the names in BENCHMARK.json.

    BENCHMARK.json                       the cells, the metrics, the bounds
    ecbench/configs/<config>.json        a deployment (the `file` named in
                                         BENCHMARK.json's `configs`)
    ecbench/workloads/<cell>.json        a cell's traffic parameters; its
                                         "op" names the generator
    ecbench/ops/<op>.py                  an op: it makes the volumes, drives
                                         one round of one stream and checks
                                         the rounds (a class `Traffic`)
    ecbench/metrics/<metric>.py          a metric's reader; a name with a
                                         dot (`copy_busy_share.encode`)
                                         falls back to the reader of the
                                         part before it (`copy_busy_share`)

A configuration may name its plain reference (`"reference"`, a file of
the benchmark; ecbench/reference.py where it names none) and its code
(`"code"`, a name of the program's geometry registry; plain RS(k, m)
where it names none). A reader module defines `read(readings, variant) -> float | None`; the
variant is the part of the name after the first dot ("" without one).
None means that the run has nothing for that metric to read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int


class Registry:
    def __init__(self, benchmark: Path | None = None,
                 root: Path | None = None):
        self.root = Path(root) if root is not None else HERE
        self.benchmark_path = (Path(benchmark) if benchmark is not None
                               else self.root.parent / "BENCHMARK.json")
        with open(self.benchmark_path) as f:
            self.bench = json.load(f)
        self._readers: dict[str, object] = {}
        self._modules: dict[tuple[str, str], object] = {}

    # -- cells -------------------------------------------------------------

    def cell_names(self) -> list[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in {self.benchmark_path}")
        conf = next((c for c in self.bench["configs"]
                     if c["name"] == entry["config"]), None)
        if conf is None:
            raise KeyError(f"workload {name!r} names config "
                           f"{entry['config']!r}, which is not listed")
        config = self._json(self.benchmark_path.parent / conf["file"])
        traffic = self._json(self._find("workloads", f"{name}.json"))
        if traffic.get("traffic") != entry["traffic"]:
            raise ValueError(f"workloads/{name}.json is traffic "
                             f"{traffic.get('traffic')!r}, BENCHMARK.json "
                             f"says {entry['traffic']!r}")
        return Cell(name, config, traffic, int(entry["chips"]))

    def _find(self, folder: str, file: str) -> Path:
        """`folder/file` under this registry's root, else under this
        package's own folder (a test's root adds to the package's)."""
        for root in (self.root, HERE):
            path = root / folder / file
            if path.exists():
                return path
        raise FileNotFoundError(f"no {folder}/{file} under {self.root}")

    @staticmethod
    def _json(path: Path) -> dict:
        with open(path) as f:
            return json.load(f)

    # -- metrics -----------------------------------------------------------

    def metrics_for(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics
        without trace, its per-layer metrics with it."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def reader(self, metric: str):
        """The `read` function of `metric`'s reader module."""
        got = self._readers.get(metric)
        if got is None:
            stem = metric if self._has("metrics", metric) else \
                metric.split(".", 1)[0]
            got = self._readers[metric] = self._load("metrics", stem).read
        return got

    def op(self, name: str):
        """The module of the op `name` (ecbench/ops/<name>.py)."""
        return self._load("ops", name)

    def module(self, path: str):
        """A module of the benchmark by its path from the checkout's root
        (`ecbench/reference.py`), found as `_find` finds files."""
        parts = Path(path).parts
        if not parts or parts[0] != "ecbench":
            raise ValueError(f"{path!r} is not a file of the benchmark")
        return self._load(str(Path(*parts[1:-1])), Path(parts[-1]).stem)

    def _has(self, folder: str, stem: str) -> bool:
        return any((root / folder / f"{stem}.py").exists()
                   for root in (self.root, HERE))

    def _load(self, folder: str, stem: str):
        key = (folder, stem)
        if key not in self._modules:
            path = self._find(folder, f"{stem}.py")
            name = "ecbench_" + "_".join(
                (*Path(folder).parts, stem)).replace(".", "_")
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod  # dataclasses look their module up
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def workdir(self, cell: str) -> Path:
        """Where a run of `cell` keeps its volumes: a fixed path inside
        the checkout, emptied at the start and the end of every run."""
        return self.root / "_run" / cell

"""Finding a cell's pieces by name.

`BENCHMARK.json` names each cell's configuration and traffic; the files
are found from those names, so a cell, a configuration, a mix or a metric
is added by adding files and entries, never by editing a file:

* `bench/configs/<config>.json`  - the configuration as it is run;
* `bench/traffic/<traffic>.json` - the mix's parameters;
* `bench/limits/<workload>.json` - the limits `correct` is judged by;
* `bench/end_to_end/<metric>.py`, `bench/metrics/<metric>.py` - one
  reader a metric, ``read(run) -> float | None``;
* `bench/reference/<name>.py`    - the plain reference a configuration
  names.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    root: Path
    benchmark: dict
    workload: dict
    config_entry: dict
    config: dict                  # bench/configs/<config>.json
    mix: dict                     # bench/traffic/<traffic>.json
    limits: dict                  # bench/limits/<workload>.json

    @property
    def name(self) -> str:
        return self.workload["name"]

    def _applies(self, metric: dict, moved: List[str]) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves") in moved if moved else True

    def end_to_end(self) -> List[dict]:
        return [m for m in self.benchmark["end_to_end"]
                if self._applies(m, [])]

    def per_layer(self) -> List[dict]:
        moved = [m["name"] for m in self.end_to_end()]
        return [m for m in self.benchmark["per_layer"]
                if self._applies(m, moved)]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer() if trace else self.end_to_end()

    def reader(self, metric: dict, trace: bool) -> ModuleType:
        folder = "metrics" if trace else "end_to_end"
        path = self.root / "bench" / folder / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_{metric['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reference(self) -> ModuleType:
        return importlib.import_module(
            f"bench.reference.{self.config['reference']}")


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(by_name)})")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(root=root, benchmark=bench, workload=w, config_entry=entry,
                config=load_json(root / entry["file"]),
                mix=load_json(root / "bench" / "traffic" /
                              f"{w['traffic']}.json"),
                limits=load_json(root / "bench" / "limits" /
                                 f"{workload}.json"))


def port_config(config: dict):
    """The port's `Config` of a configuration file: the port's registered
    architecture with every field the file states."""
    from repro_torch import configs
    fields: Dict = dict(config["model"])
    if "pattern" in fields:
        fields["pattern"] = tuple(tuple(k) for k in fields["pattern"])
    return configs.get(config["arch"], **fields)

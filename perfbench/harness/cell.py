"""A cell and everything it names, found by name under ``perfbench/``:

- ``BENCHMARK.json`` at the checkout's root: the cell's entry, its
  end-to-end and per-layer metrics;
- ``workloads/<cell>.json``: the configuration, chips and traffic the entry
  names, the traffic driver (``driver``), the mix's parameters
  (``params``) and the limits of the comparison with the reference
  (``limits``);
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<driver>.py``: the driver, with ``run(run)`` and
  ``check(run)``;
- ``metrics/<metric>.py``, else ``metrics/<stem>.py`` for a metric named
  ``<stem>.<part>``: the per-layer metric's reader, ``read(run, name)``.

A cell, a configuration or a per-layer metric is added by adding files
and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return load_json(path)


def metrics_of(bench: Dict, cell: str) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports: those
    whose ``workloads`` list it, or that have none; a per-layer metric
    without ``workloads`` goes with the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def load(name: str, root: Path = ROOT, perfbench: Path = PERFBENCH) -> Dict:
    """-> {"name", "entry", "cell", "config", "metrics"} of cell ``name``."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cell = load_json(perfbench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}="
                             f"{cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = load_json(perfbench / "configs" / f"{entry['config']}.json")
    return dict(name=name, entry=entry, cell=cell, config=config,
                metrics=metrics_of(bench, name))


def driver(kind: str):
    return importlib.import_module(f"perfbench.traffic.{kind}")


def reader(metric: str, perfbench: Path = PERFBENCH):
    """The ``read(run, name)`` function of ``metric``'s reader file."""
    for stem in (metric, metric.split(".")[0]):
        path = perfbench / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{perfbench / 'metrics'}")

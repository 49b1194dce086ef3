"""A cell of ``BENCHMARK.json``, resolved by name into its files.

Everything that belongs to one configuration, one traffic mix, one
cell's limits or one metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- the configuration: the ``file`` its entry names;
- the traffic mix: ``portbench/traffic/<traffic>.json``, read by the
  driver its ``driver`` key names: a general one of
  :mod:`portbench.harness.drivers`, or a ``Driver`` class of its own in
  ``portbench/drivers/<driver>.py``, loaded by its file;
- the limits of the check that decides ``correct``:
  ``portbench/limits/<workload>.json``;
- each metric: a reader ``portbench/metrics/<name>.py`` whose
  ``read(ctx)`` returns the number, or None where it finds nothing to
  read.

A later cell, metric or driver is new files and new entries, with no
existing file edited.
"""

from __future__ import annotations

import importlib.util
import json
import os

PB_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB_DIR)


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_reader(name: str, pb_dir: str = PB_DIR):
    """The metric reader ``metrics/<name>.py``, loaded by its file."""
    path = os.path.join(pb_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: str = ROOT) -> dict:
    """{"workload", "chips", "config", "traffic", "limits",
    "end_to_end", "per_layer", "pb_dir"} of the named cell, its files
    loaded; raises KeyError for an unknown name."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    pb_dir = os.path.join(root, "portbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    cfg = _load_json(os.path.join(root, entry["file"]))
    traffic = _load_json(os.path.join(pb_dir, "traffic",
                                      f"{cell['traffic']}.json"))
    limits = _load_json(os.path.join(pb_dir, "limits", f"{workload}.json"))
    return {
        "workload": workload,
        "chips": int(cell["chips"]),
        "config": cfg,
        "traffic": traffic,
        "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"]
                       if _applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"]
                      if _applies(m, workload)],
        "pb_dir": pb_dir,
    }

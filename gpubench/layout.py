"""Where the benchmark keeps each piece, found by the names in
``BENCHMARK.json``:

* ``configs/<config>.json``: a configuration's sizes, source and scene;
* ``reference/<config>.py``: its plain float32 reference;
* ``counts/<config>.py``: its frozen operation and byte counts;
* ``traffic/<mix>.json``: a traffic mix's parameters, read by the
  generator of its ``kind`` (:mod:`gpubench.serve`, :mod:`gpubench.train`);
* ``limits/<cell>.json``: the limits of a cell's ``correct``;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

Files are loaded by path, so a name may hold ``-`` and ``.``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: Dict = None) -> Dict:
    """The workload entry ``name`` with its config, traffic and limits
    read in: keys ``cell``, ``config``, ``traffic``, ``limits``."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError("no workload {!r} in BENCHMARK.json".format(name))
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return {"cell": w,
            "config": _json(ROOT / cfg_entry["file"]),
            "traffic": _json(HERE / "traffic" / (w["traffic"] + ".json")),
            "limits": _json(HERE / "limits" / (name + ".json"))}


def module(kind: str, name: str) -> ModuleType:
    """``gpubench/<kind>/<name>.py`` as a module (kinds: reference,
    counts, metrics)."""
    path = HERE / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_{}_{}".format(kind, name.replace("-", "_")
                                .replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(name: str, trace: bool, bench: Dict = None):
    """The metric entries a cell reports: its end-to-end metrics with
    ``trace`` 0, its per-layer metrics with ``trace`` 1 (an entry without
    ``workloads`` belongs to every cell)."""
    bench = bench if bench is not None else benchmark()
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or name in m["workloads"]]

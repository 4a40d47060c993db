"""Finds the benchmark's parts by the names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json``, a cell ``workloads/<name>.json``,
a traffic mix ``traffic/<name>.json`` (whose ``kind`` names the generator,
``traffic/<kind>.py``), a configuration's proof system
``systems/<system>.py``, and a metric's reader ``metrics/<name>.py`` or,
where a quantity is split by the end-to-end metric it moves
(``device.idle_share.batch``, ``device.idle_share.stream``), the reader of
the name without its last part (``metrics/device.idle_share.py``).  Adding
any of them adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path.relative_to(REPO_DIR)})")
    return path


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` as a dict."""
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots, so the file is
    loaded by its path, under the module name ``benchmark.<kind>.<name>``)."""
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, _path(kind, name, ".py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the one of
    ``name`` without its last dotted part."""
    try:
        return load_module("metrics", name)
    except FileNotFoundError:
        if "." not in name:
            raise
        return load_module("metrics", name.rsplit(".", 1)[0])


def benchmark_spec() -> dict:
    return json.loads((REPO_DIR / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` merged with its workload file,
    its traffic mix and its configuration file (the file named by the
    configuration's ``file``)."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = load_json("workloads", name)
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {workload[key]!r} != BENCHMARK.json's {entry[key]!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((REPO_DIR / conf["file"]).read_text())
    return {**workload, "name": name, "mix": load_json("traffic", entry["traffic"]), "config_data": config}


def cell_metrics(spec: dict, name: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics that ``name`` reports: a metric
    with a ``workloads`` list names its cells; a per-layer metric without
    one goes with every cell that reports the end-to-end metric it moves."""
    def listed(metric):
        return name in metric["workloads"] if "workloads" in metric else None

    e2e = [m for m in spec["end_to_end"] if listed(m) is not False]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if listed(m) or (listed(m) is None and m["moves"] in names)]
    return e2e, layer

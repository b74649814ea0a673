"""What one run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), the
stages (``stages/*.json``) and the metric readers (``metrics/<metric>.py``).
Adding any of them adds a file; no code here names one."""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    root: str            # the checkout whose benchmark files it was read from
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    here = os.path.join(root, "benchmark")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(
        root=root, name=name, chips=int(w["chips"]),
        config=_load_json(os.path.join(here, "configs",
                                       f"{w['config']}.json")),
        traffic=_load_json(os.path.join(here, "traffic",
                                        f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(here, "limits", f"{name}.json")),
        end_to_end=e2e, per_layer=per_layer)


def metric_module(name: str, root: str = ROOT):
    """The reader ``benchmark/metrics/<name>.py`` (names hold dots, so it is
    loaded from its path)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stages(root: str = ROOT) -> list[dict]:
    """Every stage file: {"name", "module", "attr"}, in name order."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "benchmark", "stages",
                                              "*.json"))):
        st = _load_json(path)
        st["name"] = os.path.basename(path)[:-len(".json")]
        out.append(st)
    return out

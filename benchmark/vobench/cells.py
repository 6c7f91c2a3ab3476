"""Everything a cell needs, found by name: BENCHMARK.json names the cells,
configurations and metrics; a configuration's file is the one its entry
names, a traffic mix is traffic/<traffic>.json, its driver
drivers/<driver>.py, a per-layer metric metrics/<metric>.py, a kernel's
roofline count roofline/<kernel>.py and a cell's correctness limits
limits/<cell>.json. A later cell or metric is a new file and a new entry;
no file here changes."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the benchmark's folder
REPO = os.path.dirname(HERE)  # the checkout's root


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(repo: str = REPO) -> dict:
    return load_json(os.path.join(repo, "BENCHMARK.json"))


def _one(entries: list[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def workload(bench: dict, name: str) -> dict:
    return _one(bench["workloads"], name, "workload")


def config(bench: dict, name: str, repo: str = REPO) -> dict:
    return load_json(os.path.join(repo, _one(bench["configs"], name, "config")["file"]))


def traffic(name: str, root: str = HERE) -> dict:
    return load_json(os.path.join(root, "traffic", f"{name}.json"))


def limits(cell: str, root: str = HERE) -> dict:
    return load_json(os.path.join(root, "limits", f"{cell}.json"))


@functools.lru_cache(maxsize=None)
def module(kind: str, name: str, root: str = HERE):
    """benchmark/<kind>/<name>.py as a module (a name may hold dots)."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod_name = f"vobench_{kind}_{name.replace('.', '_')}"
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports (with --trace 0)."""
    return [m for m in bench["end_to_end"] if _reports(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports (with --trace 1): those that
    list it, or without a list, every cell that reports the metric they move."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

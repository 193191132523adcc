"""The benchmark's driver, driven by data: a cell of BENCHMARK.json names a
configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`, whose `kind` names its generator,
`traffic/<kind>.py`); the cell's limits are `limits/<cell>.json` and each
per-layer metric is read by `metrics/<metric>.py`.

A generator's `run(ctx)` returns the end-to-end numbers, the counts of
attempted and failed work, the peak memory, the per-layer readings of a
traced run and the comparison with the reference as [(name, value,
limit)].  This module picks the cell's metrics, reads the per-layer ones,
and prints the result.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "textboost_tpu")


@dataclasses.dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmp: str
    trace_path: str
    t0: float
    control: bool = False

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def mark(self, what: str) -> None:
        """A line on standard error: `what`, seconds since the process began."""
        print(f"at +{time.perf_counter() - self.t0:.2f} s: {what}", file=sys.stderr)


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that cell
    `name` reports: those that list it, and those that list no cells."""
    return [m for m in bench[section] if name in m.get("workloads", [name])]


def read_metric(name: str, readings: dict) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)


def run_cell(ctx: Context) -> dict:
    gen = importlib.import_module(f"portbench.traffic.{ctx.traffic['kind']}")
    return gen.run(ctx)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(bench: dict, ctx: Context, outcome: dict, device: dict) -> dict:
    """The last line's object; the comparison's numbers under `limits`, last."""
    checks = outcome["checks"]
    correct = all(value == value and value <= limit for _, value, limit in checks)
    metrics = {}
    if ctx.trace:
        for m in cell_metrics(bench, ctx.workload, "per_layer"):
            value = read_metric(m["name"], outcome["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, ctx.workload, "end_to_end"):
            metrics[m["name"]] = {"value": outcome["metrics"][m["name"]], "unit": m["unit"]}
    line = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace:
        summary = outcome["readings"]["trace"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["limits"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return line

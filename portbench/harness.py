"""One run of one cell: find its configuration, traffic mix, driver and
metrics by the names in ``BENCHMARK.json``, set up, measure, check the
answers against the plain reference, and build the result line.

Everything that belongs to one configuration, mix or metric lives in a
file of its own, found by name:

- ``portbench/configs/<config>.json`` (the path ``BENCHMARK.json`` gives):
  the deployment's sizes, its source, ``assumed`` and ``reduced``;
- ``portbench/traffic/<traffic>.json``: the mix's parameters, with
  ``entry``, the driver that runs it;
- ``portbench/drivers/<entry>.py``: how one request or job drives the
  program, the work it needs, and its check against the reference;
- ``portbench/metrics/<metric>.py``: a reader of one metric
  (``read(run) -> float | None``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Optional

FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "stormtpu")


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, kind: str, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    modname = f"portbench_{kind}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def find_workload(spec: dict, name: str) -> dict:
    for wl in spec["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def load_config(root: Path, spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _load_json(root / c["file"])
    raise KeyError(f"BENCHMARK.json has no config {name!r}")


def load_traffic(root: Path, name: str) -> dict:
    path = root / "portbench" / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix named {name!r}: {path} is missing")
    return _load_json(path)


def load_driver(root: Path, entry: str):
    return _load_module(root / "portbench" / "drivers" / f"{entry}.py", "driver", entry)


def load_metric(root: Path, name: str):
    return _load_module(root / "portbench" / "metrics" / f"{name}.py", "metric", name)


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Cell:
    """What a driver gets: the cell's names and parameters and the device."""

    root: Path
    workload: str
    config: dict
    traffic: dict
    seed: int
    device: Any  # torch.device
    log: Any = print

    @contextlib.contextmanager
    def timed(self, what: str):
        """Log how long a step of set-up or of the check took."""
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.log(f"[portbench]   {what}: {time.perf_counter() - t0:.3f} s")


@dataclasses.dataclass
class Unit:
    """One request or job of the loop: its host-clock seconds, the pairs
    its answer holds, and the driver's own spans (seconds by name)."""

    seconds: float
    pairs: int
    spans: dict


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    units: list             # [Unit] of the measured (or traced) loop
    elapsed_s: float        # the loop's host-clock length, every unit in it whole
    work: tuple             # (ops, bytes) the answer of one unit needs
    trace: Optional[Any] = None    # devtrace.DeviceTrace of a traced run
    stages: Optional[dict] = None  # the stage pass's record (seconds, device_ms, stripes, units)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop(driver, state, seconds: float, max_units: Optional[int], device, first_index: int):
    """Closed loop, one client: a unit starts when the previous one has
    returned, until ``seconds`` have passed (the unit in flight finishes
    and counts) or ``max_units`` ran. Returns (units, elapsed_s, error)."""
    units: list[Unit] = []
    error = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline and (max_units is None or len(units) < max_units):
        u0 = time.perf_counter()
        try:
            pairs, spans = driver.unit(state, first_index + len(units))
            _sync(device)
        except Exception:  # a failing call ends the window and the run's correctness
            error = traceback.format_exc()
            break
        units.append(Unit(time.perf_counter() - u0, int(pairs), spans))
    return units, time.perf_counter() - t0, error


def span(name: str):
    """A host range named ``portbench.<name>`` in a traced run's profile, so
    that the idle gaps while the host runs code outside torch's operations
    are named by the call the benchmark made."""
    from torch.profiler import record_function

    return record_function(f"portbench.{name}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_TOP))


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """One run of ``workload``; returns the result line as a dict (the
    ``device`` entry's card fields are the caller's)."""
    import torch

    spec = load_spec(root)
    wl = find_workload(spec, workload)
    cell = Cell(root, workload, load_config(root, spec, wl["config"]),
                load_traffic(root, wl["traffic"]), int(seed), device, log)
    driver = load_driver(root, cell.traffic["entry"])
    readers = {m["name"]: load_metric(root, m["name"]) for m in metrics_of(spec, workload, trace)}
    state = driver.setup(cell)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] {workload} seed {seed}: set-up {setup_s:.3f} s")

    mix = cell.traffic
    dtrace = stages = None
    if trace:
        from portbench import devtrace

        (units, elapsed, error), dtrace = devtrace.profiled(
            lambda: loop(driver, state, seconds, mix.get("traced_units"), device, 0), device)
        n_window = len(units)
        if error is None:
            from stormtpu_torch.stream import record_stages

            with record_stages() as rec:
                st_units, _, error = loop(driver, state, float("inf"), mix["stage_units"],
                                          device, n_window)
            stages = {"seconds": dict(rec.seconds), "device_ms": dict(rec.device_ms),
                      "stripes": rec.stripes, "units": len(st_units)}
            n_window += len(st_units)
    else:
        units, elapsed, error = loop(driver, state, seconds, None, device, 0)
        n_window = len(units)
    log(f"[portbench] {workload}: {len(units)} units in {elapsed:.3f} s"
        + (f"; failed: {error}" if error else ""))
    if units:
        ms = [u.seconds * 1e3 for u in units]
        slow = sorted(range(len(ms)), key=ms.__getitem__)[-8:]
        q = statistics.quantiles(ms, n=100, method="inclusive") if len(ms) > 1 else ms * 99
        log(f"[portbench]   unit ms: median {q[49]:.2f} p90 {q[89]:.2f} p95 {q[94]:.2f} "
            f"p99 {q[98]:.2f} max {max(ms):.2f}; slowest (index:ms) "
            + " ".join(f"{i}:{ms[i]:.1f}" for i in slow))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"the run imported {', '.join(bad)}")

    driver.release(state)
    with cell.timed("check"):
        compared = driver.check(cell, state)
    correct = error is None and bool(units) and all(v <= lim for v, lim in compared.values())

    run = Run(cell, setup_s, units, elapsed, driver.work(cell), dtrace, stages)
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"memory_peak_bytes": int(peak)}
    if dtrace is not None:
        dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
    out = {"correct": bool(correct), "attempted": n_window + (1 if error else 0),
           "failed": 1 if error else 0, "metrics": metrics, "device": dev}
    if dtrace is not None:
        out["breakdown"] = {"device_ops": dtrace.device_ops, "idle_gaps": dtrace.idle_gaps}
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out

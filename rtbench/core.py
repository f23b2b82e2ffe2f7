"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs it, reads its metrics and builds the result line.

A cell names a configuration (``rtbench/configs/<config>.json``) and a
traffic mix (``rtbench/traffic/<traffic>.json``); the mix's ``kind`` names
the module of this package that drives it (``rtbench/<kind>.py``), and the
correctness limits of the configuration's render settings that the mix
takes sit in ``rtbench/limits/<config>.<render>.json``.  Every quantity is
read by its own reader, ``rtbench/metrics/<quantity>.py``, the metric's
name up to its first dot (``host_ms.fit`` and ``host_ms.frames`` are both
read by ``host_ms.py``), whose ``read(run)`` returns a number or None
(nothing to read in this run); ``BENCHMARK.json`` says which cells report
which metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import socket
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CALL_SPAN = "rtbench.call"   # the profiler's name of a timed call


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix's file
    limits: dict          # {check: limit}
    end_to_end: list      # the spec's entries this cell reports
    per_layer: list

    @property
    def render(self) -> dict:
        """The render settings of this cell: the configuration's entry that
        the traffic mix names."""
        return self.config["render"][self.traffic["render"]]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports the per-layer ``metric``: the cells its
    ``workloads`` lists or, without that key, every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, spec: dict | None = None, root: Path = REPO
              ) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default), its
    files read from the checkout ``root``."""
    spec = spec or load_json(root / "BENCHMARK.json")
    base = root / HERE.name
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(root / conf["file"]),
                traffic=traffic,
                limits=load_json(base / "limits" /
                                 f"{w['config']}.{traffic['render']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(name: str, base: Path = HERE):
    """The reader of the metric ``name``: the module
    ``rtbench/metrics/<quantity>.py``, ``name`` up to its first dot."""
    quantity = name.split(".")[0]
    path = base / "metrics" / f"{quantity}.py"
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{quantity}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    """The module that drives a traffic mix of ``kind``."""
    return importlib.import_module(f"rtbench.{kind}")


@dataclasses.dataclass
class Ctx:
    """What a rank of a run gets: the cell, the run's arguments, the device
    and, over several chips, its rank and the group's address."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str           # "cuda" or "cpu"
    t0: float             # the process's start on the host clock
    rank: int = 0
    world: int = 1
    init_method: str = ""


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers read it."""

    setup_s: float
    window_s: float
    # (dispatch, return, done) of every timed call on the host clock; the
    # first ``traced`` ran under the profiler
    calls: list
    traced: int = 0
    traces: list = dataclasses.field(default_factory=list)  # one a rank
    work: dict = dataclasses.field(default_factory=dict)
    world: int = 1


@dataclasses.dataclass
class Outcome:
    """Rank 0's result of a run."""

    run: Run
    attempted: int
    failed: int
    checks: dict          # {name: (value, limit)}
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(ctx: Ctx, prepare=None) -> None:
    if prepare is not None:
        prepare()
    kind_module(ctx.cell.traffic["kind"]).run(ctx)


# seconds a rank may take to exit once rank 0 has its result
JOIN_S = 120.0


def run_cell(ctx: Ctx, prepare=None) -> Outcome:
    """Run the cell on ``ctx.cell.chips`` ranks: rank 0 in this process,
    the others in processes of their own, started here and waited for.
    ``prepare``, a picklable callable, runs first in every rank (tests plant
    faults with it)."""
    if prepare is not None:
        prepare()
    mod = kind_module(ctx.cell.traffic["kind"])
    world = ctx.cell.chips
    if world == 1:
        return mod.run(ctx)
    import multiprocessing as mp
    spawn = mp.get_context("spawn")
    addr = f"tcp://127.0.0.1:{free_port()}"
    ctx = dataclasses.replace(ctx, world=world, init_method=addr)
    procs = [spawn.Process(target=_rank_main, args=(
        dataclasses.replace(ctx, rank=r), prepare)) for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = mod.run(ctx)
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out


def metrics(cell: Cell, run: Run, trace: bool, base: Path = HERE) -> dict:
    """The cell's end-to-end metrics (``trace`` False) or per-layer metrics
    (True) that this run gives: ``{name: {"value", "unit"}}``."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], base).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


FORBIDDEN = ("jax", "jaxlib", "flax", "raytpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result(cell: Cell, out: Outcome, trace: bool, device: dict,
           base: Path = HERE) -> dict:
    """The result line; the compared numbers come last, under ``checks``."""
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed,
            "metrics": metrics(cell, out.run, trace, base),
            "device": dict(device,
                           memory_peak_bytes=int(out.memory_peak_bytes))}
    if trace and out.run.traces:
        tr = out.run.traces
        line["device"]["busy_s"] = sum(t.busy_s for t in tr) / len(tr)
        line["device"]["window_s"] = sum(t.window_s for t in tr) / len(tr)
        line["breakdown"] = {"device_ops": tr[0].top_ops(),
                             "idle_gaps": tr[0].idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line

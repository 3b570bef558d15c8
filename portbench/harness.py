"""The harness: finds a cell's files by the names in BENCHMARK.json, gives
its driver seeds, a scratch directory and the measured window, reads the
profiler's trace of a traced run, and builds the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by name:
    configs/<config>.json    the configuration (the manifest's `file`)
    traffic/<traffic>.json   the traffic's parameters and its driver's name
    limits/<cell>.json       the limit of each number the check compares
    drivers/<driver>.py      one module per kind of window: run(ctx)
    metrics/<metric>.py      one reader per per-layer metric: read(run)
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import roofline

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# whole top-level module names no run may load: the JAX stack and the JAX
# package (cocodr_tpu_torch, the port, shares the JAX package's prefix)
FORBIDDEN = ("jax", "jaxlib", "flax", "cocodr_tpu")
BREAKDOWN_TOP = 10
NAME_CHARS = 160  # kernel names in the breakdown are cut to this length
WINDOW_MARK = "portbench.window"
SHORT_GAP_NS = 20_000


class BenchError(Exception):
    """A manifest, a cell's file or the machine does not fit the run."""


def load_json(path) -> dict:
    with open(path, encoding="utf8") as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in the manifest")


@dataclasses.dataclass
class CellFiles:
    cell: dict
    config: dict
    traffic: dict
    limits: dict


def cell_files(manifest: dict, cell: dict,
               traffic_dir: Path = PKG / "traffic",
               limits_dir: Path = PKG / "limits") -> CellFiles:
    configs = {c["name"]: c for c in manifest["configs"]}
    if cell["config"] not in configs:
        raise BenchError(f"cell {cell['name']}: no config {cell['config']!r}")
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(Path(traffic_dir) / f"{cell['traffic']}.json")
    limits = load_json(Path(limits_dir) / f"{cell['name']}.json")
    return CellFiles(cell, config, traffic, limits)


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed drawn from (seed, tags): any whole seed, however large,
    and a tag per use, so that the inputs, the weights and the sample of one
    run are independent draws of one --seed."""
    key = [int(seed) & (2 ** 64 - 1)] + [
        t if isinstance(t, int) else int.from_bytes(str(t).encode(), "big")
        % 2 ** 32 for t in tags]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
               >> 1)


# --- call recorders: the launches a traced window makes, with their shapes --

def _signature(args) -> tuple:
    return tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                 else a if isinstance(a, (int, float, str)) else None
                 for a in args)


class _Probe:
    """Stands in for a probed function: each call appends the shapes and
    numbers of its positional arguments to `calls`, then calls it. Other
    attributes (a launch counter the function keeps on itself) are the
    function's own, read and written through."""

    def __init__(self, fn, calls: list):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *args, **kw):
        self._calls.append(_signature(args))
        return self._fn(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def recording(probes: Dict[str, Tuple[str, str]], calls: Dict[str, list]):
    """Put a _Probe in place of each probed function (key -> (module,
    attribute)), recording into calls[key]; the functions are restored on
    exit. A probe only records: what the function does is unchanged."""
    saved = []
    try:
        for key, (mod_name, attr) in probes.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _Probe(fn, calls.setdefault(key, [])))
        yield calls
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


# --- the trace ----------------------------------------------------------------

@dataclasses.dataclass
class TraceRun:
    """What a metric reader reads: the device's operations in the traced
    window (name, start ns, duration ns), the host's (name, start, duration,
    thread), the window's bounds (ns, on the trace's clock), the calls the
    probes recorded and the driver's counts."""
    device_ops: List[Tuple[str, int, int]]
    host_ops: List[Tuple[str, int, int, int]]
    window_ns: Tuple[int, int]
    calls: Dict[str, list]
    counts: Dict[str, float]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def device_seconds(self, pattern=None) -> float:
        """Summed duration of the device operations whose name matches
        `pattern` (a compiled regex; None: all)."""
        return sum(d for n, _, d in self.device_ops
                   if pattern is None or pattern.search(n)) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        lo, hi = self.window_ns
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d in self.device_ops)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_percent(self) -> Optional[float]:
        """Share of the window with no device operation running, %."""
        if not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def mfu_percent(self) -> Optional[float]:
        """counts['useful_flops'] over the window's seconds and the bf16
        peak, %."""
        flops = self.counts.get("useful_flops", 0)
        if not flops or not self.device_ops:
            return None
        return 100.0 * flops / (self.window_s * roofline.BF16_FLOP_PER_S)

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window_ns
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation running at each gap's
        midpoint ('host: no traced op' where none was); gaps under 20 us,
        a launch's latency, are summed apart."""
        by_name: Dict[str, int] = {}
        for n, _, d in self.device_ops:
            by_name[n] = by_name.get(n, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
        host = sorted(self.host_ops, key=lambda e: e[1])
        starts = [e[1] for e in host]
        gaps: Dict[str, int] = {}
        for s, e in self.idle_gaps():
            if e - s < SHORT_GAP_NS:
                name = "short gaps between device ops (under 20 us)"
            else:
                mid = (s + e) // 2
                i = bisect.bisect_right(starts, mid)
                best = None
                # the innermost host op covering mid: the shortest among
                # the last ops to start before it
                for j in range(i - 1, max(i - 256, -1), -1):
                    n, st, d, _ = host[j]
                    if st + d >= mid and (best is None or d < best[1]):
                        best = (n, d)
                name = best[0] if best else "host: no traced op"
            gaps[name] = gaps.get(name, 0) + (e - s)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
        return {"device_ops": [[n[:NAME_CHARS], d / 1e9] for n, d in ops],
                "idle_gaps": [[n[:NAME_CHARS], d / 1e9] for n, d in idle]}


def _trace_events(prof):
    """(device ops, host ops) of a stopped torch.profiler.profile, read
    from its kineto events without building the profiler's event tree.
    Annotations (record_function ranges, the optimizer's step range) are
    host ops, also where the trace mirrors them on the device's timeline:
    they run nothing on the device."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    marks = {e.name() for e in events if e.is_user_annotation()}
    dev, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() not in marks:
                dev.append((e.name(), e.start_ns(), e.duration_ns()))
        else:
            host.append((e.name(), e.start_ns(), e.duration_ns(),
                         e.start_thread_id()))
    return dev, host


# --- the run's context ----------------------------------------------------------

class Ctx:
    """What a driver gets: the cell's files, the seed, the device, a scratch
    directory, and the window: begin_window() ends set-up, window_over()
    says whether --seconds have passed, end_window() closes it. With
    --trace 1 the window runs under torch.profiler and the probes the
    driver names record their calls."""

    def __init__(self, files: CellFiles, seed: int, seconds: float,
                 trace: bool, device, tmpdir: str, t_start: float):
        self.config, self.traffic = files.config, files.traffic
        self.limits = files.limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.tmpdir, self.t_start = tmpdir, t_start
        self.setup_s = self.window_s = None
        self.memory_peak_bytes = 0
        self.calls: Dict[str, list] = {}
        self.trace_run: Optional[TraceRun] = None
        self._t0 = None
        self._stack = None
        self._prof = None

    def note(self, what: str):
        """A set-up phase's end, on standard error, in seconds since the
        process started."""
        print(f"portbench: {what} at {time.perf_counter() - self.t_start:.2f}"
              " s", file=sys.stderr, flush=True)

    def close(self):
        """Stop the profiler and the probes if a window is left open (a
        driver that raised)."""
        if self._stack is not None:
            self._stack.close()
            self._prof = self._stack = None

    def rng(self, *tags) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, *tags))

    def gen(self, *tags) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, *tags))
        return g

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_window(self, probes: Optional[dict] = None):
        self.sync()
        self.note("set-up done")
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self._stack = contextlib.ExitStack()
            self._stack.enter_context(recording(probes or {}, self.calls))
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(profile(activities=acts))
            # the window's bounds, on the trace's own clock
            self._stack.enter_context(
                torch.profiler.record_function(WINDOW_MARK))
        self._t0 = time.perf_counter()
        self.setup_s = self._t0 - self.t_start

    def window_over(self) -> bool:
        return time.perf_counter() - self._t0 >= self.seconds

    def end_window(self, counts: Optional[dict] = None):
        """Close the window after the device has finished its work; read the
        peak memory of the run so far."""
        self.sync()
        t1 = time.perf_counter()
        self.window_s = t1 - self._t0
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        if self.trace:
            self._stack.close()
            dev, host = _trace_events(self._prof)
            mark = [(s, s + d) for n, s, d, _ in host if n == WINDOW_MARK]
            if len(mark) != 1:
                raise BenchError(f"the trace holds {len(mark)} window marks")
            host = [e for e in host if e[0] != WINDOW_MARK]
            self.trace_run = TraceRun(dev, host, mark[0], self.calls,
                                      dict(counts or {}))
            self.note(f"trace read: {len(dev)} device and {len(host)} host "
                      "ops")
            self._prof = self._stack = None

    def window(self, unit: Callable[[], float],
               probes: Optional[dict] = None):
        """Run unit() (one batch, chunk or step; returns its work) until
        --seconds have passed -> (units, work). Every unit that starts in
        the window counts, and so does all of its time."""
        self.begin_window(probes)
        n, work = 0, 0.0
        while not self.window_over():
            work += unit()
            n += 1
        return n, work


@dataclasses.dataclass
class Outcome:
    """A driver's result: its end-to-end values by metric name, each
    compared number as (name, value, limit), the units attempted in the
    window and those that failed."""
    e2e: Dict[str, float]
    checks: List[Tuple[str, float, float]]
    attempted: int
    failed: int = 0


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_reader(metric: str):
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics with
    --trace 0, its per-layer ones with --trace 1."""
    if not trace:
        return [m for m in manifest["end_to_end"]
                if "workloads" not in m or cell_name in m["workloads"]]
    e2e = {m["name"] for m in cell_metrics(manifest, cell_name, False)}
    return [m for m in manifest["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def read_metrics(wanted: list, run: TraceRun, on_device: bool) -> dict:
    """The per-layer metrics of a traced run, each by its reader. On the
    card every metric the manifest lists for the cell has to be read: one
    whose reader finds nothing (a kernel renamed, a probe that no longer
    sees its launches) fails the run instead of leaving the line. A CPU
    run has no device trace, and its readers' Nones are left out."""
    metrics, missing = {}, []
    for m in wanted:
        v = load_reader(m["name"]).read(run)
        if v is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if on_device and missing:
        raise BenchError("the traced window gave no reading of "
                         + ", ".join(missing))
    return metrics


def card_info() -> str:
    """The card's name and power limit from nvidia-smi ('' without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().replace("\n", "; ")


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: Optional[float] = None,
             traffic_dir: Path = PKG / "traffic",
             limits_dir: Path = PKG / "limits") -> dict:
    """One run of one cell -> the result line (a dict, `checks` last). The
    caller has checked the machine; the tests call this with device='cpu'
    and tiny files."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(manifest, cell_name)
    files = cell_files(manifest, cell, traffic_dir, limits_dir)
    driver = load_driver(files.traffic["driver"])
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Ctx(files, seed, seconds, trace, device, tmpdir, t_start)
        try:
            out: Outcome = driver.run(ctx)
        finally:
            ctx.close()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    wanted = cell_metrics(manifest, cell_name, trace)
    metrics = {}
    if not trace:
        values = dict(out.e2e, setup_s=ctx.setup_s)
        for m in wanted:
            if m["name"] not in values:
                raise BenchError(f"driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        metrics = read_metrics(wanted, ctx.trace_run,
                               on_device=ctx.device.type == "cuda")
    dev = ctx.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": int(ctx.memory_peak_bytes),
    }
    line = {"correct": all(v <= lim for _, v, lim in out.checks)
            and out.failed == 0,
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.trace_run.busy_s()
        device_info["window_s"] = ctx.trace_run.window_s
        line["breakdown"] = ctx.trace_run.breakdown()
    line["checks"] = {n: {"value": _num(v), "limit": lim}
                      for n, v, lim in out.checks}
    return line


def _num(v: float):
    """A compared number for the JSON line: inf and nan as strings."""
    return v if math.isfinite(v) else str(v)

"""Observability: the counterpart of cocodr_tpu/utils/logging.py.
TensorBoard scalars (tensorboardX, when importable) and a JSONL sink,
spans of the program's work on torch.profiler's clock, and torch.profiler
traces.

The reference logs loss/lr/grad-norm/dev-nDCG per step to tensorboardX
(reference ANCE/drivers/run_ann.py:358-374) and has no profiling; the JAX
package traces with jax.profiler, the port with torch.profiler (a Chrome
trace of the host and, on a card, its kernels).
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

logger = logging.getLogger("cocodr_tpu_torch")


class MetricsLogger:
    """TensorBoard (tensorboardX, optional) + JSONL metrics sink. The JSONL
    records are the JAX package's: {"step": step, prefix + key: value},
    each value a float where float() takes it, else its str."""

    def __init__(self, log_dir: Optional[str] = None,
                 jsonl_path: Optional[str] = None):
        self._tb = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:
                logger.warning("tensorboardX unavailable; TB logging off")
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        if self._tb:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(f"{prefix}{k}", float(v), step)
                except (TypeError, ValueError, RuntimeError):
                    pass
        if self._jsonl:
            rec = {"step": step}
            rec.update(
                {f"{prefix}{k}": _scalar(v) for k, v in metrics.items()}
            )
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb:
            self._tb.close()
        if self._jsonl:
            self._jsonl.close()


def _scalar(v):
    """float(v) (a 0-d tensor too); a value float() refuses as its str."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return str(v)


# --- spans ---------------------------------------------------------------------

SPAN_LOG_LIMIT = 1 << 17  # records kept; the oldest go first


class Span(NamedTuple):
    """One finished span: its name, the thread it ran on
    (threading.get_ident()), its start and end in ns since the Unix epoch
    (torch.profiler's host clock), the name of the span that enclosed it on
    the same thread (None at the top), and its unit: the number of the batch
    or step it worked for, shared by that unit's spans across threads."""
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[str]
    unit: Optional[int]


# Process-wide, as torch.profiler is: the spans sit in modules far apart
# (data/, pipelines/, ops/) and read the profiler's state, not a caller's.
_log: collections.deque = collections.deque(maxlen=SPAN_LOG_LIMIT)
_open = threading.local()  # .stack: this thread's open spans, innermost last
_OFF = contextlib.nullcontext()
_profiler = torch.autograd.profiler  # its _is_profiler_enabled: any thread


class _Span:
    __slots__ = ("name", "unit", "parent", "start", "range")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.unit is None and outer is not None:
            self.unit = outer.unit
        stack.append(self)
        self.range = None
        self.start = time.time_ns()
        if torch._C._autograd._profiler_enabled():  # this thread records
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        end = time.time_ns()
        _open.stack.pop()
        if exc_type is None:
            _log.append(Span(self.name, threading.get_ident(), self.start,
                             end, self.parent, self.unit))
        return False


def span(name: str, unit: Optional[int] = None):
    """A context manager timing one piece of the program's work while a
    torch.profiler runs anywhere in the process; otherwise it does nothing
    (one read of the profiler's flag: no clock, no record).

    Under a profiler, the span is appended to the in-memory log when its
    block ends (`recorded_spans`), with the enclosing span on this thread as
    its parent and, unless `unit` is given, the parent's unit. On the thread
    the profiler traces it also opens a `torch.profiler.record_function`
    range of the same name, so the trace shows it (the logged span holds
    the range); other threads (the prefetch thread) appear in the log
    alone. A block left by an exception
    is not logged: it did not finish its work. Do not yield inside one."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, unit)


def recorded_spans(start_ns: int = 0,
                   end_ns: Optional[int] = None) -> List[Span]:
    """The logged spans that overlap [start_ns, end_ns] (ns since the
    epoch), in the order they ended."""
    return [s for s in _log.copy() if s.end_ns >= start_ns
            and (end_ns is None or s.start_ns <= end_ns)]


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler over the block (the host, and the card when there is
    one), written as a Chrome trace `trace-{ms since epoch}.json` under
    log_dir (chrome://tracing, Perfetto or TensorBoard's profiler view),
    and the block's spans (`span`) as `spans-{the same ms}.json`: a list of
    Span records as objects, those of every thread, since the trace holds
    only the traced thread's."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    start = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    end = time.time_ns()
    stamp = end // 1_000_000
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{stamp}.json"))
    with open(os.path.join(log_dir, f"spans-{stamp}.json"), "w") as f:
        json.dump([s._asdict() for s in recorded_spans(start, end)], f)

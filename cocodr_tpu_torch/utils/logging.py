"""Observability: the counterpart of cocodr_tpu/utils/logging.py.
TensorBoard scalars (tensorboardX, when importable) and a JSONL sink,
per-phase wall-clock timing, and torch.profiler traces.

The reference logs loss/lr/grad-norm/dev-nDCG per step to tensorboardX
(reference ANCE/drivers/run_ann.py:358-374) and has no profiling; the JAX
package traces with jax.profiler, the port with torch.profiler (a Chrome
trace of the host and, on a card, its kernels).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

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

    def log_histogram(self, step: int, tag: str, values):
        if self._tb:
            self._tb.add_histogram(tag, values, step)

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


class StepTimer:
    """Per-phase wall-clock accounting (encode / search / train / mine)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_s": self.totals[k] / self.counts[k],
            }
            for k in self.totals
        }


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler over the block (the host, and the card when there is
    one), written as a Chrome trace `trace-{ms since epoch}.json` under
    log_dir (chrome://tracing, Perfetto or TensorBoard's profiler view)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{int(time.time() * 1000)}.json"))

"""Run logging (ssf_slam_tpu/utils/logging.py): line logging to
``run.log``, one JSON object per metrics record in ``metrics.jsonl``, an
optional TensorBoard writer (``torch.utils.tensorboard``, attached when it
imports, as in the JAX package), a config snapshot in ``config.json``,
``profile_trace``, a ``torch.profiler`` scope that writes a Chrome/Perfetto
trace, and ``span``, the port's named ranges on that trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Optional

import torch

_OFF = contextlib.nullcontext()


class RunLogger:
    def __init__(self, run_dir: str, tensorboard: bool = False):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._log = open(os.path.join(run_dir, "run.log"), "a")
        self._metrics = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                self._tb = None

    def cprint(self, msg: str) -> None:
        """Print a time-stamped line to stdout and run.log."""
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        self._log.write(line + "\n")
        self._log.flush()

    def metrics(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def snapshot_config(self, cfg: Any) -> None:
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(_to_jsonable(cfg), f, indent=2, default=str)

    def close(self) -> None:
        self._log.close()
        self._metrics.close()
        if self._tb is not None:
            self._tb.close()


def _to_jsonable(obj: Any):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str]):
    """``torch.profiler`` scope over the CPU and, when present, the card;
    on exit it writes ``<out_dir>/trace.json`` (Chrome/Perfetto). Does
    nothing when ``out_dir`` is None."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def span(name: str, **args):
    """The range ``ssf.<name>`` on the profiler's timeline while a
    ``torch.profiler`` session is active (``profile_trace``, or any other),
    with ``args`` (e.g. ``scan=k``, a scan's index) among its arguments
    where the session records shapes; otherwise one shared null context, so
    that a run nobody profiles pays a single check a span. Spans nest: the
    innermost open one is the stage the host is in, and the device's
    kernels launched inside it are its own.

    The range is a function-scope record (``_RecordFunctionFast``), not a
    user annotation (``record_function``): it sits on the host's timeline
    and is linked to the kernels it launched, but puts no copy of itself on
    the device's timeline, so a tool that counts the device's events or
    their busy time counts the same with the port's spans as without."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(f"ssf.{name}", [], args)

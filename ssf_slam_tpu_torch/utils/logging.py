"""Run logging (ssf_slam_tpu/utils/logging.py::RunLogger, without its
TensorBoard writer and its profiler hook): line logging to ``run.log``,
one JSON object per metrics record in ``metrics.jsonl``, and a config
snapshot in ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any


class RunLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._log = open(os.path.join(run_dir, "run.log"), "a")
        self._metrics = open(os.path.join(run_dir, "metrics.jsonl"), "a")

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

    def snapshot_config(self, cfg: Any) -> None:
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(_to_jsonable(cfg), f, indent=2, default=str)

    def close(self) -> None:
        self._log.close()
        self._metrics.close()


def _to_jsonable(obj: Any):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj

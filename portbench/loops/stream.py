"""Open loop, online: scans come due at a fixed rate and go through
``engine/streaming.py::StreamingRunner.run`` (depth ``pipeline_depth``,
the Morton box anchored at each drive's first scan), one runner a drive,
drives of the seed's pool back to back. A scan's latency runs from when it
was due to when its pose was on the host: the runner's own latency
(pickup to pose) plus how late the runner picked it up. Scans due inside
the window are offered; each drive's poses stream to a TUM file under the
temporary directory, as ``cli run --stream`` writes them.

The mix adds ``rate_hz``, ``pipeline_depth`` and ``box_margin`` to the
drive mix's keys.

A traced run streams the measured window as an untraced run does, and its
stamps give the runner's service time and pickup lag; then one drive at
the cell's rate under the profiler gives the device's records. The
profiler slows the host past the period, so that drive falls behind and
no per-layer number is read from its latencies.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np

from portbench import program, trace
from portbench.gen.seeds import sub_seed
from portbench.loops.drive import (
    control_runs,
    judge,
    make_drives,
    sample,
    settle,
)
from portbench.work import network


class Stamped(list):
    """The runner's ``latencies_ms`` that also keeps when each entry came:
    the moment that scan's pose was on the host."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def append(self, value):
        self.stamps.append(time.perf_counter())
        super().append(value)


class Recorder:
    """Keeps each step's outputs (device tensors, no copy) while the
    runner's ``make_fused_step`` is wrapped."""

    def __init__(self):
        self.outs = []

    def install(self, streaming):
        orig = streaming.make_fused_step

        def make(*args, **kwargs):
            step, make_carry = orig(*args, **kwargs)

            def recorded(carry, scan):
                carry, outs = step(carry, scan)
                self.outs.append(outs[0])
                return carry, outs

            return recorded, make_carry

        streaming.make_fused_step = make
        return lambda: setattr(streaming, "make_fused_step", orig)


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.device = config, mix, device
        self.n = config["flownet"]["npoint"]
        self.drives = make_drives(config, mix, seed)
        self.model = program.load_tflow(config, device)
        self.cfg = program.pipeline_config(config)
        self.tum = os.path.join(tempfile.gettempdir(), "portbench-stream.tum")
        # (pool index, outputs by scan, due times, pose times, the runner's
        # own latencies)
        self.done = []
        self.rng = np.random.default_rng(sub_seed(seed, 11))
        # warm-up: a runner over a few scans, unpaced, with its own warm-up
        self.runner().run(self.drives[0][:3], warmup=True)
        settle(device)

    def runner(self):
        from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

        return StreamingRunner(
            self.model, self.cfg, box_margin=self.mix["box_margin"], tum_path=self.tum,
            pipeline_depth=self.mix["pipeline_depth"], device=self.device)

    def stream(self, t0: float, t_end: float, first: int, d: int) -> int:
        """Drive ``d`` through a fresh runner, scan ``first + j`` due at
        ``t0 + (first + j) / rate``; scans due after ``t_end`` are not
        offered. Returns the scans offered."""
        import ssf_slam_tpu_torch.engine.streaming as streaming

        rate = self.mix["rate_hz"]
        due = []

        def paced():
            for j, f in enumerate(self.drives[d]):
                t_due = t0 + (first + j) / rate
                if t_due >= t_end:
                    return
                wait = t_due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                due.append(t_due)
                yield f

        rec = Recorder()
        undo = rec.install(streaming)
        try:
            runner = self.runner()
            runner.latencies_ms = Stamped()
            runner.run(paced(), warmup=False)
        finally:
            undo()
        if due:
            lat = runner.latencies_ms
            self.done.append((d, rec.outs, np.asarray(due),
                              np.asarray(lat.stamps), np.asarray(lat)))
        return len(due)

    def run_window(self, seconds: float) -> int:
        t0 = time.perf_counter()
        t_end = t0 + seconds
        offered, i = 0, 0
        while t0 + offered / self.mix["rate_hz"] < t_end:
            offered += self.stream(t0, t_end, offered, i % len(self.drives))
            i += 1
        return offered

    def latencies(self):
        """(due-to-pose ms, the runner's pickup-to-pose ms, due-to-pickup
        ms) of every scan streamed."""
        total = np.concatenate([(r[3] - r[2]) * 1e3 for r in self.done])
        service = np.concatenate([r[4] for r in self.done])
        return total, service, total - service

    def window(self, seconds: float) -> dict:
        offered = self.run_window(seconds)
        total, _, _ = self.latencies()
        return dict(scan_latency_p95_ms=float(np.percentile(total, 95)),
                    attempted=offered)

    def traced(self, spans: trace.Spans, seconds: float) -> dict:
        import ssf_slam_tpu_torch.engine.fused as fused
        import ssf_slam_tpu_torch.engine.streaming as streaming

        offered = self.run_window(seconds)
        _, service, lag = self.latencies()

        targets = [(self.model, "tower", "tower"),
                   (self.model, "head", "head"),
                   (fused, "slam_step", "slam_step"),
                   (streaming.StreamingRunner, "_readback", "readback")]
        one = len(self.drives[0]) / self.mix["rate_hz"]
        with trace.wrapped(spans, targets):
            units, tr = trace.profile(lambda: self.run_window(one))
        stats = dict(service_ms=service, lag_ms=lag)
        return dict(ctx=trace.Context(tr, units,
                                      network.serve_scan(self.config),
                                      stats), attempted=offered + units)

    def release(self) -> None:
        import torch

        self.model = None
        gc.unfreeze()
        if os.path.exists(self.tum):
            os.remove(self.tum)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_outputs(self, outs: list) -> dict:
        import torch

        got = {}
        for key in ("pose_q", "pose_t", "rel_q", "rel_t", "flow"):
            got[key] = torch.stack([o[key] for o in outs]).float().cpu() \
                .numpy()
        got["is_keyframe"] = np.asarray([bool(o["is_keyframe"])
                                         for o in outs])
        got["seg"] = got["flow"][..., 3]
        got["static"] = got["seg"] < 0.0
        return got

    def boxed(self, d: int, count: int):
        """The first ``count`` frames of pool drive ``d`` and the box the
        runner anchors at its first scan."""
        from portbench.reference.plain.engine.fused import anchored_box

        frames = self.drives[d][:count]
        return frames, anchored_box(frames[0]["pos1"][:self.n],
                                    self.mix["box_margin"], self.device)

    def compare(self, quant=None) -> list:
        """``compare.drive_numbers`` of a sample of the drives streamed
        (the longest among them), drawn from the seed; with ``quant``, of
        the control's run of each pool drive, under the runner's anchored
        box."""
        if quant is not None:
            items = [self.boxed(d, len(f)) for d, f in enumerate(self.drives)]
            return judge(self.config, self.device,
                         control_runs(self.config, self.device, quant,
                                      items), items, self.n)
        picked = sample(self.rng, [len(r[1]) for r in self.done])
        items = [self.boxed(self.done[i][0], len(self.done[i][1]))
                 for i in picked]
        got = [self.program_outputs(self.done[i][1]) for i in picked]
        return judge(self.config, self.device, got, items, self.n)

"""Online streaming SLAM runner, the live operating mode
(ssf_slam_tpu/engine/streaming.py).

The reference is a live system: scans arrive at 10 Hz
(scripts/PointCloudOdometry.py:42) and the odometry loop polls at the same
rate. ``StreamingRunner`` is the per-arriving-scan host loop:

- one call of the fused step (``engine/fused.py``) per arriving scan, with
  tower caching, so each arrival costs one cloud's pyramid and the head;
- the caller's frames are pulled on a thread of their own
  (``_FrameSource``) into a one-slot queue, so that the runner sees
  whether a scan is waiting. That thread only calls ``next`` on the
  caller's iterator: the uploads, the step, the readbacks, the events and
  every ``ssf.*`` span stay on the runner's thread. ``run`` stops and
  joins it on its way out, normal or not (waiting at most ``JOIN_S`` for
  a ``next`` in progress), and raises again an error of the source;
- poses come back through a FIFO of at most ``pipeline_depth`` pending
  readbacks: each scan's ``pose_t || pose_q`` is copied into pinned host
  memory with ``non_blocking=True`` behind a CUDA event. After each
  dispatch the oldest scan is retired (its event waited on, its TUM line
  written) while ``pipeline_depth`` scans are in flight, no scan is
  waiting, or its copy is already done; then the runner takes the next
  scan. So a pose is held only while the device is still behind the host
  and a scan waits: depth > 1 then overlaps the pose's readback with the
  next dispatch. ``retired_early`` counts the poses retired before the
  depth bound and outside the final drain. Depth 1 is strictly
  synchronous. The port's step itself syncs the host a few times a scan
  (the keyframe gate, loop detection, the Kabsch SVD), so at the port's
  rates the copy is done when the step returns and no pose is held;
- the TUM trajectory is written incrementally, in arrival order, in the TUM
  order ``t x y z qx qy qz qw`` of ``engine/evaluation.py::write_tum``;
- ``latency_ms_*`` is completion latency (arrival to the pose on the
  host), ``dispatch_ms_*`` the host time to run one step's call,
  ``held_ms_*`` how long a finished pose waited in the FIFO before it was
  retired (behind the next scan's dispatch only where that scan was
  already waiting and the copy not yet done), ``hz`` the sustained rate.
  They come from ``timings``, one ``ScanTimes`` a scan (host
  ``time.perf_counter`` seconds): pickup, the step dispatched with its
  readback enqueued, the pose ready on the host, and the pose retired.
  ``ready`` on the card is pickup plus the device time from an event
  recorded at pickup to the readback's event (read at retirement, after
  the wait the runner does anyway, so it costs no sync); where the device
  is still busy with earlier work at pickup it reaches that event late,
  and ``ready`` reads early by that much. On the CPU the
  copy is done when the step returns: ``ready = dispatched``. Under a
  profiler (``utils/logging.py::span``) the step is ``ssf.step``, the
  readback ``ssf.readback`` and the retirement ``ssf.retire``.

The Morton box cannot cover a sequence that has not arrived yet: it is
anchored at the first scan, padded by ``box_margin`` metres. Points that
leave it clamp to its edge, which costs banded-kNN recall, never a fault;
the runner warns once with the measured overshoot (``box_overshoot``).

``run`` can start from a saved ``SlamState`` (``engine/checkpoint.py``)
and the last scan before it (``prev``): give the fresh runner the first
run's ``box`` so that the towers are sorted as before.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import sys
import threading
import time
from typing import Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.engine.fused import make_fused_step, sequence_box
from ssf_slam_tpu_torch.ops.precision import set_geom_precision
from ssf_slam_tpu_torch.utils.logging import span


class ScanTimes(NamedTuple):
    """One streamed scan's stamps, ``time.perf_counter`` seconds."""

    scan: int  # index in its run
    pickup: float  # the runner took the scan
    dispatched: float  # the step returned, the readback enqueued
    ready: float  # the pose on the host
    retired: float  # the pose retired (its TUM line written after)

    @property
    def held(self) -> float:
        """How long the finished pose waited in the FIFO."""
        return self.retired - self.ready


_END = object()  # the caller's iterator is exhausted


class _FrameSource:
    """The caller's frames, pulled by a thread of their own into a
    one-slot queue. The thread calls nothing but ``next`` on the iterator
    (no torch call: the profiler's callbacks and the CUDA work stay on the
    runner's thread). ``close`` stops it and joins it."""

    JOIN_S = 10.0  # how long ``close`` waits for the caller's ``next``
    POLL_S = 0.05  # how often a blocked hand-off looks for ``close``

    def __init__(self, it: Iterator[dict]):
        self._it = it
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._pull, daemon=True,
                                       name="ssf-stream-source")
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self.POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _pull(self) -> None:
        last = _END
        try:
            for f in self._it:
                if not self._put(f):
                    return
        except BaseException as exc:  # raised again by ``get``
            last = exc
        self._put(last)

    def waiting(self) -> bool:
        """Whether a frame (or the end) is ready to take."""
        return not self._queue.empty()

    def get(self) -> Optional[dict]:
        """The next frame, waiting for it; None at the end."""
        item = self._queue.get()
        if isinstance(item, BaseException):
            raise item
        return None if item is _END else item

    def __enter__(self) -> "_FrameSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._stop.set()
        self.thread.join(self.JOIN_S)
        if self.thread.is_alive():
            print(f"WARNING: the frame source did not return within "
                  f"{self.JOIN_S:.0f} s of the run's end; its thread is "
                  "left to finish on its own", file=sys.stderr)


def box_overshoot(points: np.ndarray, mask: np.ndarray, box) -> float:
    """Max distance (m) any valid point lies outside the Morton box
    (origin [1, 3], scale [1], as ``sequence_box`` builds it); 0.0 when
    every valid point is inside."""
    lo = np.asarray(box[0].cpu() if torch.is_tensor(box[0])
                    else box[0]).reshape(3)
    span = float(np.asarray(box[1].cpu() if torch.is_tensor(box[1])
                            else box[1]).reshape(()))
    p = np.asarray(points, np.float32).reshape(-1, 3)
    m = np.asarray(mask).reshape(-1).astype(bool)
    if not m.any():
        return 0.0
    p = p[m]
    over = np.maximum(lo - p, p - (lo + span))
    return float(max(over.max(), 0.0))


class StreamingRunner:
    """Per-arriving-scan SSF / SF / ssfc pipeline with incremental TUM
    output. ``model`` (and ``seg_apply``'s net) must live on ``device``."""

    def __init__(self, model, cfg: PipelineConfig, use_gmm: bool = False,
                 seg_apply=None, box_margin: float = 100.0,
                 tum_path: Optional[str] = None, pipeline_depth: int = 2,
                 device: str | torch.device = "cuda", box=None):
        self.model = model
        self.cfg = cfg
        self.use_gmm = use_gmm
        self.seg_apply = seg_apply
        self.box_margin = box_margin
        self.tum_path = tum_path
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.device = resolve_device(device)
        self.box = box  # anchored at the first scan of run() when None
        self.latencies_ms: list[float] = []
        self.timings: list[ScanTimes] = []
        self.final_state = None  # SlamState after run() (map export etc.)

    def _anchor_box(self, first: dict, n: int):
        pts = np.asarray(first["pos1"][:n], np.float32)
        return sequence_box(np.concatenate([pts - self.box_margin,
                                            pts + self.box_margin]),
                            device=self.device)

    def _to_device(self, f: dict, n: int) -> tuple:
        """A frame's (points [n, 3], mask [n], time) on the device."""
        dev = self.device
        return (torch.as_tensor(np.asarray(f["pos1"][:n], np.float32),
                                device=dev),
                torch.as_tensor(np.asarray(f["mask1"][:n]).astype(bool),
                                device=dev),
                torch.tensor(float(f["time"]), dtype=torch.float32,
                             device=dev))

    def _readback(self, outs: dict):
        """Start the copy of pose_t || pose_q to the host: (host tensor,
        timing-enabled CUDA event or None)."""
        with span("readback"):
            pose = torch.cat([outs["pose_t"], outs["pose_q"]])
            if not pose.is_cuda:
                return pose.clone(), None
            host = torch.empty(pose.shape, dtype=pose.dtype,
                               pin_memory=True)
            host.copy_(pose, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return host, event

    def run(self, frames: Iterable[dict], warmup: bool = True,
            state=None, prev: Optional[dict] = None) -> dict:
        """Consume frame dicts ({pos1, mask1, time}); poses stream to
        ``tum_path`` as they retire. Returns the summary stats.

        ``warmup`` runs one throwaway step on the first scan (a live
        deployment builds its kernels before the sensor starts). ``state``
        and ``prev`` resume a run: the step starts from that SlamState, and
        the first scan pairs with ``prev`` (else with itself)."""
        set_geom_precision()
        n = self.cfg.lidar.max_points
        it: Iterator[dict] = iter(frames)
        first = next(it)
        if self.box is None and self.model.cfg.neighbor_backend == "banded":
            self.box = self._anchor_box(first, n)
        box = self.box
        step, make_carry = make_fused_step(self.model, self.cfg, box,
                                           self.use_gmm, self.seg_apply)
        prev_pts, prev_mask, _ = self._to_device(prev if prev is not None
                                                 else first, n)

        def scan_of(f):
            """The step's scan dict of frame f at batch 1."""
            pts, mask, t = self._to_device(f, n)
            return dict(points=pts[None], prev=prev_pts[None],
                        mask=mask[None], prev_mask=prev_mask[None],
                        time=t[None])

        pending: collections.deque = collections.deque()
        n_scans = retired_early = 0
        warned_box = False
        on_card = self.device.type == "cuda"

        def on_host(entry) -> bool:
            """Whether the entry's copy is done (on the CPU, always)."""
            event = entry[6]
            return event is None or event.query()

        def retire(entry):
            k, t_arr, t_disp, t_scan, host, start, event = entry
            with span("retire"):
                if event is not None:
                    event.synchronize()
                v = host.tolist()  # [x, y, z, qx, qy, qz, qw]
                t_ret = time.perf_counter()
                self.latencies_ms.append((t_ret - t_arr) * 1e3)
                ready = t_disp
                if start is not None:
                    done = t_arr + start.elapsed_time(event) * 1e-3
                    ready = min(max(t_disp, done), t_ret)
                self.timings.append(ScanTimes(k, t_arr, t_disp, ready,
                                              t_ret))
                if fh is not None:
                    fh.write(f"{t_scan:.6f} "
                             + " ".join(f"{x:.6f}" for x in v) + "\n")
                    fh.flush()

        tum = (open(self.tum_path, "w") if self.tum_path
               else contextlib.nullcontext())
        with tum as fh, _FrameSource(it) as source, torch.inference_mode():
            if warmup:
                _, o = step(make_carry(prev_pts[None]), scan_of(first))
                o[0]["pose_t"].cpu()
                del o
            carry = make_carry(prev_pts[None])
            if state is not None:
                carry = ([state], carry[1])
            t_start = time.perf_counter()
            f = first
            while f is not None:
                t0 = time.perf_counter()
                start = None
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                if box is not None and not warned_box:
                    over = box_overshoot(f["pos1"][:n], f["mask1"][:n], box)
                    if over > 0.0:
                        warned_box = True
                        print(f"WARNING: scan points drifted {over:.1f} m "
                              f"outside the anchored Morton box (box_margin="
                              f"{self.box_margin:.0f} m); banded-kNN recall "
                              "degrades beyond it — raise box_margin to the "
                              "route's expected travel", file=sys.stderr)
                scan = scan_of(f)
                with span("step", scan=n_scans):
                    carry, outs = step(carry, scan)
                host, event = self._readback(outs[0])
                pending.append((n_scans, t0, time.perf_counter(),
                                float(f["time"]), host, start, event))
                prev_pts, prev_mask = scan["points"][0], scan["mask"][0]
                # the oldest pose retires at the depth bound, and before it
                # where no scan is waiting to be dispatched or its copy is
                # done: holding a pose that is on the host gains nothing
                while pending and (len(pending) >= self.pipeline_depth
                                   or not source.waiting()
                                   or on_host(pending[0])):
                    retired_early += len(pending) < self.pipeline_depth
                    retire(pending.popleft())
                n_scans += 1
                f = source.get()
            while pending:
                retire(pending.popleft())
            wall = time.perf_counter() - t_start
        self.final_state = carry[0][0]

        lat = np.asarray(self.latencies_ms[-n_scans:])
        times = self.timings[-n_scans:]
        disp = np.asarray([(r.dispatched - r.pickup) * 1e3 for r in times])
        held = np.asarray([r.held * 1e3 for r in times])
        return dict(
            n_scans=n_scans,
            hz=n_scans / wall,
            # completion latency: arrival -> pose on the host; at depth > 1
            # it includes the wait behind the scans queued before
            latency_ms_mean=float(lat.mean()),
            latency_ms_p95=float(np.percentile(lat, 95)),
            # the host time of one step's call: the cadence floor
            dispatch_ms_mean=float(disp.mean()),
            dispatch_ms_p95=float(np.percentile(disp, 95)),
            # a finished pose's wait in the FIFO: at depth > 1, behind the
            # dispatch of a scan that was already waiting, where the copy
            # was not done when that scan was taken
            held_ms_mean=float(held.mean()),
            held_ms_p95=float(np.percentile(held, 95)),
            # poses retired before the depth bound and the final drain: no
            # scan was waiting, or the copy was done
            retired_early=retired_early,
            pipeline_depth=self.pipeline_depth,
            n_loops=int(self.final_state.map_state.n_loops_total),
        )

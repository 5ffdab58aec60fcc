"""Closed loop, offline: drives run back to back through
``engine/fused.py::run_sequence_fused``, each with a fresh state and its
own sequence box, until the window has passed; every pose is on the host
when a drive returns.

The mix gives the drive's length (``n_frames``), the pool of drives made
from the seed (``pool``, run in turn), the generator's ``noise``,
``n_moving`` and ``radius``, and the ego's advance per scan (``speeds``,
metres, taken in turn; the same for every seed).

Set-up ends with ``gc.freeze()``: what it built (the traffic, the model)
is left out of later collections. The window logs each drive's seconds
on standard error.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from portbench import program, trace
from portbench.gen.seeds import sub_seed
from portbench.gen.synthetic import generate_sequence, speed_profile
from portbench.reference import compare
from portbench.work import network


def make_drives(config: dict, mix: dict, seed: int) -> list:
    n = config["flownet"]["npoint"]
    traj = speed_profile(mix["speeds"], mix["n_frames"])
    return [generate_sequence(n_frames=mix["n_frames"], n_points=n,
                              seed=sub_seed(seed, d), noise=mix["noise"],
                              n_moving=mix["n_moving"], radius=mix["radius"],
                              trajectory=traj)
            for d in range(mix["pool"])]


def settle(device) -> None:
    """The end of set-up: the device idle, what set-up built frozen out of
    the collector's later passes."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()


def valid_of(frames: list, n: int) -> np.ndarray:
    """[F, N]: the real points of each pair's first cloud (frame k-1)."""
    return np.stack([frames[max(k - 1, 0)]["mask1"][:n].astype(bool)
                     for k in range(len(frames))])


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.device = config, mix, device
        self.n = config["flownet"]["npoint"]
        self.drives = make_drives(config, mix, seed)
        self.model = program.load_tflow(config, device)
        self.cfg = program.pipeline_config(config)
        self.done = []  # (pool index, outputs)
        self.rng = np.random.default_rng(sub_seed(seed, 11))
        # warm-up: a short drive through the same entry builds and loads
        # every kernel and shape a drive uses
        self.drive(0, self.drives[0][:3])
        self.done.clear()
        settle(device)

    def drive(self, d: int, frames=None) -> int:
        from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

        frames = self.drives[d] if frames is None else frames
        out = run_sequence_fused(self.model, frames, self.cfg,
                                 device=self.device)
        self.done.append((d, out))
        return len(frames)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        scans, i, times = 0, 0, []
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            scans += self.drive(i % len(self.drives))
            times.append(time.perf_counter() - t)
            i += 1
        dt = time.perf_counter() - t0
        print("drive s: " + " ".join(f"{x:.3f}" for x in times),
              file=sys.stderr)
        return dict(scans_per_s=scans / dt, attempted=scans)

    def traced(self, spans: trace.Spans, seconds: float) -> dict:
        """One drive under the profiler (``seconds`` is not used)."""
        import ssf_slam_tpu_torch.engine.fused as fused

        targets = [(self.model, "tower", "tower"),
                   (self.model, "head", "head"),
                   (fused, "slam_step", "slam_step")]
        with trace.wrapped(spans, targets):
            units, tr = trace.profile(lambda: self.drive(0))
        return dict(ctx=trace.Context(tr, units,
                                      network.serve_scan(self.config)),
                    attempted=units)

    def release(self) -> None:
        import torch

        self.model = None
        gc.unfreeze()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def program_outputs(out: dict) -> dict:
        got = dict(out)
        got["seg"] = out["flow"][..., 3]
        got["static"] = got["seg"] < 0.0
        return got

    def boxed(self, d: int):
        """Pool drive ``d``'s frames and its sequence box, as the program's
        ``run_sequence_fused`` makes it."""
        from portbench.reference.plain.engine.fused import sequence_box

        frames = self.drives[d]
        return frames, sequence_box(
            np.stack([f["pos1"][:self.n] for f in frames]),
            device=self.device)

    def compare(self, quant=None) -> list:
        """``compare.drive_numbers`` of a sample of the window's drives,
        drawn from the seed; with ``quant``, of the control's run of each
        pool drive."""
        if quant is not None:
            items = [self.boxed(d) for d in range(len(self.drives))]
            return judge(self.config, self.device,
                         control_runs(self.config, self.device, quant,
                                      items), items, self.n)
        picked = sample(self.rng, [len(out["pose_t"])
                                   for _, out in self.done])
        items = [self.boxed(self.done[i][0]) for i in picked]
        got = [self.program_outputs(self.done[i][1]) for i in picked]
        return judge(self.config, self.device, got, items, self.n)


SAMPLE = 2  # drives of a window that the reference runs again


def sample(rng, lengths: list) -> list:
    """Up to ``SAMPLE`` indices of ``lengths`` drawn by ``rng``, the
    longest drive always among them."""
    if not lengths:
        return []
    first = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != first]
    more = rng.choice(rest, size=min(SAMPLE - 1, len(rest)),
                      replace=False).tolist() if rest else []
    return [first, *more]


def control_runs(config: dict, device, quant: str, items: list) -> list:
    """The control in the program's place over ``items`` ((frames, box)):
    with ``quant`` "fp8" the reference network through fp8, with "tf32"
    the reference SLAM step's float32 products in TF32."""
    from portbench.reference import build
    from portbench.reference.plain.engine.fused import run_drive

    net = "fp8" if quant == "fp8" else None
    model = build.load_tflow(config, device, net)
    cfg = build.pipeline_config(config)
    return [run_drive(model, frames, cfg, box, device,
                      tf32=quant == "tf32") for frames, box in items]


def judge(config: dict, device, got: list, items: list, n: int) -> list:
    """``compare.drive_numbers`` of each judged run against the
    reference's run of the same (frames, box), given the judged run's
    flow and mask."""
    from portbench.reference import build
    from portbench.reference.plain.engine.fused import run_drive

    model = build.load_tflow(config, device)
    cfg = build.pipeline_config(config)
    out = []
    for g, (frames, box) in zip(got, items):
        want = run_drive(model, frames[:len(g["pose_t"])], cfg, box, device,
                         given=g)
        out.append(compare.drive_numbers(g, want,
                                         valid_of(frames[:len(g["pose_t"])],
                                                  n)))
    return out

"""Small cells for the CPU tests: the committed configurations and mixes
cut to 1024 points and a few scans, so that a run holds in seconds."""

from __future__ import annotations

import copy

from portbench import harness

SMALL_NET = dict(npoint=1024, sa_npoints=[512, 256, 128, 64])
SMALL_MIX = dict(n_frames=3, pool=1, rate_hz=4.0)


def small(cell: str) -> dict:
    """``harness.resolve(cell)`` with the configuration and the mix cut."""
    spec = copy.deepcopy(harness.resolve(cell))
    spec["config"]["flownet"].update(SMALL_NET)
    for key, value in SMALL_MIX.items():
        if key in spec["mix"]:
            spec["mix"][key] = value
    return spec


def small_cell(cell: str, seed: int = 3, device=None):
    """The cut cell's loop object (on the CPU unless ``device``), after
    its set-up."""
    import torch

    spec = small(cell)
    loop = harness.loop_module(spec["mix"])
    return spec, loop.Cell(spec["config"], spec["mix"], seed,
                           device or torch.device("cpu"))

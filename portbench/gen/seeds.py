"""Seeds of the parts of a run, drawn from the run's ``--seed``."""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed for part ``keys`` of the run of ``seed`` (any whole
    number)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, *keys])
               .generate_state(1)[0])

"""Faults planted in the program underneath the harness, by name: each a
function of a ``monkeypatch``-like object (``setattr(owner, name,
value)``) that breaks one thing where it is produced. The tests plant
them on small cells on the CPU and see ``correct`` come out false;
``control.py --fault`` plants one on the card for its readings.

- state_unchanged: the SLAM step hands back the state it was given;
- flow_altered: the head's finest flow comes out 5 cm off;
- stale_tower: a drive's first scan pairs with the tower cached at the
  end of the drive before (of the warm-up, for the first), not with the
  tower of its own first cloud: one scan of a drive is wrong.
"""

from __future__ import annotations


def state_unchanged(mp) -> None:
    import ssf_slam_tpu_torch.engine.fused as fused

    orig = fused.slam_step
    mp.setattr(fused, "slam_step",
               lambda state, scan, cfg: (state, orig(state, scan, cfg)[1]))


def flow_altered(mp) -> None:
    from ssf_slam_tpu_torch.models.tflow import TFlow

    orig = TFlow.head

    def head(self, *args, **kwargs):
        flows, idx = orig(self, *args, **kwargs)
        bumped = flows[0].clone()
        bumped[..., :3] += 0.05
        return [bumped, *flows[1:]], idx

    mp.setattr(TFlow, "head", head)


def stale_tower(mp) -> None:
    import ssf_slam_tpu_torch.engine.fused as fused
    import ssf_slam_tpu_torch.engine.streaming as streaming

    orig = fused.make_fused_step
    last = {}

    def make(*args, **kwargs):
        step, make_carry = orig(*args, **kwargs)

        def stepped(carry, scan):
            carry, outs = step(carry, scan)
            last["tower"] = carry[1]
            return carry, outs

        def carried(first_prev):
            states, tower = make_carry(first_prev)
            return states, last.get("tower", tower)

        return stepped, carried

    mp.setattr(fused, "make_fused_step", make)
    mp.setattr(streaming, "make_fused_step", make)


ALL = {"state_unchanged": state_unchanged, "flow_altered": flow_altered,
       "stale_tower": stale_tower}


class Planter:
    """A minimal ``monkeypatch`` for the command line: ``setattr`` that
    ``undo`` reverses."""

    def __init__(self):
        self._undo = []

    def setattr(self, owner, name, value) -> None:
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()

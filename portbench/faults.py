"""Faults planted in the program underneath the timed path, for the
check's rehearsals (`tests/test_portbench_rehearsal.py` on the CPU,
`readings.py --fault` on the card): with any of them a run's `correct`
must come out false.

  * rolled_manager: every patch's probabilities moved one expert over;
  * manager_to_expert_0: every patch sent to expert 0, with probability 1;
  * altered_normals: each normal moved by half its length where the
    expert (or the multi-scale network) produces it.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("rolled_manager", "manager_to_expert_0", "altered_normals")


def _manager(fault: str, inner):
    def broken(self, grid, *a, **k):
        probs = inner(self, grid, *a, **k)  # [E, B]
        if fault == "rolled_manager":
            return torch.roll(probs, 1, dims=0)
        one = torch.zeros_like(probs)
        one[0] = 1.0
        return one

    return broken


def _expert(inner):
    def broken(self, i, grid, *a, **k):
        out = inner(self, i, grid, *a, **k)
        return out + 0.5 * out.norm(dim=1, keepdim=True)

    return broken


def _single(inner):
    def broken(self, grid, *a, **k):
        out = inner(self, grid, *a, **k)
        n = out["n_pred"]
        return out | {"n_pred": n + 0.5 * n.norm(dim=1, keepdim=True)}

    return broken


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted (none when `fault` is None)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    from nestinet_tpu_torch.models.base import SingleNetNormEst
    from nestinet_tpu_torch.models.experts import ExpertsNormEst

    if fault == "altered_normals":
        swaps = [(ExpertsNormEst, "expert_on_grid", _expert),
                 (SingleNetNormEst, "forward_grid", _single)]
    else:
        swaps = [(ExpertsNormEst, "manager_probs", lambda f: _manager(fault, f))]
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in swaps]
    for cls, name, make in swaps:
        setattr(cls, name, make(getattr(cls, name)))
    try:
        yield
    finally:
        for cls, name, inner in saved:
            setattr(cls, name, inner)

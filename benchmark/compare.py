"""The comparisons that decide `correct`: each turns the program's outputs
and the plain reference's into one number that has a limit of its own
(`benchmark/limits/<workload>.json`)."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch


def rel_gap(value: float, ref: float, floor: float = 0.0) -> float:
    """|value - ref| / max(|ref|, floor); a non-finite value reads inf."""
    if not (value == value) or abs(value) == float("inf"):
        return float("inf")
    return abs(value - ref) / max(abs(ref), floor, 1e-30)


def worst_leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                        leaves: Optional[Iterable[str]] = None) -> float:
    """The largest, over leaves, of the gap between the program's norm of a
    leaf and the reference's, against the larger of that leaf's reference
    norm and the median leaf's."""
    names = list(leaves if leaves is not None else ref)
    ref_norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    median = statistics.median(ref_norms.values())
    worst = 0.0
    for k in names:
        p = float(torch.linalg.vector_norm(prog[k].double()))
        worst = max(worst, rel_gap(p, ref_norms[k], median))
    return worst


def moving_leaves(grads: Dict[str, torch.Tensor], share: float = 1e-3):
    """Leaves whose reference gradient is more than `share` of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n > share * median]


def median_member_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                      leaves: Iterable[str]) -> float:
    """For leaves stacked over K independent members (a leading [K] axis):
    `worst_leaf_norm_gap` of each member's own slices, then the median
    member's."""
    names = list(leaves)
    k = ref[names[0]].shape[0]
    gaps = [worst_leaf_norm_gap({n: prog[n][i] for n in names}, {n: ref[n][i] for n in names})
            for i in range(k)]
    return statistics.median(gaps)

"""The comparison that decides `correct` for a train cell: the run under
test against the plain reference, over the first three steps from the
same weights, batches and draws, and over one step of the window from the
run's own state before it. The numbers (limits/<cell>.json gives each its
limit):

  grad_gap           the first gradient as the optimizer holds it (its
                     momentum trace after one step), leaf by leaf: the gap
                     between the two norms, over the reference's norm of
                     that leaf or of the median leaf, whichever is larger;
                     the worst leaf
  change_gap         the same of each leaf's change after the first step,
                     over the leaves that move (MOVED_SHARE)
  rpn_l2             the start: step 1's objectness logits and box
                     encodings, the relative L2 norm of the difference (the
                     worse of the two outputs)
  proposal_mismatch  the stage that the reference takes from the run (top-
                     k, NMS, the proposal sampler): proposals that the
                     reference's selection, run on the run's own RPN
                     outputs, does not reproduce exactly, over the three
                     steps and the window's step
  window_rpn_l2      rpn_l2 of the window's step
  window_loss_gap    the window step's loss terms: the widest gap over the
                     terms, as a share of the reference's total loss
  window_change_gap  change_gap of the window's step
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# every number worked out, in the order of the docstring
NUMBERS = ("grad_gap", "change_gap", "rpn_l2", "proposal_mismatch", "window_rpn_l2",
           "window_loss_gap", "window_change_gap")
# the leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone: they are left out of the change gaps
MOVED_SHARE = 1e-3


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names) -> np.ndarray:
    ref = np.array([want[n] for n in names])
    floor = np.maximum(ref, np.median(ref))
    return np.abs(np.array([got[n] for n in names]) - ref) / np.maximum(floor, 1e-30)


def moved(grad_norms: Dict[str, float]) -> List[str]:
    g = np.array(list(grad_norms.values()))
    return sorted(n for n, v in grad_norms.items() if v >= MOVED_SHARE * np.median(g))


def loss_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    scale = max(abs(want["total_loss"]), 1e-30)
    return max(abs(got.get(k, float("nan")) - v) / scale for k, v in want.items())


def numbers(run: Dict, ref: Dict) -> Dict[str, float]:
    """run: {'grad_norms', 'change_first': {leaf: float}, 'window':
    {'terms', 'change_norms'}}; ref: follow()'s."""
    w, rw = run["window"], ref["window"]
    out = {"grad_gap": leaf_gaps(run["grad_norms"], ref["grad_norms"],
                                 sorted(ref["grad_norms"])).max(),
           "change_gap": leaf_gaps(run["change_first"], ref["change_first"],
                                   moved(ref["grad_norms"])).max(),
           "rpn_l2": ref["rpn_l2"],
           "proposal_mismatch": ref["proposal_mismatch"] + rw["proposal_mismatch"],
           "window_rpn_l2": rw["rpn_l2"],
           "window_loss_gap": loss_gap(w["terms"], rw["terms"]),
           "window_change_gap": leaf_gaps(w["change_norms"], rw["change_norms"],
                                          moved(rw["grad_norms"])).max()}
    return {k: (float(v) if np.isfinite(v) else float("inf")) for k, v in out.items()}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that `limits` names within its limit."""
    return all(values[k] <= lim for k, lim in limits.items())


def lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """The numbers compared, each beside its limit, for standard error."""
    return [f"compared {k} {values[k]!r} limit {lim!r} {'ok' if values[k] <= lim else 'FAILED'}"
            for k, lim in limits.items()]

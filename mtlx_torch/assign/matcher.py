"""Matching of anchors (columns) to ground truth (rows) from a similarity
matrix (port of mtlx/assign/matcher.py): the thresholded argmax matcher
and the greedy bipartite matcher.

A match vector holds, per column: >= 0 the matched row, -1 unmatched
(negative), -2 ignored (between the thresholds). Padded rows
(`row_mask` False) never match; a problem without valid rows is all
unmatched. Every function takes leading batch dims (mtlx's vmap written
out). Selections equal mtlx's exactly: `torch.argmax` takes the first
maximum as `jnp.argmax` does, and a column claimed by several rows in
force-matching goes to the lowest row, and the greedy bipartite matcher
takes the first flat argmax of the (row, column) pairs left.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import Tensor

UNMATCHED = -1
IGNORED = -2

_NEG = -1e9


def argmax_match(
    similarity: Tensor,
    row_mask: Optional[Tensor] = None,
    matched_threshold: float = 0.5,
    unmatched_threshold: float = 0.5,
    force_match_for_each_row: bool = True,
    negatives_lower_than_unmatched: bool = True,
) -> Tensor:
    """Thresholded argmax matching. similarity [..., R, C], row_mask
    [..., R] bool -> [..., C] int32 match vector. Below the unmatched
    threshold a column is unmatched and between the thresholds ignored
    (the other way round without negatives_lower_than_unmatched). With
    force_match_for_each_row every valid row captures its own best
    column, overriding the thresholds."""
    if matched_threshold < unmatched_threshold:
        raise ValueError("matched_threshold must be >= unmatched_threshold")
    sim = similarity
    if row_mask is not None:
        sim = torch.where(row_mask[..., :, None], sim, _NEG)
    num_rows = sim.shape[-2]

    best_row = torch.argmax(sim, dim=-2)  # [..., C], the first maximum
    best_val = torch.amax(sim, dim=-2)
    below = best_val < unmatched_threshold
    between = (best_val >= unmatched_threshold) & (best_val < matched_threshold)
    below_label, between_label = ((UNMATCHED, IGNORED) if negatives_lower_than_unmatched
                                  else (IGNORED, UNMATCHED))
    matches = torch.where(below, below_label, best_row)
    matches = torch.where(between, between_label, matches)

    if force_match_for_each_row and num_rows > 0:
        col_of_row = torch.argmax(sim, dim=-1)  # [..., R]
        # a row claims only with a valid mask and a real similarity row
        claims = torch.amax(sim, dim=-1) > _NEG / 2
        if row_mask is not None:
            claims = claims & row_mask
        rows = torch.arange(num_rows, device=sim.device).expand_as(col_of_row)
        # the lowest claiming row wins a column (mtlx: argmax over the
        # one-hot claims); num_rows marks an unclaimed column
        claiming = torch.full_like(matches, num_rows).scatter_reduce(
            -1, col_of_row, torch.where(claims, rows, num_rows), reduce="amin"
        )
        matches = torch.where(claiming < num_rows, claiming, matches)
    return matches.to(torch.int32)


def greedy_bipartite_match(similarity: Tensor, row_mask: Optional[Tensor] = None,
                           col_mask: Optional[Tensor] = None) -> Tensor:
    """Greedy bipartite matching (tf.image.bipartite_match is greedy, not
    Hungarian): R times, the best (row, column) pair left (the first in
    row-major order among equals) matches and leaves the game with its row
    and column, until no real pair is left. Masked rows and columns never
    match. similarity [..., R, C], row_mask [..., R], col_mask [..., C] ->
    [..., C] int32, the matched row or -1. It syncs nothing with the host:
    every problem takes all R rounds."""
    sim = similarity
    if row_mask is not None:
        sim = torch.where(row_mask[..., :, None], sim, _NEG)
    if col_mask is not None:
        sim = torch.where(col_mask[..., None, :], sim, _NEG)
    *lead, num_rows, num_cols = sim.shape
    s = sim.reshape(-1, num_rows, num_cols)
    n = s.shape[0]
    dev = s.device
    rows = torch.arange(num_rows, device=dev)[None, :, None]
    cols = torch.arange(num_cols, device=dev)[None, None, :]
    problems = torch.arange(n, device=dev)
    matches = torch.full((n, num_cols), UNMATCHED, dtype=torch.int32, device=dev)
    for _ in range(num_rows):
        flat = torch.argmax(s.reshape(n, -1), dim=-1)  # the first maximum
        r, c = flat // num_cols, flat % num_cols
        valid = s[problems, r, c] > _NEG / 2
        hit = valid[:, None] & (cols[:, 0] == c[:, None])
        matches = torch.where(hit, r[:, None].to(torch.int32), matches)
        gone = valid[:, None, None] & ((rows == r[:, None, None]) | (cols == c[:, None, None]))
        s = torch.where(gone, _NEG, s)
    return matches.reshape(*lead, num_cols)


def matched_column_mask(match: Tensor) -> Tensor:
    return match >= 0


def unmatched_column_mask(match: Tensor) -> Tensor:
    return match == UNMATCHED


def ignored_column_mask(match: Tensor) -> Tensor:
    return match == IGNORED


def take_rows(x: Tensor, index: Tensor) -> Tensor:
    """x [..., G, *tail] gathered at index [..., C] along G ->
    [..., C, *tail] (jnp.take per problem)."""
    tail = x.shape[index.dim():]
    ix = index.long().reshape(*index.shape, *(1,) * len(tail)).expand(*index.shape, *tail)
    return torch.gather(x, index.dim() - 1, ix)


def gather_based_on_match(match: Tensor, gathered: Tensor, unmatched_value: Tensor) -> Tensor:
    """Per column, gathered[match] when matched, else unmatched_value
    (for unmatched and ignored columns alike). match [..., C], gathered
    [..., G, *tail]."""
    safe = torch.clamp(match, 0, gathered.shape[match.dim() - 1] - 1)
    picked = take_rows(gathered, safe)
    expand = (...,) + (None,) * (picked.dim() - match.dim())
    return torch.where((match >= 0)[expand], picked, unmatched_value.to(picked.dtype))


def make_argmax_matcher(matched_threshold: float, unmatched_threshold: Optional[float] = None,
                        force_match_for_each_row: bool = False,
                        negatives_lower_than_unmatched: bool = True):
    """argmax_match with these settings; the unmatched threshold defaults
    to the matched one."""
    if unmatched_threshold is None:
        unmatched_threshold = matched_threshold
    return partial(
        argmax_match,
        matched_threshold=matched_threshold,
        unmatched_threshold=unmatched_threshold,
        force_match_for_each_row=force_match_for_each_row,
        negatives_lower_than_unmatched=negatives_lower_than_unmatched,
    )

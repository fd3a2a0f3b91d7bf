"""Compute bucket granularity (port of mtlx/utils/bucketing.py).

A batch computes on its largest true image extent rounded up to a
multiple of the bucket granularity (128 by default, the pipeline proto's
`bucketing.bucket_multiple`), capped at the model canvas. The granularity
is passed explicitly: the port keeps no process-wide setting.
"""

from typing import Tuple

DEFAULT_BUCKET_MULTIPLE = 128


def bucket_multiple(configured: int = 0) -> int:
    """The bucket granularity in pixels: `configured` (a pipeline's
    `bucketing.bucket_multiple`) or the default. It must be a positive
    multiple of 32 so every backbone stride divides it."""
    multiple = int(configured) or DEFAULT_BUCKET_MULTIPLE
    if multiple <= 0 or multiple % 32:
        raise ValueError(
            f"bucket_multiple must be a positive multiple of 32, got {multiple}"
        )
    return multiple


def bucket_extent(extent: int, cap: int, multiple: int = DEFAULT_BUCKET_MULTIPLE) -> int:
    """`extent` rounded up to the bucket granularity, capped at the
    canvas extent."""
    return min(int(cap), -(-int(extent) // multiple) * multiple)


def bucket_multiple_arg(value: str) -> int:
    """argparse `type=` for the CLIs' --bucket_multiple (0 = unset: the
    pipeline's `bucketing {}` block decides)."""
    import argparse

    v = int(value)
    if v and (v < 0 or v % 32):
        raise argparse.ArgumentTypeError(f"must be a positive multiple of 32, got {value}")
    return v


def resolve_bucketing(bucketing_config=None, bucket_multiple_flag: int = 0,
                      max_bucket_variants_flag: int = 0) -> Tuple[int, int]:
    """(bucket granularity, bound on the bucket variants) of one CLI run:
    each the flag, else the pipeline's `bucketing {}` block, else the
    default (128; no bound)."""
    cfg_mult = cfg_variants = 0
    if bucketing_config is not None:
        cfg_mult = int(bucketing_config.bucket_multiple)
        cfg_variants = int(bucketing_config.max_bucket_variants)
    return (bucket_multiple(int(bucket_multiple_flag) or cfg_mult),
            int(max_bucket_variants_flag) or cfg_variants)

"""Compute bucket granularity for serving (port of mtlx/utils/bucketing.py).

A served batch runs on its largest true image extent rounded up to a
multiple of the bucket granularity (128 by default, the pipeline proto's
`bucketing.bucket_multiple`), capped at the model canvas. The granularity
is passed explicitly: the port keeps no process-wide setting.
"""

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

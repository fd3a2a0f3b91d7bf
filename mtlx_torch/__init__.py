"""mtlx_torch — the PyTorch + CUDA port of `mtlx` for NVIDIA Hopper.

The package mirrors `mtlx/`'s layout and names (`mtlx_torch/geometry/box_ops.py`
ports `mtlx/geometry/box_ops.py`, and so on) and imports nothing of it:
`mtlx` stays the JAX reference that the tests hold this package against.

Public functions keep `mtlx`'s layouts: NHWC images and features,
`[ymin, xmin, ymax, xmax]` boxes, the same padded output shapes. Entry
points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`); on the card the NMS and ROI-crop kernels are CUDA C++
built from `mtlx_torch/kernels/csrc` at first use.
"""

from mtlx_torch.device import resolve_device

__all__ = ["resolve_device"]

"""SSD's multi-resolution feature maps (port of
mtlx/backbones/feature_maps.py): the backbone's endpoints, then stride-2
extra maps, each an optional 1x1 conv at half depth and a 3x3 stride-2
SAME conv, both with bias and ReLU; every depth through depth_fn(d) =
max(int(d * depth_multiplier), min_depth). The extras are named
`extra{n}_1x1` / `extra{n}_3x3` by their count, as in mtlx. NHWC in and
out."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.mobilenet import SameConv2d
from mtlx_torch.backbones.resnet import _nchw, _nhwc
from mtlx_torch.layers import Conv2d

# the extras' depths of the reference layouts, after two backbone endpoints
SSD_EXTRA_DEPTHS = (512, 256, 256, 128, 128, 128)


def ssd_layer_depths(num_layers: int, num_endpoints: int = 2) -> List[int]:
    """An SSD pyramid's layout: -1 takes the next backbone endpoint, a
    positive entry is the layer_depth of a new stride-2 extra map."""
    extras = list(SSD_EXTRA_DEPTHS[: max(0, num_layers - num_endpoints)])
    return [-1] * min(num_endpoints, num_layers) + extras


class MultiResolutionFeatureMaps(nn.Module):
    """[endpoints, NHWC] -> the pyramid's maps, NHWC. `endpoint_channels`
    are the backbone endpoints' widths."""

    def __init__(self, endpoint_channels: Sequence[int], layer_depths: Sequence[int],
                 depth_multiplier: float = 1.0, min_depth: int = 16,
                 insert_1x1_conv: bool = True, conv_kernel_size: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        depth_fn = lambda d: max(int(d * depth_multiplier), min_depth)
        self.layer_depths = tuple(layer_depths)
        self.insert_1x1_conv = insert_1x1_conv
        self.dtype = dtype
        self.out_channels: List[int] = []
        next_endpoint = num_extra = 0
        k = conv_kernel_size
        for layer_depth in self.layer_depths:
            if layer_depth < 0:
                if next_endpoint >= len(endpoint_channels):
                    raise ValueError(
                        f"layout {self.layer_depths} wants endpoint {next_endpoint} but the "
                        f"backbone provides {len(endpoint_channels)}")
                self.out_channels.append(endpoint_channels[next_endpoint])
                next_endpoint += 1
                continue
            if not self.out_channels:
                raise ValueError("layout must start from a backbone endpoint")
            c = self.out_channels[-1]
            if insert_1x1_conv:
                self.add_module(f"extra{num_extra}_1x1",
                                Conv2d(c, depth_fn(layer_depth // 2), 1, compute_dtype=dtype))
                c = depth_fn(layer_depth // 2)
            self.add_module(f"extra{num_extra}_3x3",
                            SameConv2d(c, depth_fn(layer_depth), k, 2, compute_dtype=dtype))
            self.out_channels.append(depth_fn(layer_depth))
            num_extra += 1

    def forward(self, endpoints: List[Tensor]) -> List[Tensor]:
        out: List[Tensor] = []
        next_endpoint = num_extra = 0
        for layer_depth in self.layer_depths:
            if layer_depth < 0:
                out.append(endpoints[next_endpoint])
                next_endpoint += 1
                continue
            x = _nchw(out[-1].to(self.dtype))
            if self.insert_1x1_conv:
                x = F.relu(getattr(self, f"extra{num_extra}_1x1")(x))
            x = F.relu(getattr(self, f"extra{num_extra}_3x3")(x))
            out.append(_nhwc(x))
            num_extra += 1
        return out

"""The reference's train steps: momentum SGD with clip-by-global-norm, as
mtlx_torch/train/train_step.py's optimizer computes it (optax's chain:
clip, trace = g + momentum * trace, update = -lr * trace), on the whole
batch's gradients accumulated over blocks of images, in float32 with
TF32 off."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .detector import Config, Detector, random_horizontal_flip


def learning_rate(schedule: Dict, count: int) -> float:
    """The manual step schedule: the initial rate, then each step's rate
    from that step on (`optimizer.learning_rate` of a config file)."""
    lr = schedule["initial"]
    for step, rate in schedule.get("steps", []):
        if count >= step:
            lr = rate
    return float(np.float32(lr))


class ReferenceRun:
    """Follows the run under test through its first steps from the same
    weights and inputs (and a later step from the run's own state,
    `load`); `grad_norms` are the last step's clipped gradients' norms,
    leaf by leaf. `quantize` rounds every product's operands (the
    control, `layers.set_quantize`)."""

    def __init__(self, model_cfg: Dict, optimizer: Dict, state: Dict[str, torch.Tensor],
                 device, block: int = 4):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = Config.from_dict(model_cfg)
        self.opt = optimizer
        self.net = Detector(self.cfg).to(device)
        self.net.load_state_dict(state)
        self.block = block
        self.names = [n for n, _ in self.net.named_parameters()]
        self.trace: Optional[List[torch.Tensor]] = None
        self.count = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())

    @torch.no_grad()
    def load(self, params: Dict[str, torch.Tensor], trace: Dict[str, torch.Tensor],
             count: int) -> None:
        """Continue from another run's state: its parameters, momentum
        trace and step count (the batch-norm statistics stay this run's)."""
        mine = self.params()
        for n in self.names:
            mine[n].copy_(params[n])
        self.trace = [trace[n].to(mine[n].device, torch.float32) for n in self.names]
        self.count = count

    def step(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
             proposals: Optional[torch.Tensor] = None,
             proposal_mask: Optional[torch.Tensor] = None) -> Dict:
        """One step on `batch` with the run's `draws` and the run's sampled
        proposals (None: its own, from its own RPN outputs, as a stand-in
        for the run); returns the loss terms, the objectness logits and
        box encodings of the RPN, the sampled proposals and the flipped
        ground truth."""
        net, b = self.net, batch["image"].shape[0]
        images, boxes = random_horizontal_flip(batch["image"].float(), batch["gt_boxes"].float(),
                                               batch["true_shape"], draws["aug_0"])
        gt = {"boxes": boxes, "classes": batch["gt_classes"].long(),
              "mask": batch["gt_mask"].bool()}
        counts = net.label_counts(gt)
        for p in net.parameters():
            p.grad = None
        terms: Dict[str, float] = {}
        objs, encs, props, masks = [], [], [], []
        for lo in range(0, b, self.block):
            rows = slice(lo, lo + self.block)
            feats, obj, enc = net.rpn_outputs(images[rows])
            block_gt = {k: v[rows] for k, v in gt.items()}
            if proposals is None:
                p, m = net.sampled_proposals(
                    obj.detach(), enc.detach(), batch["true_shape"][rows], block_gt["boxes"],
                    block_gt["mask"], tuple(images.shape[1:3]), draws["proposal_pos"][rows],
                    draws["proposal_neg"][rows])
            else:
                p, m = proposals[rows], proposal_mask[rows]
            props.append(p)
            masks.append(m)
            part = net.losses(feats, obj, enc, block_gt,
                              (draws["anchor_pos"][rows], draws["anchor_neg"][rows]),
                              p, m, b, counts)
            sum(part.values()).backward()
            for k, v in part.items():
                terms[k] = terms.get(k, 0.0) + float(v.detach())
            objs.append(obj.detach())
            encs.append(enc.detach())
        terms["total_loss"] = sum(v for k, v in terms.items() if k.startswith("Loss/"))
        self._update()
        return {"terms": terms, "obj": torch.cat(objs), "enc": torch.cat(encs), "gt": gt,
                "sampled": (torch.cat(props), torch.cat(masks))}

    @torch.no_grad()
    def _update(self) -> None:
        params = self.params()
        g = [params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])
             for n in self.names]
        norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        self.global_norm = float(norm)
        clip = self.opt["gradient_clipping_by_norm"]
        if clip > 0 and not bool(norm < clip):
            g = torch._foreach_mul(torch._foreach_div(g, norm), clip)
        self.grad_norms = dict(zip(self.names, torch.stack(torch._foreach_norm(g)).tolist()))
        if self.trace is None:
            self.trace = [torch.zeros_like(x) for x in g]
        self.trace = torch._foreach_mul(self.trace, self.opt["momentum"])
        torch._foreach_add_(self.trace, g)
        lr = learning_rate(self.opt["learning_rate"], self.count)
        torch._foreach_add_([params[n] for n in self.names],
                            torch._foreach_mul(self.trace, -lr))
        self.count += 1

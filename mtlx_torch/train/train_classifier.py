"""Classification pretraining CLI (port of mtlx/train/train_classifier.py;
slim's train_image_classifier): the path that makes the ImageNet-style
warm starts a detector's fine_tune_checkpoint reads.

  python -m mtlx_torch.train.train_classifier --model resnet50 \
      --train_record /data/imagenet_train.record --num_classes 1000 \
      --train_dir /ckpt/r50_cls [--image_size 224] [--batch_size 64] \
      [--export_backbone /ckpt/r50_cls/backbone.pt] [--device cpu]

It runs on the CUDA device unless `--device cpu` is passed.

Input: TFRecords of Examples with `image/encoded` and
`image/class/label` (slim's dataset schema). Each step samples
`batch_size` records with replacement (`np.random.RandomState(0)`, as
mtlx), parses them with the port's Example reader and decodes and
resizes them as mtlx does: PIL's `convert("RGB")` and `resize((s, s),
BILINEAR)`. PIL is the reference semantics of this path (mtlx decodes
with it too); it is imported only here.

The networks (`--model`): ResNetClassifier of depth 50 / 101 / 152 with
mtlx's preprocessing (the ImageNet means subtracted), and
MobileNetV1Classifier (x * 2 / 255 - 1); both train with live batch
norm, in bfloat16 compute with float32 parameters. The weights are drawn
on the CPU from a seeded generator with flax's default initializers
(lecun_normal kernels, zero biases, batch norm at 1 / 0 / 0 / 1; seed 0,
as mtlx's PRNGKey(0)), then moved to the device.

One step, as mtlx's: the mean softmax cross-entropy of the integer
labels, its gradients clipped by global norm 10, SGD with momentum 0.9
on a cosine decay of the learning rate to 0 over `num_steps`
(optax.cosine_decay_schedule), then the live batch norms' moving
statistics committed. The port's Optimizer, global_norm and cosine
schedule (train/train_step.py) do it.

Output: `[cls] {"step", "loss", "accuracy", "images_per_sec"}` at step 1
and every `log_every` steps; the `classifier` checkpoint
(`<train_dir>/classifier/ckpt-<num_steps>.pt`, the port's format); with
`--export_backbone` a warm-start checkpoint in which `body` is renamed
`backbone` and `block4` `classifier_backbone.block4` (the detector's
second-stage trunk), which `train/checkpoints.py restore_warm_start`
takes with `from_detection_checkpoint` false. On the card a last line
`[cls] summary {json}` gives each step's milliseconds (CUDA events), the
host's decode milliseconds a batch, the peak device memory and each
hand-written kernel's launches (live batch norm's two).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import Tensor

MODELS = ("resnet50", "resnet101", "resnet152", "mobilenet_v1")
CLIP_NORM = 10.0
MOMENTUM = 0.9


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="resnet50", choices=MODELS)
    p.add_argument("--train_record", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    p.add_argument("--export_backbone", default=None,
                   help="after training, write a detector-warm-startable checkpoint "
                        "(backbone subtree) to this path")
    return p.parse_args(argv)


def mobilenet_preprocess(images: Tensor) -> Tensor:
    return images * (2.0 / 255.0) - 1.0


def build_classifier(model: str, num_classes: int, dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.nn.Module, Callable[[Tensor], Tensor]]:
    """The network of `--model` and its preprocessing."""
    from mtlx_torch.backbones import mobilenet, resnet

    if model not in MODELS:
        raise ValueError(f"unknown classifier {model!r}; choose from {MODELS}")
    if model.startswith("resnet"):
        return (resnet.ResNetClassifier(int(model[6:]), num_classes, dtype=dtype),
                resnet.preprocess_images)
    return mobilenet.MobileNetV1Classifier(num_classes, dtype=dtype), mobilenet_preprocess


def init_weights(net: torch.nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers, drawn from a CPU generator: kernels
    lecun_normal, biases 0, batch norm scale 1, offset 0, mean 0,
    variance 1."""
    from mtlx_torch.detector.faster_rcnn import _init_

    state = {}
    for name, t in net.state_dict().items():
        w = torch.empty(t.shape, dtype=torch.float32)
        if name.endswith("weight"):
            receptive = w[0, 0].numel() if w.dim() == 4 else 1
            _init_(w, None, w.shape[1] * receptive, w.shape[0] * receptive, generator)
        elif name.endswith((".scale", ".var")):
            w.fill_(1.0)
        else:
            w.zero_()
        state[name] = w
    net.load_state_dict(state)


def decode_batch(records, image_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Serialized Examples -> (float32 [B, S, S, 3] RGB images, int64 [B]
    labels), decoded and resized by PIL as mtlx's `_decode_batch`."""
    import io

    from PIL import Image

    from mtlx_torch.data.example_decoder import parse_features

    images, labels = [], []
    for rec in records:
        fmap = parse_features(rec)
        img = Image.open(io.BytesIO(fmap["image/encoded"][1][0])).convert("RGB")
        img = img.resize((image_size, image_size), Image.BILINEAR)
        images.append(np.asarray(img, np.float32))
        labels.append(int(fmap["image/class/label"][1][0]))
    return np.stack(images), np.asarray(labels, np.int64)


def sample_indices(num_records: int, batch_size: int, num_steps: int):
    """Each step's record indices, with replacement, as mtlx draws them."""
    rng = np.random.RandomState(0)
    for _ in range(num_steps):
        yield rng.choice(num_records, batch_size)


def softmax_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """optax.softmax_cross_entropy_with_integer_labels, in its order:
    log(sum(exp(z - max))) - (z - max)[label]."""
    z = logits - logits.amax(dim=-1, keepdim=True).detach()
    label_logits = z.gather(-1, labels[:, None])[:, 0]
    return torch.log(torch.exp(z).sum(dim=-1)) - label_logits


@dataclasses.dataclass
class Classifier:
    """A classification network and its preprocessing, the network under
    `modules` as a detector's (what TrainState and the checkpoint code
    read)."""

    modules: torch.nn.Module
    preprocess: Callable[[Tensor], Tensor]


def make_optimizer(learning_rate: float, num_steps: int):
    """optax.chain(clip_by_global_norm(10), sgd(cosine_decay_schedule(lr,
    num_steps), momentum=0.9)): the cosine decay to 0 is the warm-up +
    cosine schedule without a warm-up."""
    from mtlx_torch.train.train_step import WarmupCosineDecaySchedule
    from mtlx_torch.train.train_step import make_optimizer as momentum_optimizer

    schedule = WarmupCosineDecaySchedule(0.0, learning_rate, 0, num_steps)
    return momentum_optimizer(schedule, MOMENTUM, CLIP_NORM)


def make_classifier_step(model: Classifier):
    """Returns step(state, images, labels) -> (state, loss, accuracy):
    images [B, S, S, 3] 0-255 floats and labels [B] on the model's device;
    the loss and accuracy are device tensors."""
    from mtlx_torch.backbones.resnet import live_batch_norms

    norms = live_batch_norms(model.modules)

    def step(state, images: Tensor, labels: Tensor):
        net = state.model.modules
        net.train()
        params = state.params
        for p in params.values():
            p.grad = None
        logits = net(model.preprocess(images))
        loss = softmax_cross_entropy(logits, labels).mean()
        accuracy = (logits.argmax(dim=-1) == labels).float().mean()
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        updates, opt_state = state.tx.update(grads, state.opt_state)
        with torch.no_grad():
            torch._foreach_add_([params[n] for n in opt_state.names], updates)
            for norm in norms:
                norm.commit()
        return (dataclasses.replace(state, step=state.step + 1, opt_state=opt_state),
                loss.detach(), accuracy.detach())

    return step


# the classifier's subtrees and their names in a detector
EXPORT_RENAMES = (("body.", "backbone."), ("block4.", "classifier_backbone.block4."))


def export_backbone(net: torch.nn.Module, path: str, step: int) -> int:
    """Write the warm-start checkpoint of --export_backbone (module
    docstring); returns the number of tensors written."""
    from mtlx_torch.train.checkpoints import FORMAT

    def renamed(named):
        out = {}
        for name, t in named:
            for old, new in EXPORT_RENAMES:
                if name.startswith(old):
                    out[new + name[len(old):]] = t.detach().to("cpu", copy=True).contiguous()
        return out

    ckpt = {"format": FORMAT, "step": int(step), "params": renamed(net.named_parameters()),
            "buffers": renamed(net.named_buffers())}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(ckpt, path)
    return len(ckpt["params"]) + len(ckpt["buffers"])


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    from mtlx_torch.data import tfrecord
    from mtlx_torch.device import resolve_device
    from mtlx_torch.train.checkpoints import CheckpointManager
    from mtlx_torch.train.train_step import create_train_state

    device = resolve_device(args.device)
    net, preprocess = build_classifier(args.model, args.num_classes)
    init_weights(net, torch.Generator().manual_seed(0))
    net.to(device)
    if device.type == "cuda":
        net.to(memory_format=torch.channels_last)
        torch.cuda.reset_peak_memory_stats(device)
    model = Classifier(net, preprocess)
    state = create_train_state(model, make_optimizer(args.learning_rate, args.num_steps))
    step_fn = make_classifier_step(model)

    offsets = tfrecord.record_index(args.train_record)
    decode_ms, events = [], []
    last = {}
    t0 = time.time()
    with open(args.train_record, "rb") as f:
        for i, idx in enumerate(sample_indices(len(offsets), args.batch_size, args.num_steps)):
            t_decode = time.perf_counter()
            records = [tfrecord.read_record_at(f, offsets[j]) for j in idx]
            images, labels = decode_batch(records, args.image_size)
            decode_ms.append((time.perf_counter() - t_decode) * 1e3)
            images = torch.from_numpy(images).to(device)
            labels = torch.from_numpy(labels).to(device)
            if device.type == "cuda":
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            state, loss, acc = step_fn(state, images, labels)
            if device.type == "cuda":
                events[-1][1].record()
            if (i + 1) % args.log_every == 0 or i == 0:
                last = {"step": i + 1, "loss": round(float(loss), 4),
                        "accuracy": round(float(acc), 4),
                        "images_per_sec": round(args.batch_size * (i + 1) / (time.time() - t0), 1)}
                print("[cls] " + json.dumps(last), flush=True)

    manager = CheckpointManager(os.path.join(args.train_dir, "classifier"))
    manager.save(args.num_steps, state)
    manager.wait()
    if args.export_backbone:
        n = export_backbone(net, args.export_backbone, args.num_steps)
        print(f"[cls] exported backbone warm-start checkpoint to {args.export_backbone} "
              f"({n} tensors)", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        from mtlx_torch.train.train import kernel_launches

        summary = {"device": torch.cuda.get_device_name(device),
                   "step_ms": [s.elapsed_time(e) for s, e in events], "decode_ms": decode_ms,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
                   "kernel_launches": kernel_launches()}
        print("[cls] summary " + json.dumps(summary), flush=True)
    print("[cls] done", flush=True)
    return last


if __name__ == "__main__":
    main()

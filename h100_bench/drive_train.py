"""One run of a train cell: set-up, the measured window, then the
comparison with the reference.

Set-up builds the port's detector, optimizer, augmentations and step
from the configuration's pipeline text through the port's builders (as
the train CLI does), loads the seeded weights, makes the pool of batches
and draws on the card, calibrates the frozen batch norm on the first
batch, and drives that one train state through the pool once with the
window's own call (`step_fn(state, batch, draws=...)`). The first three
of those steps are the ones the reference follows from the seed: their
loss terms, the optimizer's first momentum trace, the parameters' change
after the first step and after the three, and each step's RPN outputs and
sampled proposals (the port's `_proposals` and `_sample_proposals`, read
through instance attributes while those steps run).

Then the window: steps back to back on the pool, no synchronize until it
closes. One of its steps, the first that starts once COMPARED_AT seconds
(or half a shorter window) have passed, is compared too (`_Compared`):
the state before it is copied to pinned host buffers (in the stream's
order, with no synchronize), and its RPN outputs, sampled proposals, loss
terms and the parameters after it are kept. The window lasts at least its
length and until that step has run. With `trace` the window's last
TRACE_SECONDS run under torch.profiler (`_Traced`), with the four
detection kernels' calls read for their bounds.

After the window the port's state is freed; the reference follows the
three set-up steps from the seed, then the compared window step from the
port's own state before it (its parameters, trace and step count, with
the batch-norm statistics the reference calibrated itself)."""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from h100_bench import calibrate, compare, inputs, trace as trace_lib, weights, work

# the traced part of a window: its last seconds
TRACE_SECONDS = 4.0
# the compared window step starts this far into the window (or half
# way, in a shorter one): the same step of a run whatever its length
COMPARED_AT = 15.0
# the port's kernel wrappers read for their bounds in a traced window
KERNEL_WRAPPERS = (("nms_cuda", "non_max_suppression", "nms"),
                   ("roi_cuda", "crop_and_resize", "roi_crop"),
                   ("roi_cuda", "crop_and_resize_backward", "roi_crop_backward"),
                   ("iou_cuda", "iou_matrix", "iou"))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def build_program(config: Dict, device):
    """(model, step_fn, state) through the port's builders."""
    from mtlx_torch.builders import model_builder, optimizer_builder, preprocessor_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.train import train as train_lib
    from mtlx_torch.train import train_step as ts

    pipeline = config_util.parse_pipeline_text("\n".join(config["pipeline"]))
    tc = pipeline.train_config
    model = model_builder.build(pipeline.model, is_training=True, max_gt_boxes=config["max_boxes"],
                                dtype=_dtype(config["compute_dtype"]), device=device)
    tx, _, ema_decay = optimizer_builder.build(tc.optimizer, tc)
    aug = preprocessor_builder.build(tc.data_augmentation_options)
    reg = ts.make_regularization_fn(model_builder.regularization_scopes(pipeline.model))
    step_fn = train_lib.make_step_fn(model, aug, reg, ema_decay=ema_decay)
    return model, step_fn, tx, ema_decay


class _Recorder:
    """Stands in for a kernel wrapper of the port in a traced window: calls
    it and keeps what the call's bound needs (shapes, the boxes, the NMS
    picks; never the maps), so the window holds no more memory than an
    untraced one. The wrapper counts its launches on the module's name,
    so this object holds them until `restore` adds them back."""

    def __init__(self, module, name: str, key: str):
        self.module, self.name, self.key = module, name, key
        self.real = getattr(module, name)
        self.calls = []
        self.launches = 0
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        if self.key == "nms":  # boxes, scores, valid, max_out, ...
            kept = (tuple(args[1].shape), out[1], int(args[3]))
        elif self.key == "roi_crop":  # features, boxes, crop_size
            kept = (tuple(args[0].shape), args[0].element_size(), args[1],
                    tuple(int(s) for s in args[2]))
        elif self.key == "roi_crop_backward":  # dout, boxes, image_hw
            kept = (tuple(args[0].shape), args[0].element_size(), tuple(args[2]))
        else:  # boxes1, boxes2
            kept = (tuple(args[0].shape), tuple(args[1].shape))
        self.calls.append(kept)
        return out

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)
        self.real.launches += self.launches


def _bounds(recorders: Dict[str, _Recorder]) -> Dict[str, float]:
    """The least seconds of every recorded call, summed by kernel."""
    seconds = {"nms": work.nms_seconds,
               "roi_crop": work.crop_seconds,
               "roi_crop_backward": work.crop_backward_seconds,
               "iou": work.iou_seconds}
    return {key: sum(seconds[key](*call) for call in rec.calls)
            for key, rec in recorders.items()}


class _Compared:
    """The window's compared step: the state before it on pinned host
    buffers (parameters, momentum trace, step count), and what the step
    made: its loss terms, RPN outputs, sampled proposals and the
    parameters after it. Buffers are made in set-up; the copies run on
    the stream in order, so the window holds no more device memory and
    has no synchronize added."""

    def __init__(self, state, on_card: bool):
        self.names = list(state.opt_state.names)
        params = state.params

        def pinned():
            return [torch.empty(params[n].shape, dtype=params[n].dtype, pin_memory=on_card)
                    for n in self.names]

        self.before, self.trace, self.after = pinned(), pinned(), pinned()
        self.index = None

    @staticmethod
    def _copy(dst, src) -> None:
        for d, t in zip(dst, src):
            d.copy_(t.detach(), non_blocking=True)

    def start(self, state, model, index: int) -> None:
        self.index, self.count = index, state.opt_state.count
        params = state.params
        self._copy(self.before, [params[n] for n in self.names])
        self._copy(self.trace, state.opt_state.trace)
        self.rpn, self.sampled = [], []
        real_proposals, real_sample = model._proposals, model._sample_proposals

        def proposals(obj, enc, true_shapes, anchors=None):
            self.rpn.append((obj.clone(), enc.clone()))
            return real_proposals(obj, enc, true_shapes, anchors)

        def sample(*args, **kwargs):
            out = real_sample(*args, **kwargs)
            self.sampled.append((out[0].clone(), out[1].clone()))
            return out

        model._proposals, model._sample_proposals = proposals, sample

    def end(self, state, model, metrics) -> None:
        del model._proposals, model._sample_proposals
        params = state.params
        self._copy(self.after, [params[n] for n in self.names])
        self.metrics = metrics

    def record(self) -> Dict:
        """What the step made, as the comparison reads it."""
        change = {n: float(torch.linalg.vector_norm(a - b))
                  for n, a, b in zip(self.names, self.after, self.before)}
        return {"terms": _terms(self.metrics), "change_norms": change,
                "rpn": self.rpn[0], "sampled": self.sampled[0]}

    def snapshot(self, pool) -> Dict:
        """The state the reference follows the step from, and its batch."""
        return {"params": dict(zip(self.names, self.before)),
                "trace": dict(zip(self.names, self.trace)), "count": self.count,
                "batch": pool[self.index % len(pool)]}


def _terms(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if k != "grad_norm"}


def _norms(tensors) -> list:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


class _Traced:
    """The last TRACE_SECONDS of a traced window under torch.profiler,
    with the port's detection kernel wrappers (`wrappers`: (module of
    mtlx_torch.kernels, function, key)) recording their calls meanwhile."""

    def __init__(self, wrappers, on_card: bool):
        self.wrappers, self.on_card = wrappers, on_card
        self.prof, self.recorders = None, {}

    def start_if_due(self, elapsed: float, length: float) -> None:
        if self.prof is not None or elapsed < length - TRACE_SECONDS:
            return
        import importlib

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.recorders = {key: _Recorder(importlib.import_module("mtlx_torch.kernels." + m),
                                         name, key) for m, name, key in self.wrappers}
        self.t0 = time.perf_counter()

    def stop(self) -> Dict:
        """After the window's synchronize: {'trace', 'bounds'} of the
        traced part."""
        traced_s = time.perf_counter() - self.t0
        self.prof.stop()
        for rec in self.recorders.values():
            rec.restore()
        out = {"trace": trace_lib.reduce(self.prof, traced_s), "bounds": _bounds(self.recorders)}
        self.prof, self.recorders = None, {}
        return out


def run(spec: Dict, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, fault: Optional[Callable] = None,
        keep: bool = False) -> Dict:
    """The run's result (run.py prints it). `fault(step_fn) -> step_fn`
    breaks the timed path underneath, for the tests of the comparison.
    With `keep` the result also holds what the reference followed
    (`kept`: the first three batches, the compared window step's state),
    for control.py's stand-ins."""
    from mtlx_torch.train.train import kernel_launches

    t0 = time.perf_counter() if t0 is None else t0
    config, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    on_card = torch.device(device).type == "cuda"
    model, step_fn, tx, ema_decay = build_program(config, device)
    if fault is not None:
        step_fn = fault(step_fn)
    from mtlx_torch.train import train_step as ts

    shapes = {n: tuple(p.shape) for n, p in model.modules.named_parameters()}
    model.modules.load_state_dict(weights.make_weights(shapes, seed, device), strict=False)
    pool = inputs.train_pool(traffic, config["model"], config["max_boxes"], seed, device)
    calibrate.calibrate(model.modules.backbone, model.modules.classifier_backbone,
                        model.preprocess, pool[0][0]["image"])
    state = ts.create_train_state(model, tx, keep_ema=ema_decay is not None)
    params = dict(model.modules.named_parameters())

    # set-up: one pass over the pool, the first three steps kept
    rpn, sampled = [], []
    real_proposals, real_sample = model._proposals, model._sample_proposals

    def proposals(obj, enc, true_shapes, anchors=None):
        rpn.append((obj.clone(), enc.clone()))
        return real_proposals(obj, enc, true_shapes, anchors)

    def sample(*args, **kwargs):
        out = real_sample(*args, **kwargs)
        sampled.append((out[0].clone(), out[1].clone()))
        return out

    model._proposals, model._sample_proposals = proposals, sample
    names = list(params)
    start = {n: p.detach().clone() for n, p in params.items()}
    record = {"terms": []}
    for i in range(len(pool)):
        state, metrics = step_fn(state, pool[i][0], draws=pool[i][1])
        if i < 3:
            record["terms"].append(_terms(metrics))
        if i == 0:
            record["grad_norms"] = dict(zip(state.opt_state.names,
                                            _norms(state.opt_state.trace)))
            record["global_norm"] = float(metrics["grad_norm"])
            record["change_first"] = dict(zip(names, _norms(
                [params[n].detach() - start[n] for n in names])))
        if i == 2:
            record["change_norms"] = dict(zip(names, _norms(
                [params[n].detach() - start[n] for n in names])))
            del model._proposals, model._sample_proposals, start
    compared = _Compared(state, on_card)
    _sync(device)
    setup_s = time.perf_counter() - t0

    # the window
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = kernel_launches()
    traced = _Traced(KERNEL_WRAPPERS, on_card) if trace else None
    compare_at = min(COMPARED_AT, seconds / 2)
    losses, steps, images, marks = [], 0, 0, []
    w0 = time.perf_counter()
    while True:
        batch, draws = pool[steps % len(pool)]
        elapsed = time.perf_counter() - w0
        if traced is not None:
            traced.start_if_due(elapsed, seconds)
        this = compared.index is None and elapsed >= compare_at
        if this:
            compared.start(state, model, steps)
        state, metrics = step_fn(state, batch, draws=draws)
        if this:
            compared.end(state, model, metrics)
        losses.append(metrics["total_loss"])
        steps += 1
        images += batch["image"].shape[0]
        marks.append(time.perf_counter())
        if (marks[-1] - w0 >= seconds and compared.index is not None
                and (traced is None or traced.prof is not None)):
            break
    _sync(device)
    window_s = time.perf_counter() - w0
    if traced is not None:
        traced = traced.stop()
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    hw = tuple(pool[0][0]["image"].shape[1:3])
    run_info = {"steps": steps, "images": images, "window_s": window_s, "launches": launches,
                "step_marks": [m - w0 for m in marks],
                "model_flops": sum(work.train_step_flops(
                    config["model"], pool[i % len(pool)][0]["image"].shape[0],
                    tuple(pool[i % len(pool)][0]["image"].shape[1:3]), config["max_boxes"])
                    for i in range(steps))}
    if traced is not None:
        run_info.update(traced)
    record["window"] = compared.record()
    snapshot = compared.snapshot(pool)

    # the program's state goes before the reference runs
    first = [pool[i] for i in range(3)]
    del state, model, step_fn, params, pool, losses, metrics, batch, draws, compared
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = follow(config, seed, device, first, rpn[:3], sampled[:3], snapshot, record["window"])
    values = compare.numbers(record, ref)
    out = {"correct": compare.verdict(values, limits) and failed == 0,
           "attempted": steps, "failed": failed, "setup_s": setup_s, "peak_bytes": peak,
           "reference_s": time.perf_counter() - r0,
           "run": run_info, "values": values,
           "compared": {k: (values[k], lim) for k, lim in limits.items()},
           "hw": hw}
    if keep:
        out["kept"] = {"first": first, "snapshot": snapshot, "record": record, "ref": ref}
    return out


def _rpn_l2(obj, enc, step) -> float:
    pairs = ((obj.float(), step["obj"]), (enc.float(), step["enc"]))
    return max(float((got - want).norm() / want.norm()) for got, want in pairs)


def _reference_step(ref, net, batch, draws, obj, enc, props, mask) -> Dict:
    """One reference step on the run's proposals: {'terms', 'rpn_l2',
    'proposal_mismatch'} against the run's RPN outputs and sampled
    proposals. A run that left rows out has no proposals for them: the
    reference takes its own, and none of the run's count as reproduced."""
    b = batch["image"].shape[0]
    whole = props.shape[0] == obj.shape[0] == b
    step = ref.step(batch, draws, props.float(), mask) if whole else ref.step(batch, draws)
    out = {"terms": step["terms"]}
    if not whole:
        out["rpn_l2"] = float("inf")
        out["proposal_mismatch"] = b * step["sampled"][0].shape[1]
        return out
    out["rpn_l2"] = _rpn_l2(obj, enc, step)
    gt = step["gt"]
    want, want_mask = net.sampled_proposals(
        obj.float(), enc.float(), batch["true_shape"], gt["boxes"], gt["mask"],
        tuple(batch["image"].shape[1:3]), draws["proposal_pos"], draws["proposal_neg"])
    out["proposal_mismatch"] = int(((want != props).any(-1) | (want_mask != mask)).sum())
    return out


def reference_run(config: Dict, seed: int, device, first_batch, quantize=None):
    """The reference with the seed's weights, calibrated on the first
    batch as the port is."""
    from h100_bench.reference import layers as ref_layers
    from h100_bench.reference.detector import Detector, Config
    from h100_bench.reference.resnet import preprocess_images
    from h100_bench.reference.train import ReferenceRun

    probe = Detector(Config.from_dict(config["model"]))
    shapes = {n: tuple(p.shape) for n, p in probe.named_parameters()}
    state = {**probe.state_dict(), **weights.make_weights(shapes, seed, device)}
    del probe
    ref = ReferenceRun(config["model"], config["optimizer"], state, device)
    ref_layers.set_quantize(ref.net, quantize)
    calibrate.calibrate(ref.net.backbone, ref.net.classifier_backbone,
                        preprocess_images, first_batch["image"])
    return ref


def follow(config: Dict, seed: int, device, batches, rpn, sampled, snapshot=None,
           window=None) -> Dict:
    """The reference's three steps from the same weights and inputs, then
    (given the window's `snapshot` and what its step made, `window`) that
    step from the port's state before it: {'terms', 'grad_norms',
    'change_first', 'change_norms', 'rpn_l2', 'proposal_mismatch',
    'window': {'terms', 'grad_norms', 'change_norms', 'rpn_l2',
    'proposal_mismatch'}}."""
    ref = reference_run(config, seed, device, batches[0][0])
    net, params = ref.net, ref.params()
    start = {n: p.detach().clone() for n, p in params.items()}
    out = {"terms": [], "proposal_mismatch": 0}
    for i, (batch, draws) in enumerate(batches):
        step = _reference_step(ref, net, batch, draws, *rpn[i], *sampled[i])
        out["terms"].append(step["terms"])
        out["proposal_mismatch"] += step["proposal_mismatch"]
        if i == 0:  # the start: the same weights and images on both sides
            out["rpn_l2"] = step["rpn_l2"]
            out["grad_norms"] = dict(ref.grad_norms)
            out["global_norm"] = ref.global_norm
            out["change_first"] = dict(zip(ref.names, _norms(
                [params[n].detach() - start[n] for n in ref.names])))
    out["change_norms"] = dict(zip(ref.names, _norms(
        [params[n].detach() - start[n] for n in ref.names])))
    del start
    if snapshot is not None:
        ref.load(snapshot["params"], snapshot["trace"], snapshot["count"])
        batch, draws = snapshot["batch"]
        step = _reference_step(ref, net, batch, draws, *window["rpn"], *window["sampled"])
        step["grad_norms"] = dict(ref.grad_norms)
        step["change_norms"] = dict(zip(ref.names, _norms(
            [params[n].detach() - snapshot["params"][n].to(device) for n in ref.names])))
        out["window"] = step
    return out

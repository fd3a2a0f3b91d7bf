"""Convert TF checkpoints (slim classification or TF OD API detection)
to an `.npz` the port warm-starts from (port of mtlx's
tools/convert_checkpoint.py), with no TensorFlow:

    python -m mtlx_torch.tools.convert_checkpoint \
        --tf_checkpoint=/ckpt/resnet_v1_50.ckpt --type=classification \
        --depth=50 --output=/ckpt/r50_backbone.npz

    python -m mtlx_torch.tools.convert_checkpoint \
        --tf_checkpoint=/ckpt/model.ckpt --type=detection --depth=50 \
        --output=/ckpt/frcnn.npz

The checkpoint is read by tools/tf_checkpoint.py (V1 files and V2
bundles). The output holds one array per converted tensor under its
`/`-joined flax path (`params/backbone/conv1/kernel`,
`batch_stats/backbone/bn1/mean`), the same tensors bit for bit as mtlx's
`convert` returns; point `train_config.fine_tune_checkpoint` at it, with
`from_detection_checkpoint` true for a detection checkpoint
(train/checkpoints.py `restore_warm_start`).

The name tables are mtlx's, in its order:
  * slim `resnet_v1_XX/blockB/unit_U/bottleneck_v1/{conv1..3,shortcut}` ->
    `backbone/blockB/unitU/{conv1..3,conv_shortcut}` (+ each conv's batch
    norm), block4 under `classifier_backbone`
  * TF conv weights are [H, W, in, out] as flax's: no transpose; batch
    norm gamma / beta -> scale / bias params, moving_{mean,variance} ->
    batch_stats mean / var
  * slim MobilenetV1, InceptionV2 and InceptionResnetV2 likewise, with
    the depthwise kernels re-laid out as mtlx does
  * slim strides the last unit of a stage, mtlx the first (unless
    slim_stride_order): the kernels convert 1:1 all the same
Optimizer slots and global_step are skipped.
"""

from __future__ import annotations

import argparse
import re

import numpy as np


def _set(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value)


def map_slim_resnet_name(name: str, depth: int):
    """slim variable name -> (collection, mtlx path) or None."""
    prefix = f"resnet_v1_{depth}/"
    for strip in ("FirstStageFeatureExtractor/", "SecondStageFeatureExtractor/"):
        if name.startswith(strip):
            name = name[len(strip):]
    if not name.startswith(prefix):
        return None
    name = name[len(prefix):]

    def bn_leaf(leaf):
        return {
            "gamma": ("params", "scale"),
            "beta": ("params", "bias"),
            "moving_mean": ("batch_stats", "mean"),
            "moving_variance": ("batch_stats", "var"),
        }.get(leaf)

    # stem: conv1/weights, conv1/BatchNorm/*
    m = re.match(r"conv1/weights$", name)
    if m:
        return "params", ("backbone", "conv1", "kernel")
    m = re.match(r"conv1/BatchNorm/(\w+)$", name)
    if m:
        mapped = bn_leaf(m.group(1))
        if mapped:
            return mapped[0], ("backbone", "bn1", mapped[1])
        return None
    # blocks
    m = re.match(
        r"block(\d)/unit_(\d+)/bottleneck_v1/(conv1|conv2|conv3|shortcut)"
        r"/(weights|BatchNorm/(\w+))$",
        name,
    )
    if m:
        block, unit, conv, leaf, bn = m.groups()
        root = "classifier_backbone" if block == "4" else "backbone"
        conv_name = "conv_shortcut" if conv == "shortcut" else conv
        bn_name = {
            "conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
            "shortcut": "bn_shortcut",
        }[conv]
        base = (root, f"block{block}", f"unit{unit}")
        if leaf == "weights":
            return "params", base + (conv_name, "kernel")
        mapped = bn_leaf(bn)
        if mapped:
            return mapped[0], base + (bn_name, mapped[1])
    return None


def map_slim_mobilenet_name(name: str, depth: int = 0):
    """slim MobilenetV1 classification checkpoint -> mtlx SSD backbone
    (`MobilenetV1/Conv2d_{i}_{depthwise,pointwise}` -> `backbone/
    conv{i}_{dw,pw}`). Depthwise kernels transpose [H,W,C,1]->[H,W,1,C]
    (slim depthwise layout vs flax feature_group_count layout)."""
    prefix = "MobilenetV1/"
    if not name.startswith(prefix):
        return None
    name = name[len(prefix):]

    def bn_leaf(leaf):
        return {
            "gamma": ("params", "scale"),
            "beta": ("params", "bias"),
            "moving_mean": ("batch_stats", "mean"),
            "moving_variance": ("batch_stats", "var"),
        }.get(leaf)

    m = re.match(r"Conv2d_0/weights$", name)
    if m:
        return "params", ("backbone", "conv0", "kernel")
    m = re.match(r"Conv2d_0/BatchNorm/(\w+)$", name)
    if m:
        mapped = bn_leaf(m.group(1))
        if mapped:
            return mapped[0], ("backbone", "conv0_bn", mapped[1])
        return None
    m = re.match(
        r"Conv2d_(\d+)_(depthwise|pointwise)/"
        r"(depthwise_weights|weights|BatchNorm/(\w+))$",
        name,
    )
    if m:
        i, kind, leaf, bn = m.groups()
        suffix = "dw" if kind == "depthwise" else "pw"
        base = ("backbone", f"conv{i}_{suffix}")
        if leaf == "depthwise_weights":
            # [H, W, C, 1] -> [H, W, 1, C]
            return "params", base + ("kernel",), lambda v: np.transpose(
                v, (0, 1, 3, 2)
            )
        if leaf == "weights":
            return "params", base + ("kernel",)
        mapped = bn_leaf(bn)
        if mapped:
            return mapped[0], ("backbone", f"conv{i}_{suffix}_bn", mapped[1])
    return None


# slim inception_v2 branch-scope -> mtlx ConvBN name (normal mixed block)
_IV2_BRANCH = {
    ("Branch_0", "Conv2d_0a_1x1"): "b0",
    ("Branch_1", "Conv2d_0a_1x1"): "b1a",
    ("Branch_1", "Conv2d_0b_3x3"): "b1b",
    ("Branch_2", "Conv2d_0a_1x1"): "b2a",
    ("Branch_2", "Conv2d_0b_3x3"): "b2b",
    ("Branch_2", "Conv2d_0c_3x3"): "b2c",
    ("Branch_3", "Conv2d_0b_1x1"): "pool_proj",
}
# stride-2 reduction blocks (Mixed_4a, Mixed_5a) use different scopes
_IV2_BRANCH_REDUCTION = {
    ("Branch_0", "Conv2d_0a_1x1"): "b1a",
    ("Branch_0", "Conv2d_1a_3x3"): "b1b",
    ("Branch_1", "Conv2d_0a_1x1"): "b2a",
    ("Branch_1", "Conv2d_0b_3x3"): "b2b",
    ("Branch_1", "Conv2d_1a_3x3"): "b2c",
}
_IV2_REDUCTIONS = frozenset({"4a", "5a"})
_IV2_STEM_CONVS = {"Conv2d_2b_1x1": "conv2a", "Conv2d_2c_3x3": "conv2b"}


def map_slim_inception_v2_name(name: str, depth: int = 0):
    """slim InceptionV2 checkpoint (reference slim/nets/inception_v2.py)
    -> mtlx backbones/inception_v2.InceptionV2 tree rooted at `backbone`
    (the ssd_inception_v2 layout; convert() restructures for the FRCNN
    body/classifier split). The separable 7x7 stem's depthwise kernel
    reshapes [7,7,in,mult] -> [7,7,1,in*mult]: TF depthwise output
    channel ordering is channel-major (c*mult+m), which is exactly
    flax/XLA's grouped-conv output layout, so a C-order reshape is the
    whole transform."""
    prefix = "InceptionV2/"
    for strip in ("FirstStageFeatureExtractor/", "SecondStageFeatureExtractor/"):
        if name.startswith(strip):
            name = name[len(strip):]
    if not name.startswith(prefix):
        return None
    name = name[len(prefix):]

    def bn_leaf(leaf):
        return {
            "gamma": ("params", "scale"),
            "beta": ("params", "bias"),
            "moving_mean": ("batch_stats", "mean"),
            "moving_variance": ("batch_stats", "var"),
        }.get(leaf)

    m = re.match(
        r"Conv2d_1a_7x7/(depthwise_weights|pointwise_weights|BatchNorm/(\w+))$",
        name,
    )
    if m:
        leaf, bn = m.groups()
        if leaf == "depthwise_weights":
            return ("params", ("backbone", "conv1", "depthwise", "kernel"),
                    lambda v: v.reshape(v.shape[0], v.shape[1], 1, -1))
        if leaf == "pointwise_weights":
            return "params", ("backbone", "conv1", "pointwise", "conv", "kernel")
        mapped = bn_leaf(bn)
        if mapped:  # slim separable_conv2d: one BN after the pointwise
            return mapped[0], ("backbone", "conv1", "pointwise", "bn", mapped[1])
        return None
    m = re.match(r"(Conv2d_2b_1x1|Conv2d_2c_3x3)/(weights|BatchNorm/(\w+))$", name)
    if m:
        conv, leaf, bn = m.groups()
        base = ("backbone", _IV2_STEM_CONVS[conv])
        if leaf == "weights":
            return "params", base + ("conv", "kernel")
        mapped = bn_leaf(bn)
        if mapped:
            return mapped[0], base + ("bn", mapped[1])
        return None
    m = re.match(
        r"Mixed_(\d\w)/(Branch_\d)/(Conv2d_\w+)/(weights|BatchNorm/(\w+))$",
        name,
    )
    if m:
        blk, branch, conv, leaf, bn = m.groups()
        table = _IV2_BRANCH_REDUCTION if blk in _IV2_REDUCTIONS else _IV2_BRANCH
        sub = table.get((branch, conv))
        if sub is None:
            return None
        base = ("backbone", f"mixed_{blk.lower()}", sub)
        if leaf == "weights":
            return "params", base + ("conv", "kernel")
        mapped = bn_leaf(bn)
        if mapped:
            return mapped[0], base + ("bn", mapped[1])
    return None


# slim InceptionResnetV2 scope -> mtlx ConvBN name, per enclosing block.
# Roots: everything through the block17 repeats is the first-stage
# extractor ("backbone"); Mixed_7a/block8/Conv2d_7b are the second-stage
# branch ("classifier_backbone"), as in the reference's
# FirstStage/SecondStageFeatureExtractor split.
_IRV2_STEM = {
    "Conv2d_1a_3x3": "conv1", "Conv2d_2a_3x3": "conv2",
    "Conv2d_2b_3x3": "conv3", "Conv2d_3b_1x1": "conv4",
    "Conv2d_4a_3x3": "conv5",
}
_IRV2_MIXED = {
    "Mixed_5b": ("backbone", {
        ("Branch_0", "Conv2d_1x1"): "m5b_b0",
        ("Branch_1", "Conv2d_0a_1x1"): "m5b_b1a",
        ("Branch_1", "Conv2d_0b_5x5"): "m5b_b1b",
        ("Branch_2", "Conv2d_0a_1x1"): "m5b_b2a",
        ("Branch_2", "Conv2d_0b_3x3"): "m5b_b2b",
        ("Branch_2", "Conv2d_0c_3x3"): "m5b_b2c",
        ("Branch_3", "Conv2d_0b_1x1"): "m5b_b3",
    }),
    "Mixed_6a": ("backbone", {
        ("Branch_0", "Conv2d_1a_3x3"): "m6a_b0",
        ("Branch_1", "Conv2d_0a_1x1"): "m6a_b1a",
        ("Branch_1", "Conv2d_0b_3x3"): "m6a_b1b",
        ("Branch_1", "Conv2d_1a_3x3"): "m6a_b1c",
    }),
    "Mixed_7a": ("classifier_backbone", {
        ("Branch_0", "Conv2d_0a_1x1"): "m7a_b0a",
        ("Branch_0", "Conv2d_1a_3x3"): "m7a_b0b",
        ("Branch_1", "Conv2d_0a_1x1"): "m7a_b1a",
        ("Branch_1", "Conv2d_1a_3x3"): "m7a_b1b",
        ("Branch_2", "Conv2d_0a_1x1"): "m7a_b2a",
        ("Branch_2", "Conv2d_0b_3x3"): "m7a_b2b",
        ("Branch_2", "Conv2d_1a_3x3"): "m7a_b2c",
    }),
}
_IRV2_RESIDUAL = {
    "block35": ("backbone", {
        ("Branch_0", "Conv2d_1x1"): "b0",
        ("Branch_1", "Conv2d_0a_1x1"): "b1a",
        ("Branch_1", "Conv2d_0b_3x3"): "b1b",
        ("Branch_2", "Conv2d_0a_1x1"): "b2a",
        ("Branch_2", "Conv2d_0b_3x3"): "b2b",
        ("Branch_2", "Conv2d_0c_3x3"): "b2c",
    }),
    "block17": ("backbone", {
        ("Branch_0", "Conv2d_1x1"): "b0",
        ("Branch_1", "Conv2d_0a_1x1"): "b1a",
        ("Branch_1", "Conv2d_0b_1x7"): "b1b",
        ("Branch_1", "Conv2d_0c_7x1"): "b1c",
    }),
    "block8": ("classifier_backbone", {
        ("Branch_0", "Conv2d_1x1"): "b0",
        ("Branch_1", "Conv2d_0a_1x1"): "b1a",
        ("Branch_1", "Conv2d_0b_1x3"): "b1b",
        ("Branch_1", "Conv2d_0c_3x1"): "b1c",
    }),
}


def map_slim_inception_resnet_v2_name(name: str, depth: int = 0):
    """slim InceptionResnetV2 checkpoint (reference slim/nets/
    inception_resnet_v2.py) -> mtlx backbones/inception_resnet_v2 trees:
    stem..block17 repeats under `backbone` (InceptionResnetV2Proposal-
    Features), Mixed_7a/block8/Conv2d_7b under `classifier_backbone`
    (InceptionResnetV2BoxClassifierFeatures) — the FRCNN extractor
    layout. Residual blocks' projection conv (`Conv2d_1x1` directly
    under the block scope, with biases, no BN) maps to `up`."""
    prefix = "InceptionResnetV2/"
    for strip in ("FirstStageFeatureExtractor/", "SecondStageFeatureExtractor/"):
        if name.startswith(strip):
            name = name[len(strip):]
    if not name.startswith(prefix):
        return None
    name = name[len(prefix):]

    def bn_leaf(leaf):
        return {
            "gamma": ("params", "scale"),
            "beta": ("params", "bias"),
            "moving_mean": ("batch_stats", "mean"),
            "moving_variance": ("batch_stats", "var"),
        }.get(leaf)

    def conv_bn(base, leaf, bn):
        if leaf == "weights":
            return "params", base + ("conv", "kernel")
        mapped = bn_leaf(bn)
        if mapped:
            return mapped[0], base + ("bn", mapped[1])
        return None

    # stem + tail plain convs
    m = re.match(r"(Conv2d_\w+)/(weights|BatchNorm/(\w+))$", name)
    if m:
        conv, leaf, bn = m.groups()
        if conv == "Conv2d_7b_1x1":
            return conv_bn(("classifier_backbone", "conv7b"), leaf, bn)
        sub = _IRV2_STEM.get(conv)
        if sub is None:
            return None
        return conv_bn(("backbone", sub), leaf, bn)
    # mixed blocks
    m = re.match(
        r"(Mixed_\w+)/(Branch_\d)/(Conv2d_\w+)/(weights|BatchNorm/(\w+))$",
        name,
    )
    if m:
        blk, branch, conv, leaf, bn = m.groups()
        root_table = _IRV2_MIXED.get(blk)
        if root_table is None:
            return None
        root, table = root_table
        sub = table.get((branch, conv))
        if sub is None:
            return None
        return conv_bn((root, sub), leaf, bn)
    # residual blocks: slim.repeat scopes Repeat/Repeat_1/Repeat_2 (the
    # OD-API second stage may nest them differently — match by block name);
    # the standalone relu-less `Block8` scope is mtlx block8_10
    m = re.match(
        r"(?:Repeat(?:_\d)?/)?(block35_\d+|block17_\d+|block8_\d+|Block8)/"
        r"(?:(Branch_\d)/)?(Conv2d_\w+)/"
        r"(weights|biases|BatchNorm/(\w+))$",
        name,
    )
    if m:
        blk, branch, conv, leaf, bn = m.groups()
        if blk == "Block8":
            blk = "block8_10"
        kind = blk.split("_")[0]
        root, table = _IRV2_RESIDUAL[kind]
        if branch is None:
            if conv != "Conv2d_1x1":
                return None
            if leaf == "weights":
                return "params", (root, blk, "up", "kernel")
            if leaf == "biases":
                return "params", (root, blk, "up", "bias")
            return None
        sub = table.get((branch, conv))
        if sub is None:
            return None
        return conv_bn((root, blk, sub), leaf, bn)
    return None


def restructure_inception_v2_for_frcnn(params: dict, batch_stats: dict):
    """SSD-layout inception tree -> the FRCNN extractor layout: the full
    net under backbone/body (InceptionV2ProposalFeatures) and a copy of
    Mixed_5a..5c under classifier_backbone (InceptionV2BoxClassifier-
    Features has its own second-stage branch params, as the reference's
    SecondStageFeatureExtractor does)."""
    import copy

    for tree in (params, batch_stats):
        body = tree.pop("backbone", {})
        cls = {
            k: copy.deepcopy(body[k])
            for k in ("mixed_5a", "mixed_5b", "mixed_5c")
            if k in body
        }
        if body:
            tree["backbone"] = {"body": body}
        if cls:
            tree["classifier_backbone"] = cls


def map_od_api_name(name: str, depth: int):
    """TF OD API detection-checkpoint names (RPN + box predictor heads)."""
    mapped = map_slim_resnet_name(name, depth)
    if mapped:
        return mapped
    table = {
        "Conv/weights": ("params", ("rpn", "conv", "kernel")),
        "Conv/biases": ("params", ("rpn", "conv", "bias")),
        "FirstStageBoxPredictor/ClassPredictor/weights":
            ("params", ("rpn", "objectness", "kernel")),
        "FirstStageBoxPredictor/ClassPredictor/biases":
            ("params", ("rpn", "objectness", "bias")),
        "FirstStageBoxPredictor/BoxEncodingPredictor/weights":
            ("params", ("rpn", "box_encodings", "kernel")),
        "FirstStageBoxPredictor/BoxEncodingPredictor/biases":
            ("params", ("rpn", "box_encodings", "bias")),
        "SecondStageBoxPredictor/ClassPredictor/weights":
            ("params", ("box_predictor", "class_logits", "kernel")),
        "SecondStageBoxPredictor/ClassPredictor/biases":
            ("params", ("box_predictor", "class_logits", "bias")),
        "SecondStageBoxPredictor/BoxEncodingPredictor/weights":
            ("params", ("box_predictor", "box_refinement", "kernel")),
        "SecondStageBoxPredictor/BoxEncodingPredictor/biases":
            ("params", ("box_predictor", "box_refinement", "bias")),
    }
    return table.get(name)


_SKIPPED = ("Momentum", "RMSProp", "Adam", "global_step", "ExponentialMovingAverage")


def convert(tf_checkpoint: str, ckpt_type: str, depth: int,
            arch: str = "resnet", target: str = "ssd"):
    """({"params": tree, "batch_stats": tree} of numpy arrays, converted,
    skipped): mtlx's convert, reading with tools/tf_checkpoint.py."""
    from mtlx_torch.tools.tf_checkpoint import load_checkpoint

    reader = load_checkpoint(tf_checkpoint)
    shapes = reader.get_variable_to_shape_map()
    params: dict = {}
    batch_stats: dict = {}
    if arch == "mobilenet_v1":
        mapper = map_slim_mobilenet_name
    elif arch == "inception_v2":
        mapper = map_slim_inception_v2_name
    elif arch == "inception_resnet_v2":
        mapper = map_slim_inception_resnet_v2_name
    elif ckpt_type == "classification":
        mapper = map_slim_resnet_name
    else:
        mapper = map_od_api_name
    converted = skipped = 0
    for name in sorted(shapes):
        if any(s in name for s in _SKIPPED):
            continue
        mapped = mapper(name, depth)
        if mapped is None:
            skipped += 1
            continue
        if len(mapped) == 3:
            collection, path, transform = mapped
        else:
            collection, path = mapped
            transform = None
        value = reader.get_tensor(name)
        if transform is not None:
            value = transform(value)
        _set(params if collection == "params" else batch_stats, path, value)
        converted += 1
    if arch == "inception_v2" and target == "frcnn":
        restructure_inception_v2_for_frcnn(params, batch_stats)
    return {"params": params, "batch_stats": batch_stats}, converted, skipped


def flatten(variables: dict) -> dict:
    """`/`-joined path -> array of a nested variables tree."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
            else:
                out["/".join(prefix + (key,))] = value

    walk(variables, ())
    return out


def save_npz(path: str, variables: dict) -> str:
    """Write the converted tree as an `.npz` of `/`-joined flax paths
    (`.npz` is appended to a path without it, as numpy does)."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **flatten(variables))
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tf_checkpoint", required=True)
    p.add_argument("--type", dest="ckpt_type", default="classification",
                   choices=["classification", "detection"])
    p.add_argument("--arch", default="resnet",
                   choices=["resnet", "mobilenet_v1", "inception_v2", "inception_resnet_v2"],
                   help="source network family (mobilenet_v1 / inception_v2 / "
                        "inception_resnet_v2: slim classification checkpoints for a "
                        "backbone warm start; inception_resnet_v2 emits the FRCNN "
                        "backbone / classifier_backbone split directly)")
    p.add_argument("--target", default="ssd", choices=["ssd", "frcnn"],
                   help="inception_v2 only: ssd lays the tree under `backbone` "
                        "(ssd_inception_v2); frcnn splits it into backbone/body + "
                        "classifier_backbone (faster_rcnn_inception_v2)")
    p.add_argument("--depth", type=int, default=50, choices=[50, 101, 152])
    p.add_argument("--output", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    variables, converted, skipped = convert(args.tf_checkpoint, args.ckpt_type, args.depth,
                                            args.arch, args.target)
    out = save_npz(args.output, variables)
    print(f"converted {converted} tensors ({skipped} unmapped) -> {out}")
    print("use with train_config.fine_tune_checkpoint + "
          f"from_detection_checkpoint: {str(args.ckpt_type == 'detection').lower()}")
    return out


if __name__ == "__main__":
    main()

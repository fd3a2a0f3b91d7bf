"""Pipeline-config reading and writing (port of mtlx/config/config_util.py).

The text-format TrainEvalPipelineConfig is the public API. Its schema is
the one mtlx generates, held here as serialized descriptors and read by
`text_format`, the port's own reader: nothing here needs protobuf.
"""

from __future__ import annotations

import os
from typing import Dict

from mtlx_torch.config import text_format

PIPELINE = "mtlx.protos.TrainEvalPipelineConfig"
_SECTIONS = (("model", "model"), ("train_config", "train_config"),
             ("train_input_config", "train_input_reader"), ("eval_config", "eval_config"),
             ("eval_input_config", "eval_input_reader"), ("bucketing", "bucketing"))


def parse_pipeline_text(text: str) -> text_format.Message:
    """A TrainEvalPipelineConfig message from its text format."""
    return text_format.parse(text_format.pipeline_schema(), text, PIPELINE)


def get_configs_from_pipeline_file(path: str) -> Dict:
    """Read a TrainEvalPipelineConfig text proto -> dict of its sections
    (reference get_configs_from_pipeline_file contract)."""
    with open(path, "r") as f:
        pipeline = parse_pipeline_text(f.read())
    return {key: getattr(pipeline, field) for key, field in _SECTIONS}


def create_pipeline_proto_from_configs(configs: Dict) -> text_format.Message:
    """A TrainEvalPipelineConfig holding the sections of `configs`."""
    pipeline = text_format.pipeline_schema().new(PIPELINE)
    for key, field in _SECTIONS:
        section = configs.get(key)
        if section is not None:
            # every section is present, empty or not, as mtlx's CopyFrom
            # makes it; the section object is shared, not copied: the
            # returned message is written out and dropped
            pipeline._set(pipeline._field(field), section)
    return pipeline


def save_pipeline_config(pipeline, directory: str, filename: str = "pipeline.config") -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    with open(path, "w") as f:
        f.write(text_format.to_text(pipeline))
    return path


def merge_external_params_with_configs(configs: Dict, **kwargs) -> Dict:
    """Apply simple overrides in place (mtlx's subset of the reference's
    merge_external_params_with_configs): batch_size, train_steps,
    learning_rate, train_input_path, eval_input_path, label_map_path; a
    None value is skipped."""
    for key, value in kwargs.items():
        if value is None:
            continue
        if key == "batch_size":
            configs["train_config"].batch_size = int(value)
        elif key == "train_steps":
            configs["train_config"].num_steps = int(value)
        elif key == "learning_rate":
            _set_initial_learning_rate(configs["train_config"].optimizer, float(value))
        elif key in ("train_input_path", "eval_input_path"):
            reader = configs[key.replace("_path", "_config")].tf_record_input_reader
            reader.input_path[:] = [value]
            reader.SetInParent()
        elif key == "label_map_path":
            configs["train_input_config"].label_map_path = value
            configs["eval_input_config"].label_map_path = value
        else:
            raise ValueError(f"unknown override {key}")
    return configs


# the field that holds the initial rate, per learning-rate schedule
_INITIAL_RATE_FIELDS = {"constant_learning_rate": "learning_rate",
                        "exponential_decay_learning_rate": "initial_learning_rate",
                        "manual_step_learning_rate": "initial_learning_rate",
                        "cosine_decay_learning_rate": "learning_rate_base"}


def _set_initial_learning_rate(optimizer, lr: float) -> None:
    opt = getattr(optimizer, optimizer.WhichOneof("optimizer"))
    sched = opt.learning_rate.WhichOneof("learning_rate")
    # no schedule: getattr(..., None) raises TypeError, as in mtlx
    rate = getattr(opt.learning_rate, sched)
    field = _INITIAL_RATE_FIELDS.get(sched)
    if field is not None:
        setattr(rate, field, lr)


# TF1 queue-runner / parameter-server knobs with no equivalent in the
# port's input pipeline; accepted for config compatibility and reported
# as ignored (mtlx's compatibility_notes)
_QUEUE_ERA_TRAIN_FIELDS = (
    "batch_queue_capacity", "num_batch_queue_threads",
    "prefetch_queue_capacity", "startup_delay_steps",
    "replicas_to_aggregate",
)
_QUEUE_ERA_READER_FIELDS = ("queue_capacity", "min_after_dequeue", "num_readers")
_TF1_EVAL_FIELDS = ("save_graph", "eval_master")


def compatibility_notes(configs: Dict) -> list:
    """Notes for accepted-but-inapplicable TF1-era knobs that are set."""
    notes = []
    tc = configs.get("train_config")
    if tc is not None:
        for f in _QUEUE_ERA_TRAIN_FIELDS:
            if tc.HasField(f):
                notes.append(f"train_config.{f}={getattr(tc, f)} is a TF1 queue/PS knob; "
                             "the prefetching input pipeline has no equivalent (ignored)")
        if tc.HasField("sync_replicas"):
            notes.append(f"train_config.sync_replicas={tc.sync_replicas}: training is "
                         "always synchronous; async parameter-server mode does not exist here")
    for key in ("train_input_config", "eval_input_config"):
        rc = configs.get(key)
        if rc is None:
            continue
        for f in _QUEUE_ERA_READER_FIELDS:
            if rc.HasField(f):
                notes.append(f"{key}.{f}={getattr(rc, f)} is a TF1 queue knob; reading is "
                             "sequential + thread-pooled decode (ignored)")
    ec = configs.get("eval_config")
    if ec is not None:
        for f in _TF1_EVAL_FIELDS:
            if ec.HasField(f):
                notes.append(f"eval_config.{f} is TF1 graph/cluster machinery (ignored)")
    return notes

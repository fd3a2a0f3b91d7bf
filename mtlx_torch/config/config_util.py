"""Pipeline-config reading (port of mtlx/config/config_util.py).

The text-format TrainEvalPipelineConfig is the public API. Its schema is
the one mtlx generates, held here as serialized descriptors in a private
DescriptorPool. protobuf is imported only when a pipeline file is
parsed, so the rest of the port runs where protobuf is not installed.
"""

from __future__ import annotations

import functools
from typing import Dict


@functools.lru_cache(maxsize=None)
def _pipeline_class():
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    from mtlx_torch.config.protos import descriptors

    pool = descriptor_pool.DescriptorPool()
    for serialized in descriptors.FILES:
        pool.Add(descriptor_pb2.FileDescriptorProto.FromString(serialized))
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName("mtlx.protos.TrainEvalPipelineConfig")
    )


def parse_pipeline_text(text: str):
    """A TrainEvalPipelineConfig message from its text format."""
    from google.protobuf import text_format

    pipeline = _pipeline_class()()
    text_format.Parse(text, pipeline)
    return pipeline


def get_configs_from_pipeline_file(path: str) -> Dict:
    """Read a TrainEvalPipelineConfig text proto -> dict of its sections
    (reference get_configs_from_pipeline_file contract)."""
    with open(path, "r") as f:
        pipeline = parse_pipeline_text(f.read())
    return {
        "model": pipeline.model,
        "train_config": pipeline.train_config,
        "train_input_config": pipeline.train_input_reader,
        "eval_config": pipeline.eval_config,
        "eval_input_config": pipeline.eval_input_reader,
        "bucketing": pipeline.bucketing,
    }

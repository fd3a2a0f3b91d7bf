"""mtlx_torch's protobuf-free pipeline reader against protobuf's parse.

The port parses pipeline files and label maps with its own reader
(`mtlx_torch/config/text_format.py`); mtlx parses them with protobuf's
`text_format` into its generated `pb2` classes. Both must give the same
message, field by field over the descriptor (HasField, WhichOneof, every
value, every repeated field, exactly: floats as the same float32), and
the same FasterRCNNConfig for every Faster R-CNN config.
"""

import ast
import glob
import os

import pytest
from google.protobuf import text_format as pb_text_format

from mtlx.config.protos import pipeline_pb2, string_int_label_map_pb2
from mtlx_torch.builders import model_builder as tbuilder
from mtlx_torch.config import config_util as tconfig
from mtlx_torch.config import text_format
from mtlx_torch.utils import label_map_util as tlabel

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(_REPO, "configs", "*.config")))
FASTER_RCNN_CONFIGS = [p for p in CONFIGS if "faster_rcnn {" in open(p).read()]


def _end_to_end_config() -> str:
    """The CONFIG of tests/test_end_to_end.py, filled in."""
    with open(os.path.join(_REPO, "tests", "test_end_to_end.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "CONFIG":
            return node.value.value.format(record="/data/r.record", label_map="/data/lm.pbtxt")
    raise AssertionError("tests/test_end_to_end.py has no CONFIG")


LABEL_MAP = """
item { id: 1 name: 'aeroplane' display_name: "Aeroplane" }
item {
  name: "bicycle"  # a comment
  id: 2
}
item: { id: 3, name: 'bird'; }
"""


def assert_same(pb, msg, path="") -> None:
    """protobuf message `pb` and port message `msg` hold the same fields."""
    for f in pb.DESCRIPTOR.fields:
        where = f"{path}.{f.name}"
        is_msg = f.message_type is not None
        if f.is_repeated:
            want, got = list(getattr(pb, f.name)), list(getattr(msg, f.name))
            assert len(want) == len(got), where
            for i, (a, b) in enumerate(zip(want, got)):
                if is_msg:
                    assert_same(a, b, f"{where}[{i}]")
                else:
                    assert a == b and type(a) is type(b), (where, a, b)
        else:
            assert pb.HasField(f.name) == msg.HasField(f.name), where
            a, b = getattr(pb, f.name), getattr(msg, f.name)
            if is_msg:
                assert_same(a, b, where)
            else:
                assert a == b and type(a) is type(b), (where, a, b)
    for oneof in pb.DESCRIPTOR.oneofs:
        assert pb.WhichOneof(oneof.name) == msg.WhichOneof(oneof.name), (path, oneof.name)


def _texts():
    out = [(os.path.basename(p), open(p).read()) for p in CONFIGS]
    return out + [("test_end_to_end.CONFIG", _end_to_end_config())]


@pytest.mark.parametrize("name,text", _texts(), ids=[n for n, _ in _texts()])
def test_pipeline_parse_equals_protobuf(name, text):
    want = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
    got = tconfig.parse_pipeline_text(text)
    assert_same(want, got)
    # the printer's text reads back to the same message in both parsers
    printed = text_format.to_text(got)
    assert pb_text_format.Parse(printed, pipeline_pb2.TrainEvalPipelineConfig()) == want
    assert tconfig.parse_pipeline_text(printed) == got


def test_all_eight_configs_are_checked():
    assert len(CONFIGS) == 8
    assert len(FASTER_RCNN_CONFIGS) == 6  # five Faster R-CNN and the R-FCN one


@pytest.mark.parametrize("path", FASTER_RCNN_CONFIGS,
                         ids=[os.path.basename(p) for p in FASTER_RCNN_CONFIGS])
def test_build_config_equal_for_faster_rcnn(path):
    text = open(path).read()
    ours = tconfig.parse_pipeline_text(text)
    theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
    assert ours.model.WhichOneof("model") == "faster_rcnn"
    for training in (False, True):
        try:
            want = tbuilder.build_config(theirs.model, is_training=training)
        except NotImplementedError as e:  # the hard example miner (no Faster R-CNN config sets one)
            with pytest.raises(NotImplementedError, match=str(e)[:30]):
                tbuilder.build_config(ours.model, is_training=training)
            continue
        assert tbuilder.build_config(ours.model, is_training=training) == want
        assert tbuilder.regularization_scopes(ours.model) == \
            tbuilder.regularization_scopes(theirs.model)


def test_get_configs_sections(tmp_path):
    path = os.path.join(_REPO, "configs", "faster_rcnn_resnet50_mtl_voc0712.config")
    configs = tconfig.get_configs_from_pipeline_file(path)
    assert sorted(configs) == sorted(["model", "train_config", "train_input_config",
                                      "eval_config", "eval_input_config", "bucketing"])
    assert configs["train_config"].batch_size == 16
    assert configs["bucketing"].bucket_multiple == 128  # proto2 default
    assert configs["train_config"].HasField("num_steps")
    assert not configs["train_config"].HasField("startup_delay_steps")
    # a field set on an absent section makes it present, and it is written out
    configs["bucketing"].bucket_multiple = 32
    out = tconfig.save_pipeline_config(tconfig.create_pipeline_proto_from_configs(configs),
                                       str(tmp_path))
    again = tconfig.get_configs_from_pipeline_file(out)
    assert again["bucketing"].bucket_multiple == 32
    assert again["model"] == configs["model"]


def test_label_map_parse_equals_protobuf(tmp_path):
    want = pb_text_format.Parse(LABEL_MAP, string_int_label_map_pb2.StringIntLabelMap())
    path = tmp_path / "label_map.pbtxt"
    path.write_text(LABEL_MAP)
    got = tlabel.load_labelmap(str(path))
    assert_same(want, got)
    assert tlabel.get_label_map_dict(str(path)) == {"aeroplane": 1, "bicycle": 2, "bird": 3}
    assert tlabel.create_category_index_from_labelmap(str(path)) == {
        1: {"id": 1, "name": "Aeroplane"}, 2: {"id": 2, "name": "bicycle"},
        3: {"id": 3, "name": "bird"}}


def test_label_map_util_equals_mtlx(tmp_path):
    from mtlx.utils import label_map_util as jlabel

    path = tmp_path / "label_map.pbtxt"
    path.write_text(LABEL_MAP)
    for fn in ("get_label_map_dict", "create_category_index_from_labelmap"):
        assert getattr(tlabel, fn)(str(path)) == getattr(jlabel, fn)(str(path))
    for max_id in (2, 3):
        assert tlabel.convert_label_map_to_categories(tlabel.load_labelmap(str(path)), max_id) \
            == jlabel.convert_label_map_to_categories(jlabel.load_labelmap(str(path)), max_id)
    path.write_text("item { id: 0 name: 'background' }")
    with pytest.raises(ValueError, match="ids must be >= 1"):
        tlabel.load_labelmap(str(path))


@pytest.mark.parametrize("text,line,words", [
    ("model {\n  faster_rcnn {\n    num_klasses: 3\n  }\n}", 3, "no field named"),
    ("model { faster_rcnn {\n second_stage_post_processing {\n score_converter: CUBE } } }",
     3, "has no value named"),
    ("train_config {\n  batch_size: 2\n  batch_size: 4\n}", 3, "multiple"),
    ("train_config {}\ntrain_config {}", 2, "multiple"),
    ("model {\n faster_rcnn {}\n ssd {}\n}", 3, "another member of oneof"),
    ("train_config { batch_size: 2.5 }", 1, "integer"),
    ("train_config { batch_size: 2", 1, "end of the text"),
])
def test_parse_errors_name_the_line(text, line, words):
    with pytest.raises(text_format.ParseError, match=f"line {line}: .*{words}"):
        tconfig.parse_pipeline_text(text)
    with pytest.raises(pb_text_format.ParseError):  # protobuf refuses them too
        pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())


def test_scalar_forms_equal_protobuf():
    text = ("train_config { batch_size: 0x10 gradient_clipping_by_norm: 1e1 "
            "fine_tune_checkpoint: 'a\\tb' \"c\\x41\" sync_replicas: True "
            "freeze_variables: ['x', \"y\"] bias_grad_multiplier: -2.5f }\n"
            "eval_config { num_examples: 010 metrics_set: [] }")
    want = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
    got = tconfig.parse_pipeline_text(text)
    assert_same(want, got)
    assert got.train_config.fine_tune_checkpoint == "a\tbcA"
    assert got.eval_config.num_examples == 8


def test_wire_decoder_reads_the_descriptors():
    from mtlx_torch.config.protos import descriptors

    schema = text_format.pipeline_schema()
    assert len(descriptors.FILES) == 4
    # every message and enum of mtlx's generated modules is in the schema
    for module in (pipeline_pb2, string_int_label_map_pb2):
        for name, desc in module.DESCRIPTOR.message_types_by_name.items():
            mine = schema.messages[desc.full_name]
            assert [f.name for f in mine.fields] == [f.name for f in desc.fields]
            assert [f.number for f in mine.fields] == [f.number for f in desc.fields]
            assert sorted(mine.oneofs) == sorted(o.name for o in desc.oneofs)

"""The port's TF checkpoint reader and converter
(mtlx_torch/tools/tf_checkpoint.py, convert_checkpoint.py) against
TensorFlow and mtlx's tools/convert_checkpoint.py.

TensorFlow writes each checkpoint in both of its formats (V1: one table
file, as the slim checkpoints of 2016 ship; V2: an index and a data
shard, as the TF OD API's); the port reads them without TensorFlow. The
converted trees must equal mtlx's `convert` bit for bit, for every arch
and target mtlx's own conversion tests cover (the same seeded variables,
made by their generators). The CLI's `.npz` must warm-start a model to
the bridge of mtlx's converted tree. chip_smoke.py's writer, with which
the card's smoke run makes its checkpoints without TensorFlow, is held
to tf.train.load_checkpoint. A corrupted shard, a compressed block and a
partial V1 slice must raise by name.
"""

import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import chip_smoke  # noqa: E402
import test_checkpoint_convert as ref  # noqa: E402  (mtlx's generators and converter)
from tensorflow.core.protobuf import saver_pb2  # noqa: E402

from mtlx_torch import bridge  # noqa: E402
from mtlx_torch.tools import convert_checkpoint as port_convert  # noqa: E402
from mtlx_torch.tools import tf_checkpoint  # noqa: E402

VERSIONS = {"v1": saver_pb2.SaverDef.V1, "v2": saver_pb2.SaverDef.V2}


def write_tf(values, path, version: str):
    """Save `values` (name -> array) with TensorFlow's own Saver in the
    given format, as mtlx's tests do (V2) or as slim's files are (V1)."""
    with tf.Graph().as_default():
        tvars = {n: tf.compat.v1.get_variable(n, initializer=tf.constant(v))
                 for n, v in values.items()}
        saver = tf.compat.v1.train.Saver(var_list=tvars, write_version=VERSIONS[version])
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, path, write_meta_graph=False)
    return path


def save_tf(values, path, version: str):
    """Save `values` with TensorFlow's own save ops, eagerly (SaveV2 for
    V2, the legacy Save op's tensor-slice tables for V1): what the Saver
    writes, without building a graph of initializers."""
    names = sorted(values)
    tensors = [tf.constant(values[n]) for n in names]
    if version == "v2":
        tf.raw_ops.SaveV2(prefix=path, tensor_names=names, shape_and_slices=[""] * len(names),
                          tensors=tensors)
    else:
        tf.raw_ops.Save(filename=path, tensor_names=names, data=tensors)
    return path


def _mixed(rng):
    return {
        "a/weights": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
        "a/biases": rng.normal(size=(5,)).astype(np.float32),
        "b/table": rng.normal(size=(300, 200)).astype(np.float64),
        "c/ints": (np.arange(12, dtype=np.int32) - 6).reshape(3, 4),
        "d/count": np.asarray(-3, np.int64),
        "e/empty": np.zeros((0, 4), np.float32),
        "global_step": np.asarray(12345678901, np.int64),
    }


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_reader_matches_tensorflow(tmp_path, version):
    values = _mixed(np.random.RandomState(0))
    prefix = write_tf(values, str(tmp_path / "model.ckpt"), version)
    want = tf.train.load_checkpoint(prefix)
    for path in (prefix, str(tmp_path)):  # a prefix, and a directory's latest
        got = tf_checkpoint.load_checkpoint(path)
        assert got.version == int(version[1])
        assert got.get_variable_to_shape_map() == want.get_variable_to_shape_map()
        for name in values:
            a, b = got.get_tensor(name), want.get_tensor(name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="nope"):
        got.get_tensor("nope")


# mtlx's conversion tests: (arch, type, depth, target, generator, seed)
CASES = {
    "resnet50_detection": ("resnet", "detection", 50, "ssd",
                           lambda rng: ref._slim_resnet50_vars(rng, with_heads=True), 0),
    "resnet50_classification": ("resnet", "classification", 50, "ssd",
                                lambda rng: ref._slim_resnet50_vars(rng), 3),
    "mobilenet_v1": ("mobilenet_v1", "classification", 0, "ssd", ref._slim_mobilenet_vars, 0),
    "inception_v2_ssd": ("inception_v2", "classification", 0, "ssd",
                         ref._slim_inception_v2_vars, 0),
    "inception_v2_frcnn": ("inception_v2", "classification", 0, "frcnn",
                           ref._slim_inception_v2_vars, 1),
    "inception_resnet_v2": ("inception_resnet_v2", "classification", 0, "ssd",
                            ref._slim_inception_resnet_v2_vars, 2),
}


@pytest.fixture(scope="module")
def tf_files(tmp_path_factory):
    """Each case's variables written by TensorFlow in both formats, made
    on first use."""
    cache = {}

    def get(case: str, version: str):
        key = (case, version)
        if key not in cache:
            _, _, _, _, make, seed = CASES[case]
            path = tmp_path_factory.mktemp(f"{case}_{version}") / "model.ckpt"
            cache[key] = save_tf(make(np.random.RandomState(seed)), str(path), version)
        return cache[key]

    return get


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("case", list(CASES))
def test_convert_bit_equal_to_mtlx(tf_files, case, version):
    arch, kind, depth, target, _, _ = CASES[case]
    path = tf_files(case, version)
    got, n_conv, n_skip = port_convert.convert(path, kind, depth, arch, target)
    want, w_conv, w_skip = ref.convert_checkpoint.convert(path, kind, depth, arch=arch,
                                                          target=target)
    assert (n_conv, n_skip) == (w_conv, w_skip)
    flat_got, flat_want = port_convert.flatten(got), port_convert.flatten(want)
    assert sorted(flat_got) == sorted(flat_want)
    for key, w in flat_want.items():
        g = flat_got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key


def _tiny_port_model():
    """The port's counterpart of mtlx's `_tiny_model` (a full-width
    ResNet-50 Faster R-CNN on a 64x64 canvas)."""
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig

    return FasterRCNN(FasterRCNNConfig(
        num_classes=3, canvas_size=(64, 64), backbone="resnet50",
        anchor_scales=(0.5, 1.0), anchor_aspect_ratios=(1.0,),
        anchor_base_size=(32.0, 32.0), rpn_depth=16,
        first_stage_pre_nms_top_k=16, first_stage_max_proposals=8,
        max_gt_boxes=4, dtype=torch.float32, slim_stride_order=True,
    ), device="cpu")


@pytest.mark.parametrize("case,detection", [("resnet50_detection", True),
                                            ("resnet50_classification", False)])
def test_cli_npz_warm_starts_to_mtlx_tree(tf_files, tmp_path, capsys, case, detection):
    from mtlx_torch.train import checkpoints as ckpt_lib

    arch, kind, depth, target, _, _ = CASES[case]
    path = tf_files(case, "v1")
    out = port_convert.main(["--tf_checkpoint", path, "--type", kind, "--depth", str(depth),
                             "--output", str(tmp_path / "converted")])
    printed = capsys.readouterr().out.splitlines()
    want_tree, n_conv, n_skip = ref.convert_checkpoint.convert(path, kind, depth)
    assert out == str(tmp_path / "converted.npz")
    assert printed == [
        f"converted {n_conv} tensors ({n_skip} unmapped) -> {out}",
        "use with train_config.fine_tune_checkpoint + from_detection_checkpoint: "
        f"{str(detection).lower()}"]

    model = _tiny_port_model()
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.modules.state_dict().items()}
    restored, skipped = ckpt_lib.restore_warm_start(model, out, from_detection_checkpoint=detection)
    want = bridge.flax_to_state_dict(want_tree)
    state = model.modules.state_dict()
    backbone = [k for k in state if any("backbone" in p for p in k.split("."))]
    if detection:  # every tensor of the model is in the checkpoint
        assert (restored, skipped) == (len(state), 0)
        assert sorted(want) == sorted(state)
    else:  # the backbone's, every one of them, and nothing else
        assert restored == len(backbone) == n_conv
    for name, t in state.items():
        if name in want and (detection or name in backbone):
            assert torch.equal(t, want[name]), name
        else:
            assert torch.equal(t, before[name]), name


@pytest.mark.parametrize("version", [1, 2])
def test_chip_smoke_writer_reads_back_in_tensorflow(tmp_path, version):
    rng = np.random.RandomState(5)
    values = {**_mixed(rng), **chip_smoke.slim_resnet_vars(rng, heads=(20, 12, 512))}
    for name in ("b/table", "e/empty"):  # the writer writes float32, int32 and int64
        values.pop(name)
    values["unit\x00\xff/escaped"] = np.arange(3, dtype=np.float32)
    prefix = str(tmp_path / "model.ckpt")
    chip_smoke.write_tf_checkpoint(prefix, values, version)
    want = tf.train.load_checkpoint(prefix)
    got = tf_checkpoint.load_checkpoint(str(tmp_path))
    assert sorted(want.get_variable_to_shape_map()) == sorted(values)
    for name, v in values.items():
        for reader in (want, got):
            t = reader.get_tensor(name)
            assert t.dtype == v.dtype and t.shape == v.shape, name
            np.testing.assert_array_equal(t, v)


def test_corrupted_shard_fails_its_crc(tmp_path):
    values = _mixed(np.random.RandomState(1))
    prefix = write_tf(values, str(tmp_path / "model.ckpt"), "v2")
    reader = tf_checkpoint.load_checkpoint(prefix)
    np.testing.assert_array_equal(reader.get_tensor("a/weights"), values["a/weights"])
    shard = prefix + ".data-00000-of-00001"
    data = bytearray(open(shard, "rb").read())
    entry = reader._entries["a/weights"]
    offset = int(entry[4][-1][1]) + 17
    data[offset] ^= 0x40
    with open(shard, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="a/weights: .* fail their crc32c"):
        tf_checkpoint.load_checkpoint(prefix).get_tensor("a/weights")


def test_corrupted_table_block_fails_its_crc(tmp_path):
    prefix = write_tf(_mixed(np.random.RandomState(1)), str(tmp_path / "m.ckpt"), "v1")
    data = bytearray(open(prefix, "rb").read())
    data[40] ^= 0x01
    with open(prefix, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="fails its crc32c"):
        tf_checkpoint.load_checkpoint(prefix)


@pytest.mark.parametrize("version,block_type,name", [(2, 1, "snappy"), (1, 1, "snappy"),
                                                     (2, 2, "zlib")])
def test_compressed_block_raises_by_type(tmp_path, version, block_type, name):
    prefix = str(tmp_path / "model.ckpt")
    chip_smoke.write_tf_checkpoint(prefix, {"w": np.ones(3, np.float32)}, version, block_type)
    with pytest.raises(ValueError, match=rf"is {name} \(block type {block_type}\)"):
        tf_checkpoint.load_checkpoint(prefix)


def test_partial_v1_slice_raises_by_name(tmp_path):
    path = str(tmp_path / "model.ckpt")
    with tf.Graph().as_default():
        whole = tf.compat.v1.get_variable("whole", initializer=tf.constant(np.ones(4, np.float32)))
        split = tf.compat.v1.get_variable(
            "split", shape=(6, 3), initializer=tf.compat.v1.ones_initializer(),
            partitioner=tf.compat.v1.fixed_size_partitioner(2))
        saver = tf.compat.v1.train.Saver(var_list={"whole": whole, "split": split},
                                         write_version=saver_pb2.SaverDef.V1)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, path, write_meta_graph=False)
    reader = tf_checkpoint.load_checkpoint(path)
    assert reader.get_variable_to_shape_map()["split"] == [6, 3]
    np.testing.assert_array_equal(reader.get_tensor("whole"), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="split: saved as partial slices"):
        reader.get_tensor("split")


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tf_checkpoint.load_checkpoint(str(tmp_path / "absent.ckpt"))
    assert not os.path.exists(str(tmp_path / "absent.ckpt.index"))

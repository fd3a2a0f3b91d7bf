"""mtlx_torch's host side of the input pipeline against mtlx's: the crop /
pad geometry drawn on the host (data/host_geometry.py), its window
resample on the device (preprocessor.batch_apply_host_window), bucket
coalescing and `batches` with both (data/loader.py), the worker-process
loader (data/grain_loader.py), and the train CLI with --grain_workers,
--max_bucket_variants and --precompile_buckets.

Tolerance: none. The geometry (same sample, same numpy Generator), the
window resample (eager mtlx), the kept bucket sets and every batch must
be equal to the bit; the worker loader's batches equal `batches`'; the
train CLI's losses and parameters with the three flags equal those of
the same run without them.
"""

import io
import multiprocessing
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mtlx.data import example_decoder as jdec
from mtlx.data import host_geometry as jhg
from mtlx.data import loader as jloader
from mtlx.data import preprocessor as jprep
from mtlx.data import tfrecord as jtfrecord
from mtlx.utils import bucketing as jbucketing
from mtlx_torch.data import grain_loader
from mtlx_torch.data import host_geometry as thg
from mtlx_torch.data import loader as tloader
from mtlx_torch.data import preprocessor as tprep


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


RESIZER = ("keep_aspect", {"min_dimension": 150, "max_dimension": 300})
CANVAS = (320, 320)
# landscape, portrait, square and 4:3 sources
SIZES = ((60, 140), (140, 60), (100, 100), (90, 120))
_CROP = dict(min_object_covered=0.5, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_area=0.2,
             max_area=1.0, overlap_thresh=0.3, random_coef=0.2)
OPS = [
    ("random_crop_image", _CROP),
    ("random_pad_image", dict(min_image_height=0, min_image_width=0, max_image_height=0,
                              max_image_width=0, pad_color=(10.0, 20.0, 30.0))),
    ("random_crop_pad_image", dict(_CROP, min_padded_size_ratio=(1.0, 1.0),
                                   max_padded_size_ratio=(2.0, 2.0), pad_color=(5.0, 6.0, 7.0))),
    ("random_crop_to_aspect_ratio", dict(aspect_ratio=1.0, overlap_thresh=0.3)),
    ("ssd_random_crop", dict(operations=())),
    ("ssd_random_crop_pad", dict(operations=())),
    ("ssd_random_crop_fixed_aspect_ratio", dict(operations=(), aspect_ratio=0.5)),
]
# a crop, a pad, and a crop then a pad
CHAIN = [OPS[0], OPS[1]]


def _jpeg(image: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _write(path, n: int, seed: int, corrupt: bool = False) -> str:
    """n JPEG records of SIZES in turn, 0-4 boxes each (mtlx's writer);
    with `corrupt` the image bytes are not an image."""
    rs = np.random.RandomState(seed)
    with jtfrecord.TFRecordWriter(str(path)) as w:
        for i in range(n):
            h, wd = SIZES[i % len(SIZES)]
            enc = b"not an image" if corrupt else _jpeg(rs.randint(0, 256, (h, wd, 3))
                                                          .astype(np.uint8))
            k = rs.randint(0, 5)
            y0, x0 = rs.uniform(0, 0.6, k), rs.uniform(0, 0.6, k)
            boxes = np.stack([y0, x0, y0 + rs.uniform(0.1, 0.4, k),
                              x0 + rs.uniform(0.1, 0.4, k)], 1).astype(np.float32)
            ex = jdec.build_example(enc, b"jpeg", h, wd, f"im{i}", boxes,
                                    rs.randint(1, 4, k), ["c"] * k)
            w.write(ex.SerializeToString())
    return str(path)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("geometry")
    return {"good": _write(tmp / "good.record", 11, 0),
            "corrupt": _write(tmp / "corrupt.record", 4, 1, corrupt=True)}


@pytest.fixture
def mtlx_multiple_32():
    """mtlx's loader reads its granularity from a process-wide setting."""
    jbucketing.set_bucket_multiple(32)
    try:
        yield 32
    finally:
        jbucketing.set_bucket_multiple(jbucketing.DEFAULT_BUCKET_MULTIPLE)


def _sample(rs, i):
    """A loader sample's geometry fields at a keep-aspect target."""
    h, w = [(48, 64), (64, 40), (30, 64)][i % 3]
    boxes = np.zeros((6, 4), np.float32)
    mask = np.zeros(6, bool)
    for j in range(rs.randint(0, 5)):
        y0, x0 = rs.uniform(0, h - 8), rs.uniform(0, w - 8)
        boxes[j] = [y0, x0, y0 + rs.uniform(4, h - y0), x0 + rs.uniform(4, w - x0)]
        mask[j] = True
    return {"image": np.zeros((64, 64, 3), np.uint8), "true_shape": np.array([h, w], np.int32),
            "original_shape": np.array([h * 5, w * 5], np.int32), "gt_boxes": boxes,
            "gt_mask": mask}


@pytest.mark.parametrize("chain", [[op] for op in OPS] + [CHAIN],
                         ids=[n for n, _ in OPS] + ["crop_then_pad"])
def test_host_geometry_matches_mtlx(chain):
    theirs = jhg.HostGeometry(chain, 48, 64, (64, 64))
    ours = thg.HostGeometry(chain, 48, 64, (64, 64))
    rs = np.random.RandomState(len(chain[0][0]))
    for i in range(12):
        sample = _sample(rs, i)
        want = theirs(sample, np.random.default_rng([3, i]))
        got = ours(sample, np.random.default_rng([3, i]))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (chain, i, k)
    assert ours.achievable_post_buckets(32) == theirs.achievable_post_buckets(32)
    options = chain + [("random_horizontal_flip", {})]
    assert thg.split_host_geometry(options, RESIZER) == jhg.split_host_geometry(options, RESIZER)
    assert thg.split_host_geometry(options, ("fixed", {})) == ([], options)


@pytest.mark.parametrize("chain", [[OPS[0]], [OPS[1]], CHAIN],
                         ids=["crop", "pad", "crop_then_pad"])
def test_batch_apply_host_window_matches_mtlx(chain):
    geometry = jhg.HostGeometry(chain, 48, 64, (64, 64))
    rs = np.random.RandomState(7)
    outs = [geometry(_sample(rs, i), np.random.default_rng([1, i])) for i in range(3)]
    images = rs.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)
    args = [np.stack([o[k] for o in outs]) for k in
            ("true_shape", "aug_window", "aug_src_shape", "aug_pad_color", "aug_content")]
    for n in (5, 4):  # with the content rect, and its default
        want = np.asarray(jprep.batch_apply_host_window(
            jnp.asarray(images), *[jnp.asarray(a) for a in args[:n]]))
        got = tprep.batch_apply_host_window(torch.from_numpy(images),
                                            *[torch.from_numpy(a) for a in args[:n]])
        np.testing.assert_array_equal(got.numpy(), want)


def _datasets(path):
    return (tloader.DetectionDataset([path], CANVAS, RESIZER, max_boxes=6),
            jloader.DetectionDataset([path], CANVAS, RESIZER, max_boxes=6))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, v in w.items():
            if key == "source_id":
                assert g[key] == v
            else:
                assert g[key].dtype == v.dtype and np.array_equal(g[key], v), key


def test_bucket_coalescer_matches_mtlx(records, mtlx_multiple_32):
    rs = np.random.RandomState(0)
    keys = [tuple(int(v) for v in rs.choice([32, 64, 96, 128, 320], 2)) for _ in range(40)]
    for bound in (1, 2, 3, 30):
        ours = tloader.BucketCoalescer(keys, bound, CANVAS)
        theirs = jloader.BucketCoalescer(keys, bound, CANVAS)
        assert (ours.kept, ours.active) == (theirs.kept, theirs.active)
        for k in keys + [(33, 200), (400, 10)]:
            assert ours.map(k) == theirs.map(k)
    port, ref = _datasets(records["good"])
    geometry = (thg.HostGeometry(CHAIN, 150, 300, CANVAS),
                jhg.HostGeometry(CHAIN, 150, 300, CANVAS))
    for hg_port, hg_ref in ((None, None), geometry):
        for bound in (0, 2):
            assert tloader.achievable_bucket_shapes(
                port, 3, host_geometry=hg_port, max_bucket_variants=bound,
                bucket_multiple=32) == jloader.achievable_bucket_shapes(
                ref, 3, host_geometry=hg_ref, max_bucket_variants=bound)
        if hg_port is not None:
            assert tloader.sampled_post_geometry_keys(port, hg_port, bucket_multiple=32) == \
                jloader.sampled_post_geometry_keys(ref, hg_ref)
            assert port.peek_geometry_sample(2).keys() == ref.peek_geometry_sample(2).keys()
        assert tloader.build_bucket_coalescer(port, 2, hg_port, bucket_multiple=32).kept == \
            jloader.build_bucket_coalescer(ref, 2, hg_ref).kept
    port.close()


@pytest.mark.parametrize("kw", [
    dict(pack_images=True, max_bucket_variants=2),  # grouped, coalesced, host geometry
    dict(pack_images=True, aspect_grouping=False, max_bucket_variants=1, seed=5),
    dict(pack_images=False, shuffle=False),
])
def test_batches_with_host_geometry_match_mtlx(records, mtlx_multiple_32, kw):
    port, ref = _datasets(records["good"])
    kw = dict(dict(seed=3, shuffle=True), **kw)
    got = list(tloader.batches(port, 3, epochs=2, bucket_multiple=32,
                               host_geometry=thg.HostGeometry(CHAIN, 150, 300, CANVAS), **kw))
    want = list(jloader.batches(ref, 3, epochs=2,
                                host_geometry=jhg.HostGeometry(CHAIN, 150, 300, CANVAS), **kw))
    _assert_batches_equal(got, want)
    assert {"aug_window", "aug_content"} <= set(got[0])
    if kw.get("max_bucket_variants"):
        kept = tloader.build_bucket_coalescer(port, kw["max_bucket_variants"], bucket_multiple=32,
                                              host_geometry=thg.HostGeometry(CHAIN, 150, 300,
                                                                             CANVAS)).kept
        assert {b["image"].shape[1:3] for b in got} <= set(kept)
    port.close()


def _children():
    return [p for p in multiprocessing.active_children() if p.name.startswith("mtlx-loader")]


def test_grain_loader_equals_batches(records):
    port, _ = _datasets(records["good"])
    kw = dict(shuffle=True, seed=4, pack_images=True, bucket_multiple=32,
              host_geometry=thg.HostGeometry(CHAIN, 150, 300, CANVAS), max_bucket_variants=2)
    want = list(tloader.batches(port, 3, epochs=2, **kw))
    loader = grain_loader.make_grain_loader(port, 3, worker_count=2, num_epochs=2, **kw)
    got = list(loader)
    _assert_batches_equal(got, want)  # 6 batches: across the epoch boundary
    assert not _children()
    loader.close()
    port.close()


def test_grain_loader_raises_a_workers_failure(records):
    bad, _ = _datasets(records["corrupt"])
    loader = grain_loader.make_grain_loader(bad, 2, worker_count=1, num_epochs=1)
    with pytest.raises(RuntimeError, match="loader worker 0 failed on batch 0"):
        next(loader)
    assert not _children()
    good, _ = _datasets(records["good"])
    loader = grain_loader.make_grain_loader(good, 2, worker_count=2)
    next(loader)
    os.kill(loader._procs[1].pid, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="loader worker 1 exited with code -9"):
        for _ in range(20):  # what the dead worker sent before is still read
            next(loader)
    assert not _children()
    with pytest.raises(ValueError, match="worker_count"):
        grain_loader.make_grain_loader(good, 2, worker_count=0)
    good.close()


# the train CLI on a keep-aspect ResNet-50 MTL at 48/64 with a crop / pad chain
_CLI_CONFIG = """
model {{ faster_rcnn {{
  num_classes: 3
  image_resizer {{ keep_aspect_ratio_resizer {{ min_dimension: 48 max_dimension: 64 }} }}
  feature_extractor {{ type: 'faster_rcnn_resnet50' }}
  first_stage_anchor_generator {{
    grid_anchor_generator {{ scales: [0.5, 1.0] aspect_ratios: [1.0] height: 64 width: 64 }} }}
  first_stage_box_predictor_depth: 32
  first_stage_max_proposals: 8
  first_stage_minibatch_size: 16
  second_stage_batch_size: 4
  initial_crop_size: 14
  maxpool_kernel_size: 2
  maxpool_stride: 2
  second_stage_post_processing {{
    batch_non_max_suppression {{ score_threshold: 0.0 iou_threshold: 0.6
      max_detections_per_class: 5 max_total_detections: 10 }}
    score_converter: SOFTMAX }}
  mtl {{ window: true closeness: true edgemask: true }}
}} }}
train_config {{
  batch_size: 2
  optimizer {{ momentum_optimizer {{
    learning_rate {{ constant_learning_rate {{ learning_rate: 0.001 }} }}
    momentum_optimizer_value: 0.9 }} }}
  gradient_clipping_by_norm: 10.0
  data_augmentation_options {{ random_horizontal_flip {{}} }}
  data_augmentation_options {{ random_crop_image {{ min_object_covered: 0.3 min_area: 0.3 }} }}
  data_augmentation_options {{ random_pad_image {{ pad_color: 10 pad_color: 20
    pad_color: 30 }} }}
  data_augmentation_options {{ random_distort_color {{}} }}
  data_augmentation_options {{ random_black_patches {{ max_black_patches: 2 }} }}
  num_steps: 3
  save_checkpoints_steps: 3
  max_number_of_boxes: 8
}}
train_input_reader {{ tf_record_input_reader {{ input_path: "{record}" }} }}
"""


def test_train_cli_pipeline_flags_change_nothing(records, tmp_path, capsys):
    """--grain_workers 2 --max_bucket_variants 2 --precompile_buckets on a
    keep-aspect crop / pad chain: the same losses and parameters, to the
    bit, as the run without them. At this canvas (64x64, bucket multiple
    128) every batch computes on the one bucket, so the bound keeps it and
    the warm-up runs there; tests above hold coalescing itself to mtlx."""
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli
    from mtlx_torch.utils.summary_writer import read_events

    config = str(tmp_path / "pipeline.config")
    with open(config, "w") as f:
        f.write(_CLI_CONFIG.format(record=records["good"]))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    runs = {}
    try:
        for tag, flags in (("plain", []), ("flags", ["--grain_workers", "2",
                                                     "--max_bucket_variants", "2",
                                                     "--precompile_buckets"])):
            train_dir = str(tmp_path / tag)
            train_cli.main(["--pipeline_config_path", config, "--train_dir", train_dir,
                            "--device", "cpu", "--log_every", "1"] + flags)
            out = capsys.readouterr().out
            assert "[train] done at step 3" in out
            events = [e for name in sorted(os.listdir(train_dir)) if "tfevents" in name
                      for e in read_events(os.path.join(train_dir, name))]
            # every scalar but the wall-clock rate
            runs[tag] = (out, [(e["step"], e["values"]) for e in events if "values" in e
                               and e["values"][0][0] != "global_step/sec"],
                         ckpt_lib.load_checkpoint(ckpt_lib.checkpoint_path(train_dir, 3)))
    finally:
        torch.set_num_threads(threads)
    out, events, ckpt = runs["flags"]
    assert "host-side crop / pad geometry: ['random_crop_image', 'random_pad_image']" in out
    assert "warmed up 1 bucket shapes [(64, 64)]" in out
    assert not _children()
    assert events == runs["plain"][1] and {step for step, _ in events} == {1, 2, 3}
    want = runs["plain"][2]
    assert sorted(ckpt["params"]) == sorted(want["params"])
    for k, v in want["params"].items():
        assert torch.equal(ckpt["params"][k], v), k
    assert len(ckpt["opt_trace"]) == len(want["opt_trace"])
    assert all(torch.equal(a, b) for a, b in zip(ckpt["opt_trace"], want["opt_trace"]))

"""The serving program of `exporter.export_saved_model` and its loader
(`mtlx_torch/export/saved_model.py`), on the CPU in float32.

  * The four kernels as torch ops (`mtlx_torch/kernels/ops.py`): each op's
    CPU implementation equals its kernel's plain version bit for bit, and
    its fake implementation gives the real output's shape and type.
  * The tiny flagship (resnet10, 64x64 canvas, keep-aspect 48 / 64), the
    tiny `refine: true` MTL model and the tiny SSD (MobileNet x 0.25,
    fixed 64x64), with mtlx's seeded weights carried by `bridge.py`,
    exported and loaded in another process that cannot import the port's
    detector, builders, backbones or heads (nor mtlx or jax): at batch 1, 2
    and 3, and through the encoded and tf.Example signatures, the results
    equal the port's eager forward bit for bit, and mtlx's eager `forward`
    (`mtlx/export/exporter.py:130-141`, under `jax.disable_jit`) with
    classes and num_detections equal and boxes and scores at rtol 1e-4 and
    an atol of 1e-4 of the largest magnitude, as tests/test_torch_serving.py
    holds them. mtlx's own SavedModel cannot be the reference: its jax2tf
    conversion fails (tests/test_saved_model_export.py).
  * The host decode path against TensorFlow's ops as mtlx's serving graph
    runs them (`mtlx/export/exporter.py:165-189`: decode_image, the keep-
    aspect target, compat.v1 resize_images, floor(x + 0.5), the clip and
    pad_to_bounding_box), exactly, for both resizers.

TF's and mtlx's references each run in a process of their own, started
first, beside the export.
  * A -inf score threshold survives the program's save and load.
"""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from mtlx_torch.bridge import flax_to_state_dict
from mtlx_torch.data import imgcodec
from mtlx_torch.data.example_decoder import build_example
from mtlx_torch.export import exporter as texporter
from mtlx_torch.export import saved_model
from mtlx_torch.kernels import iou_cuda, nms_cuda, ops, roi_cuda
from test_torch_live_bn import TINY_SSD
from test_torch_rfcn import seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP_ASPECT = ("keep_aspect", {"min_dimension": 48, "max_dimension": 64})
FIXED = ("fixed", {"height": 64, "width": 64})
MODELS = ("flagship", "refine", "ssd")
# the images a request holds: (h, w), and the format they are encoded in
PICTURES = (((90, 120), "jpeg"), ((120, 90), "png"), ((64, 70), "jpeg"))
REFINE = dict(multiobject=True, closeness=True, foreground=True, refine=True)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------- the ops


def _boxes(rs, *lead):
    corners = np.sort(rs.uniform(-0.1, 1.1, (*lead, 2, 2)), axis=-1)
    return torch.from_numpy(corners.reshape(*lead, 4)[..., [0, 2, 1, 3]].astype(np.float32))


def _op_case(name):
    """(op, args, the plain version's result) at small shapes."""
    rs = np.random.RandomState(3)
    if name == "non_max_suppression":
        boxes = _boxes(rs, 3, 40)
        scores = torch.from_numpy(rs.uniform(0, 1, (3, 40)).astype(np.float32))
        valid = torch.from_numpy(rs.uniform(0, 1, (3, 40)) < 0.8)
        args = (boxes, scores, valid, 7, 0.5, float("-inf"))
        return ops.non_max_suppression, args, nms_cuda.non_max_suppression_plain(*args)
    if name == "crop_and_resize":
        features = torch.from_numpy(rs.normal(0, 1, (2, 9, 11, 5)).astype(np.float32))
        boxes = _boxes(rs, 2, 6)
        args = (features, boxes, 4, 3)
        return ops.crop_and_resize, args, roi_cuda.crop_and_resize_plain(features, boxes, (4, 3))
    if name == "crop_and_resize_backward":
        dout = torch.from_numpy(rs.normal(0, 1, (2, 6, 4, 3, 5)).astype(np.float32))
        boxes = _boxes(rs, 2, 6)
        args = (dout, boxes, 9, 11)
        return (ops.crop_and_resize_backward, args,
                roi_cuda.crop_and_resize_backward_plain(dout, boxes, (9, 11)))
    b1, b2 = _boxes(rs, 1, 7), _boxes(rs, 4, 13)
    return ops.iou_matrix, (b1, b2), iou_cuda.iou_matrix_plain(b1, b2)


@pytest.mark.parametrize("name", ["non_max_suppression", "crop_and_resize",
                                  "crop_and_resize_backward", "iou_matrix"])
def test_op_cpu_is_the_plain_version_and_fake_gives_its_shape(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, want = _op_case(name)
    got = getattr(torch.ops.mtlx, name)(*args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(f.shape), f.dtype) for f in fake] == [(tuple(w.shape), w.dtype) for w in want]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def test_minus_infinity_threshold_survives_save_and_load(tmp_path):
    """A float argument of an op (NMS's score threshold) keeps -inf through
    torch.export.save and load."""

    class Select(torch.nn.Module):
        def forward(self, boxes, scores, valid):
            return nms_cuda.non_max_suppression(boxes, scores, valid, 5, 0.5, float("-inf"))

    _, (boxes, scores, valid, *_), _ = _op_case("non_max_suppression")
    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(Select(), (boxes, scores, valid), strict=False,
                                  dynamic_shapes=({0: batch}, {0: batch}, {0: batch}))
    torch.export.save(program, str(tmp_path / "nms.pt2"))
    loaded = torch.export.load(str(tmp_path / "nms.pt2"))
    calls = [n for n in loaded.graph.nodes if n.target == torch.ops.mtlx.non_max_suppression.default]
    assert len(calls) == 1 and calls[0].args[5] == float("-inf")
    want = nms_cuda.non_max_suppression_plain(boxes[:2], scores[:2], valid[:2], 5, 0.5,
                                              float("-inf"))
    got = loaded.module()(boxes[:2], scores[:2], valid[:2])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------- the inputs


def _picture(rs, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 127 // (h + w)], -1)
    image = image.astype(np.uint8)
    image[h // 5: h // 2, w // 6: w // 2] = [220, 40, 60]
    image[h // 2: h - 4, w // 2: w - 6] = rs.randint(0, 256, 3)
    return image


def _encode(image, fmt):
    if fmt == "png":
        return imgcodec.encode_png(image)
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _host_blobs():
    """The requests' images and a noisy photo-sized JPEG, a gray JPEG and
    an RGBA PNG."""
    rs = np.random.RandomState(11)
    blobs = [_encode(_picture(rs, h, w), fmt) for (h, w), fmt in PICTURES]
    blobs.append(_encode(rs.randint(0, 256, (300, 400, 3)).astype(np.uint8), "jpeg"))
    gray = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (50, 37)).astype(np.uint8)).save(gray, format="JPEG")
    blobs.append(gray.getvalue())
    rgba = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (45, 61, 4)).astype(np.uint8)).save(rgba, format="PNG")
    blobs.append(rgba.getvalue())
    return blobs


# resizers of the host path: the two the models use, one whose targets pass
# the canvas (the clip), one that shrinks every image and one whose target
# is the first two images' own size (no resize; the 120x90 one clipped)
_HOST_RESIZERS = (("keep_aspect", KEEP_ASPECT, (64, 64)), ("fixed", FIXED, (64, 64)),
                  ("keep_aspect_clipped", ("keep_aspect", {"min_dimension": 100,
                                                           "max_dimension": 140}), (96, 128)),
                  ("fixed_small", ("fixed", {"height": 33, "width": 47}), (40, 40)),
                  ("keep_aspect_own_size", ("keep_aspect", {"min_dimension": 90,
                                                            "max_dimension": 120}), (96, 128)))

# TF's ops as mtlx's serving graph runs them (mtlx/export/exporter.py:165-189):
# (canvas, true shape) of each blob, per resizer
_TF_REFERENCE = r"""
import sys, numpy as np, tensorflow as tf
data = np.load(sys.argv[1] + "/host.npz", allow_pickle=True)
out = {}
for name, (kind, params), (ch, cw) in data["resizers"]:
    def decode_resize_pad(blob):
        img = tf.io.decode_image(blob, channels=3, expand_animations=False)
        shape = tf.shape(img)
        h, w = shape[0], shape[1]
        if kind == "fixed":
            th = tf.constant(params["height"])
            tw = tf.constant(params["width"])
        else:
            scale = tf.minimum(params["min_dimension"] / tf.cast(tf.minimum(h, w), tf.float64),
                               params["max_dimension"] / tf.cast(tf.maximum(h, w), tf.float64))
            th = tf.cast(tf.round(tf.cast(h, tf.float64) * scale), tf.int32)
            tw = tf.cast(tf.round(tf.cast(w, tf.float64) * scale), tf.int32)
        resized = tf.compat.v1.image.resize_images(tf.cast(img, tf.float32)[None], (th, tw),
                                                   align_corners=False)[0]
        resized = tf.cast(tf.math.floor(resized + 0.5), tf.uint8)
        th = tf.minimum(th, ch)
        tw = tf.minimum(tw, cw)
        canvas = tf.image.pad_to_bounding_box(resized[:th, :tw], 0, 0, ch, cw)
        return canvas, tf.stack([th, tw])

    canvases, shapes = zip(*(decode_resize_pad(tf.constant(b)) for b in data["blobs"]))
    out[name + "_canvas"] = np.stack([c.numpy() for c in canvases])
    out[name + "_shape"] = np.stack([s.numpy() for s in shapes])
np.savez(sys.argv[1] + "/tf.npz", **out)
"""

# mtlx's exported function (mtlx/export/exporter.py:130-141), eagerly
_MTLX_FORWARD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[2])
import test_torch_saved_model as t
t.mtlx_forwards(sys.argv[1], sys.argv[3])
"""
# flagship and refine share most of mtlx's compiled primitives; SSD apart
_MTLX_GROUPS = {"mtlx_frcnn": ("flagship", "refine"), "mtlx_ssd": ("ssd",)}


def _objects(values):
    out = np.empty(len(values), object)
    out[:] = values
    return out


@pytest.fixture(scope="module")
def requests(tmp_path_factory):
    """The requests (encoded, as Examples, and each model's canvases from
    the host path), and TF's and mtlx's references started in processes of
    their own, to run beside the export; `wait(kind)` reads one."""
    work = tmp_path_factory.mktemp("saved_models")
    blobs = _host_blobs()
    arrays = {"blobs": _objects(blobs[:len(PICTURES)]),
              "examples": _objects([
                  build_example(blob, fmt.encode(), h, w, f"im{i}", np.zeros((0, 4)), [], [])
                  for i, (blob, ((h, w), fmt)) in enumerate(zip(blobs, PICTURES))])}
    for name in MODELS:
        resizer = FIXED if name == "ssd" else KEEP_ASPECT
        canvases, shapes = zip(*(saved_model.canvas_of(saved_model.decode_image(b), resizer,
                                                       (64, 64)) for b in arrays["blobs"]))
        arrays[name + "_canvas"], arrays[name + "_shape"] = np.stack(canvases), np.stack(shapes)
    np.savez(str(work / "requests.npz"), **arrays)
    np.savez(str(work / "host.npz"), resizers=_objects(_HOST_RESIZERS), blobs=_objects(blobs))
    env = dict(os.environ, PYTHONPATH=REPO, TF_CPP_MIN_LOG_LEVEL="3", CUDA_VISIBLE_DEVICES="")
    tests = os.path.dirname(os.path.abspath(__file__))
    commands = {"tf": [_TF_REFERENCE, str(work)]}
    commands.update({group: [_MTLX_FORWARD, str(work), tests, group] for group in _MTLX_GROUPS})
    procs = {kind: subprocess.Popen([sys.executable, "-c", *args], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for kind, args in commands.items()}

    def wait(kind):
        log = procs[kind].communicate(timeout=300)[0].decode(errors="replace")
        assert procs[kind].returncode == 0, log[-3000:]
        return dict(np.load(str(work / f"{kind}.npz"), allow_pickle=True))

    yield dict(work=work, arrays=arrays, host_blobs=blobs, wait=wait)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------------- the models


def _mtlx_model(name):
    """mtlx's tiny model and its seeded variables."""
    if name == "ssd":
        from mtlx.detector.ssd import SSD as JSSD, SSDConfig as JSSDConfig

        jmodel = JSSD(JSSDConfig(dtype=jnp.float32, **TINY_SSD))
        return jmodel, seeded_variables(jmodel.modules.init, 5, jnp.zeros((1, 64, 64, 3)))
    from mtlx.detector import faster_rcnn as jfr

    jmodel = jfr.FasterRCNN(jfr.FasterRCNNConfig(
        num_classes=20, canvas_size=(64, 64), dtype=jnp.float32,
        mtl=jfr.MTLConfig(**(REFINE if name == "refine" else {})), **graft._TINY_KW))
    seed = 7 if name == "refine" else 3
    return jmodel, seeded_variables(jmodel.modules.init, seed, jnp.zeros((1, 64, 64, 3)))


def mtlx_forwards(work, group):
    """mtlx's forward of each model of the group on its canvases (batch 3),
    eagerly, into `work/<group>.npz`."""
    data = np.load(f"{work}/requests.npz", allow_pickle=True)
    out = {}
    for name in _MTLX_GROUPS[group]:
        jmodel, variables = _mtlx_model(name)
        shapes = jnp.asarray(data[name + "_shape"])
        with jax.disable_jit():
            pre = jmodel.preprocess(jnp.asarray(data[name + "_canvas"]).astype(jnp.float32))
            pred = jmodel.predict(variables, pre, shapes, training=False)
            det = jmodel.postprocess(pred, shapes)
        out.update({f"{name}/{k}": np.asarray(v) for k, v in det.items()
                    if k in ("detection_boxes", "detection_scores", "detection_classes",
                             "num_detections")})
    np.savez(f"{work}/{group}.npz", **out)


def _port_model(name):
    """The port's tiny model with mtlx's seeded weights, and its resizer."""
    jmodel, variables = _mtlx_model(name)
    if name == "ssd":
        from mtlx_torch.detector.ssd import SSD, SSDConfig

        port = SSD(SSDConfig(dtype=torch.float32, **TINY_SSD), device="cpu")
        port.modules.load_state_dict(flax_to_state_dict(variables))
        return port, FIXED
    from mtlx_torch.detector import faster_rcnn as tfr

    refine = name == "refine"
    port = tfr.FasterRCNN(tfr.FasterRCNNConfig(
        num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
        mtl=tfr.MTLConfig(**(REFINE if refine else {})), **graft._TINY_KW), device="cpu")
    port.modules.load_state_dict(flax_to_state_dict(variables, training_heads=refine),
                                 strict=True)
    return port, KEEP_ASPECT


# served in a process of its own that cannot import the port's model code
_SERVE = r"""
import importlib.abc, json, sys
BLOCKED = ("mtlx_torch.detector", "mtlx_torch.builders", "mtlx_torch.backbones",
           "mtlx_torch.heads", "mtlx", "jax")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"serving imported {name}")
        return None

sys.meta_path.insert(0, Block())
import os, time
import numpy as np
import torch
torch.set_num_threads(2)  # as the eager forward it is held to, bit for bit
from mtlx_torch.export import saved_model

work, names = sys.argv[1], sys.argv[2].split(",")
data = np.load(f"{work}/requests.npz", allow_pickle=True)
out, refused = {}, {}
for name in names:
    for _ in range(6000):  # the parent writes the program, then `ready`
        if os.path.exists(f"{work}/{name}/ready"):
            break
        time.sleep(0.05)
    sm = saved_model.load_saved_model(f"{work}/{name}", device="cpu")
    canvas, shape = data[name + "_canvas"], data[name + "_shape"]
    for b in (1, 2, 3):
        got = sm.signatures["serving_default"](canvas[:b], shape[:b])
        out.update({f"{name}/serving_default/{b}/{k}": v for k, v in got.items()})
    calls = (("image_tensor", (canvas, shape)), ("encoded_image_string", (list(data["blobs"]),)),
             ("tf_example", (list(data["examples"]),)))
    for sig, args in calls:
        out.update({f"{name}/{sig}/3/{k}": v for k, v in sm.signatures[sig](*args).items()})
refusals = (("image_tensor", lambda: sm.signatures["image_tensor"](np.zeros((1, 32, 32, 3), np.uint8))),
            ("encoded_image_string", lambda: sm.signatures["encoded_image_string"]([b"GIF89a.."])),
            ("tf_example", lambda: sm.signatures["tf_example"]([b""])),
            ("device", lambda: saved_model.load_saved_model(f"{work}/{name}")))
saved_model.resolve_device = lambda device: torch.device("cuda", 0)  # as if on a card
for what, call in refusals:
    try:
        call()
    except ValueError as e:
        refused[what] = str(e)
np.savez(f"{work}/served.npz", **out)
print(json.dumps({"meta": sm.meta, "signatures": list(sm.signatures), "refused": refused,
                  "modules": sorted(m for m in sys.modules if m.startswith("mtlx_torch"))}))
"""


@pytest.fixture(scope="module")
def exported(requests):
    """Each model exported, then all three served in another process."""
    work = requests["work"]
    proc = subprocess.Popen([sys.executable, "-c", _SERVE, str(work), ",".join(MODELS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO))
    try:
        ports = {}
        for name in MODELS:
            ports[name], resizer = _port_model(name)
            texporter.save_serving_program(ports[name], resizer, str(work / name))
            (work / name / "ready").touch()
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return dict(ports=ports, served=dict(np.load(str(work / "served.npz"))),
                report=json.loads(stdout.strip().splitlines()[-1]))


def _served(exported, name, signature, b):
    prefix = f"{name}/{signature}/{b}/"
    return {k[len(prefix):]: v for k, v in exported["served"].items() if k.startswith(prefix)}


def test_the_serving_process_imports_no_model_code(requests, exported):
    imported = exported["report"]["modules"]
    assert not [m for m in imported
                if m.split(".")[1:2] in (["detector"], ["builders"], ["backbones"], ["heads"])]
    assert "mtlx_torch.kernels.ops" in imported
    with open(requests["work"] / "flagship" / saved_model.PROGRAM_FILE, "rb") as f:
        assert f.read(2) == b"PK"  # one archive: the graph and its frozen weights


@pytest.mark.parametrize("name", MODELS)
def test_program_equals_the_eager_forward(requests, exported, name):
    """Bit for bit at batch 1, 2 and 3, again through image_tensor, and
    through the encoded and tf.Example signatures (which decode the same
    canvases)."""
    canvas = torch.from_numpy(requests["arrays"][name + "_canvas"])
    shape = torch.from_numpy(requests["arrays"][name + "_shape"])
    cases = [("serving_default", b) for b in (1, 2, 3)]
    cases += [(sig, 3) for sig in ("image_tensor", "encoded_image_string", "tf_example")]
    for sig, b in cases:
        got = _served(exported, name, sig, b)
        with torch.no_grad():
            want = texporter.ServingForward(exported["ports"][name])(canvas[:b], shape[:b])
        assert set(got) == set(saved_model.OUTPUTS)
        for key in saved_model.OUTPUTS:
            np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=f"{sig} {b} {key}")
            assert got[key].dtype == np.float32 and got[key].shape[0] == b
    assert (_served(exported, name, "serving_default", 3)["num_detections"] > 0).all()


@pytest.mark.parametrize("name", MODELS)
def test_program_matches_mtlx_forward(requests, exported, name):
    """mtlx's exported function, eagerly, on the same canvases (batch 3)."""
    group = next(g for g, names in _MTLX_GROUPS.items() if name in names)
    want = {k[len(name) + 1:]: v for k, v in requests["wait"](group).items()
            if k.startswith(name + "/")}
    got = _served(exported, name, "serving_default", 3)
    np.testing.assert_array_equal(got["detection_classes"],
                                  (want["detection_classes"] + 1).astype(np.float32))
    np.testing.assert_array_equal(got["num_detections"],
                                  want["num_detections"].astype(np.float32))
    _close(got["detection_boxes"], want["detection_boxes"])
    _close(got["detection_scores"], want["detection_scores"])


@pytest.mark.parametrize("name", [r[0] for r in _HOST_RESIZERS])
def test_host_canvases_equal_tensorflow(requests, name):
    _, resizer, canvas = next(r for r in _HOST_RESIZERS if r[0] == name)
    want = requests["wait"]("tf")
    for i, blob in enumerate(requests["host_blobs"]):
        got, shape = saved_model.canvas_of(saved_model.decode_image(blob), resizer, canvas)
        np.testing.assert_array_equal(shape, want[name + "_shape"][i], err_msg=f"blob {i}")
        np.testing.assert_array_equal(got, want[name + "_canvas"][i], err_msg=f"blob {i}")


def test_loader_refuses_another_device_and_other_inputs(exported):
    """In the serving process: the program's record, the signatures, and
    the errors for other inputs and for another device than the one the
    program was exported for."""
    report = exported["report"]
    assert report["meta"]["device"] == "cpu" and report["meta"]["dtype"] == "float32"
    assert report["meta"]["canvas"] == [64, 64] and report["meta"]["resizer"] == list(FIXED)
    assert report["signatures"] == list(saved_model.SIGNATURES)
    refused = report["refused"]
    assert "uint8 images [B, 64, 64, 3]" in refused["image_tensor"]
    assert "neither a JPEG nor a PNG" in refused["encoded_image_string"]
    assert "image/encoded" in refused["tf_example"]
    assert "exported for cpu" in refused["device"]

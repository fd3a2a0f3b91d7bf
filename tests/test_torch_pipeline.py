"""mtlx_torch's device-side augmentations (data/preprocessor.py) and their
builder against mtlx's.

Each augmentation runs on the same seeded batch in mtlx (eager, vmapped
over the images) and in the port, with JAX's own draws injected: image b
takes step i's key `fold_in(split(rng, B)[b], i)` and each op splits it
as mtlx's does (`jax_draws` below mirrors every op's key use).

Tolerances: masks, true shapes and every integer exact; images and boxes
within 1e-6 of the largest magnitude of mtlx's result. Only the contrast
adjustment's mean differs (XLA sums the canvas in another order: an ulp
or two of the mean); every other op, the HSV round trip and the crop
family included, agrees to the bit on these inputs. random_distort_color
runs the HSV round trip after the contrast, which at a near-grey pixel
turns those ulps into up to 1.1e-6 of the largest magnitude (measured):
it is held within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlx.data import preprocessor as jprep
from mtlx_torch.data import preprocessor as tprep


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# the options that take one uniform an image, and those that take none
_ONE = {"random_horizontal_flip", "random_vertical_flip", "random_rotation90",
        "random_rgb_to_gray", "random_image_scale", "random_adjust_brightness",
        "random_adjust_contrast", "random_adjust_hue", "random_adjust_saturation"}
_NONE = {"normalize_image", "subtract_channel_mean", "resize_image", "random_resize_method",
         "scale_boxes_to_pixel_coordinates"}


def _crop_draws(key, attempts: int = 8):
    """random_crop_image's keep uniform and window uniforms from its key."""
    rk, rw = jax.random.split(key)
    return (float(jax.random.uniform(rk)),
            [[float(jax.random.uniform(q)) for q in jax.random.split(kk, 4)]
             for kk in jax.random.split(rw, attempts)])


def _pad_draws(key, h: int, w: int):
    """random_pad_image's four randint draws from its key."""
    r = jax.random.split(key, 4)
    return [int(jax.random.randint(r[0], (), 0, h + 1)), int(jax.random.randint(r[1], (), 0, w + 1)),
            int(jax.random.randint(r[2], (), 0, h)), int(jax.random.randint(r[3], (), 0, w))]


def jax_draws(name, kwargs, rng, b: int, position: int, hw, num_gt: int):
    """The draws mtlx's batch_preprocess takes for the option at `position`,
    as the port takes them (data/preprocessor.py docstring)."""
    h, w = hw
    keys = [jax.random.fold_in(k, position) for k in jax.random.split(rng, b)]
    if name in _NONE:
        return {}
    if name in _ONE:
        return torch.tensor([float(jax.random.uniform(k)) for k in keys])
    if name == "random_distort_color":
        return torch.tensor([[float(jax.random.uniform(r)) for r in jax.random.split(k, 4)]
                             for k in keys])
    if name == "random_jitter_boxes":
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (num_gt, 4)))
                                          for k in keys]))
    if name == "random_pixel_value_scale":
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (h, w, 3)))
                                          for k in keys]))
    if name == "random_black_patches":
        p = kwargs["max_black_patches"]
        size = int(kwargs["size_to_image_ratio"] * max(h, w))
        do, ys, xs = [], [], []
        for k in keys:
            rows = [jax.random.split(jax.random.fold_in(k, i), 3) for i in range(p)]
            do.append([float(jax.random.uniform(r[0])) for r in rows])
            ys.append([int(jax.random.randint(r[1], (), 0, max(h - size, 1))) for r in rows])
            xs.append([int(jax.random.randint(r[2], (), 0, max(w - size, 1))) for r in rows])
        return {"do": torch.tensor(do), "y": torch.tensor(ys), "x": torch.tensor(xs)}
    if name == "random_pad_image":
        return torch.tensor([_pad_draws(k, h, w) for k in keys])
    out = {"keep": [], "windows": [], "branch": [], "pad": []}
    for k in keys:
        if name.startswith("ssd_"):  # the branch pick, then the crop's key
            keep_branch, ops = tprep.ssd_branches(kwargs.get("operations", ()))
            pick, k = jax.random.split(k)
            out["branch"].append(int(jax.random.randint(pick, (), 0, len(ops) + keep_branch)))
        if name in ("random_crop_pad_image", "ssd_random_crop_pad"):
            k, pad_key = jax.random.split(k)
            out["pad"].append(_pad_draws(pad_key, h, w))
        keep, windows = _crop_draws(k)
        out["keep"].append(keep)
        out["windows"].append(windows)
    return {n: torch.tensor(v, dtype=torch.float32 if n in ("keep", "windows") else torch.int64)
            for n, v in out.items() if v}


def _batch(seed, b: int = 2, hw=(48, 64), g: int = 4):
    """b images of noise (zero beyond their true shapes), 3 boxes each."""
    rs = np.random.RandomState(seed)
    shapes = np.array([[hw[0], hw[1]], [40, 42]][:b], np.int32)
    boxes = np.zeros((b, g, 4), np.float32)
    mask = np.zeros((b, g), bool)
    image = rs.uniform(0, 255, (b, *hw, 3)).astype(np.float32)
    for i in range(b):
        image[i, shapes[i, 0]:] = 0
        image[i, :, shapes[i, 1]:] = 0
        for j in range(3):
            y0, x0 = rs.uniform(0, shapes[i, 0] - 10), rs.uniform(0, shapes[i, 1] - 10)
            boxes[i, j] = [y0, x0, y0 + rs.uniform(5, shapes[i, 0] - y0),
                           x0 + rs.uniform(5, shapes[i, 1] - x0)]
            mask[i, j] = True
    return {"image": image, "boxes": boxes, "classes": np.zeros((b, g), np.int32), "mask": mask,
            "true_shape": shapes}


_CROP = dict(min_object_covered=0.5, min_aspect_ratio=0.75, max_aspect_ratio=1.33, min_area=0.3,
             max_area=1.0, overlap_thresh=0.3, random_coef=0.0)
_PAD_OP = dict(min_object_covered=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_area=0.2,
               max_area=0.9, overlap_thresh=0.4, random_coef=0.0,
               min_padded_size_ratio=(1.0, 1.0), max_padded_size_ratio=(2.0, 2.0),
               pad_color=(1.0, 2.0, 3.0))
# every option of mtlx's TRANSFORMS the port did not have before (the flip
# and ssd_random_crop are held to mtlx in test_torch_losses_labels.py and
# test_torch_live_bn.py), with the parameters the builder passes
NEW_OPS = [
    ("normalize_image", dict(original_minval=0.0, original_maxval=255.0, target_minval=-1.0,
                             target_maxval=1.0)),
    ("random_vertical_flip", {}),
    ("random_pixel_value_scale", dict(minval=0.9, maxval=1.1)),
    ("random_rgb_to_gray", dict(probability=0.5)),
    ("random_adjust_brightness", dict(max_delta=0.2)),
    ("random_adjust_contrast", dict(min_delta=0.8, max_delta=1.25)),
    ("random_adjust_hue", dict(max_delta=0.02)),
    ("random_adjust_saturation", dict(min_delta=0.8, max_delta=1.25)),
    ("random_distort_color", dict(color_ordering=0)),
    ("random_distort_color", dict(color_ordering=1)),
    ("random_jitter_boxes", dict(ratio=0.05)),
    ("random_crop_image", _CROP),
    ("random_black_patches", dict(max_black_patches=10, probability=0.5,
                                  size_to_image_ratio=0.1)),
    ("subtract_channel_mean", dict(means=(10.0, 20.0, 30.0))),
    ("ssd_random_crop_pad", dict(operations=())),
    ("ssd_random_crop_pad", dict(operations=(_PAD_OP,))),
    ("ssd_random_crop_fixed_aspect_ratio", dict(operations=(), aspect_ratio=1.0)),
    ("random_rotation90", {}),
    ("random_image_scale", dict(min_scale_ratio=0.5, max_scale_ratio=2.0)),
    ("random_pad_image", dict(min_image_height=0, min_image_width=0, max_image_height=0,
                              max_image_width=0, pad_color=(10.0, 20.0, 30.0))),
    ("random_crop_pad_image", dict(_CROP, min_padded_size_ratio=(), max_padded_size_ratio=(),
                                   pad_color=())),
    ("random_crop_to_aspect_ratio", dict(aspect_ratio=1.0, overlap_thresh=0.3)),
    ("random_resize_method", dict(target_height=40, target_width=30)),
    ("resize_image", dict(new_height=30, new_width=50, method=3)),
    ("resize_image", dict(new_height=30, new_width=50, method=4)),
    ("scale_boxes_to_pixel_coordinates", {}),
]


def test_every_transform_is_ported():
    assert set(tprep.TRANSFORMS) == set(jprep.TRANSFORMS)
    tested = {n for n, _ in NEW_OPS} | {"random_horizontal_flip", "ssd_random_crop"}
    assert tested == set(jprep.TRANSFORMS)


def _assert_like_mtlx(got, want, name):
    tol = 1e-5 if name == "random_distort_color" else 1e-6
    for key in ("image", "boxes", "mask", "true_shape"):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, (name, key)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {key}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("index", range(len(NEW_OPS)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(NEW_OPS)])
def test_augmentation_matches_mtlx(index):
    name, kwargs = NEW_OPS[index]
    # random_rotation90 acts on a square canvas only
    batch = _batch(index, hw=(48, 48) if name == "random_rotation90" else (48, 64))
    rng = jax.random.PRNGKey(index + 7)
    want = jprep.batch_preprocess(rng, {k: jnp.asarray(v) for k, v in batch.items()},
                                  [(name, kwargs)])
    draws = jax_draws(name, kwargs, rng, 2, 0, batch["image"].shape[1:3], 4)
    got = tprep.batch_preprocess({k: torch.from_numpy(v) for k, v in batch.items()},
                                 [(name, kwargs)], {tprep.draw_key(0): draws})
    _assert_like_mtlx(got, want, name)


def test_draws_have_the_shapes_the_ops_take():
    """make_draws' draws run every op (the generator path of a train step)."""
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(3, hw=(48, 48)).items()}
    for i, (name, kwargs) in enumerate(NEW_OPS):
        draws = tprep.make_draws(name, kwargs, 2, (48, 48), 4, gen)
        out = tprep.batch_preprocess(batch, [(name, kwargs)], {tprep.draw_key(0): draws})
        assert out["image"].shape == batch["image"].shape, name
        assert torch.isfinite(out["image"]).all() and torch.isfinite(out["boxes"]).all(), name


class _NoDropout:
    """A single-shot model without dropout: train_step.make_draws makes
    the augmentations' draws alone."""

    def dropout_shapes(self, batch_size):
        return []


def test_two_flips_draw_twice():
    """Two random_horizontal_flip steps: mtlx keys each by its position, so
    an image ends up flipped with probability 1/2; draws keyed by the
    option's name would flip every image twice (no image changes)."""
    from mtlx_torch.train import train_step as tts

    options = [("random_horizontal_flip", {}), ("random_horizontal_flip", {})]
    batch = _batch(11, b=2)
    batch = {k: np.concatenate([v] * 8) for k, v in batch.items()}  # 16 images
    rng = jax.random.PRNGKey(5)
    want = jprep.batch_preprocess(rng, {k: jnp.asarray(v) for k, v in batch.items()}, options)
    draws = {tprep.draw_key(i): jax_draws(n, kw, rng, 16, i, (48, 64), 4)
             for i, (n, kw) in enumerate(options)}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tprep.batch_preprocess(tensors, options, draws)
    _assert_like_mtlx(got, want, "two flips")
    changed = (got["image"] != tensors["image"]).flatten(1).any(1)
    assert 0 < int(changed.sum()) < 16
    # the train step's own draws: one set a position
    made = tts.make_draws(_NoDropout(), 16, (48, 64), torch.Generator().manual_seed(0), options)
    assert not torch.equal(made[tprep.draw_key(0)], made[tprep.draw_key(1)])
    got = tprep.batch_preprocess(tensors, options, made)
    assert (got["image"] != tensors["image"]).flatten(1).any(1).any()


# every step of mtlx's builder, each field away from its default
_STEPS = """
  data_augmentation_options { normalize_image { original_minval: 1 original_maxval: 254
    target_minval: -1 target_maxval: 2 } }
  data_augmentation_options { random_horizontal_flip {} }
  data_augmentation_options { random_vertical_flip {} }
  data_augmentation_options { random_rotation90 {} }
  data_augmentation_options { random_pixel_value_scale { minval: 0.8 maxval: 1.2 } }
  data_augmentation_options { random_image_scale { min_scale_ratio: 0.6 max_scale_ratio: 1.5 } }
  data_augmentation_options { random_rgb_to_gray { probability: 0.3 } }
  data_augmentation_options { random_adjust_brightness { max_delta: 0.1 } }
  data_augmentation_options { random_adjust_contrast { min_delta: 0.7 max_delta: 1.3 } }
  data_augmentation_options { random_adjust_hue { max_delta: 0.05 } }
  data_augmentation_options { random_adjust_saturation { min_delta: 0.6 max_delta: 1.4 } }
  data_augmentation_options { random_distort_color { color_ordering: 1 } }
  data_augmentation_options { random_jitter_boxes { ratio: 0.1 } }
  data_augmentation_options { random_crop_image { min_object_covered: 0.5 min_aspect_ratio: 0.6
    max_aspect_ratio: 1.6 min_area: 0.2 max_area: 0.9 overlap_thresh: 0.4 random_coef: 0.1 } }
  data_augmentation_options { random_pad_image { min_image_height: 10 min_image_width: 11
    max_image_height: 900 max_image_width: 901 pad_color: 1 pad_color: 2 pad_color: 3 } }
  data_augmentation_options { random_crop_pad_image { min_object_covered: 0.2
    min_padded_size_ratio: 1 min_padded_size_ratio: 1.5 max_padded_size_ratio: 2
    max_padded_size_ratio: 3 pad_color: 4 pad_color: 5 pad_color: 6 random_coef: 0.3 } }
  data_augmentation_options { random_crop_to_aspect_ratio { aspect_ratio: 0.75
    overlap_thresh: 0.5 } }
  data_augmentation_options { random_black_patches { max_black_patches: 4 probability: 0.3
    size_to_image_ratio: 0.2 } }
  data_augmentation_options { random_resize_method { target_height: 300 target_width: 400 } }
  data_augmentation_options { scale_boxes_to_pixel_coordinates {} }
  data_augmentation_options { resize_image { new_height: 200 new_width: 300
    method: NEAREST_NEIGHBOR } }
  data_augmentation_options { subtract_channel_mean { means: 1 means: 2 means: 3 } }
  data_augmentation_options { ssd_random_crop { operations { min_object_covered: 0.3 } } }
  data_augmentation_options { ssd_random_crop_pad {} }
  data_augmentation_options { ssd_random_crop_pad { operations { min_object_covered: 0.1
    min_padded_size_ratio: 1 min_padded_size_ratio: 1 max_padded_size_ratio: 2
    max_padded_size_ratio: 2 pad_color_r: 10 pad_color_g: 20 pad_color_b: 30 } } }
  data_augmentation_options { ssd_random_crop_fixed_aspect_ratio { aspect_ratio: 0.5
    operations { min_object_covered: 0.7 min_area: 0.3 } } }
"""


def test_every_step_builds_equal_to_mtlx():
    from google.protobuf import text_format as pb_text_format
    from mtlx.builders import preprocessor_builder as jbuild
    from mtlx.config.protos import pipeline_pb2
    from mtlx_torch.builders import preprocessor_builder as tbuild
    from mtlx_torch.config import config_util

    text = f"train_config {{ {_STEPS} }}"
    ours = tbuild.build(config_util.parse_pipeline_text(text)
                        .train_config.data_augmentation_options)
    theirs = pb_text_format.Parse(text, pipeline_pb2.TrainEvalPipelineConfig())
    want = jbuild.build(theirs.train_config.data_augmentation_options)
    assert ours == want
    assert {n for n, _ in ours} == set(jprep.TRANSFORMS)

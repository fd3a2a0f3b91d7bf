"""Spatial partitioning and the hybrid mesh of the port
(mtlx_torch/parallel/spatial.py, parallel/distributed.py
create_hybrid_mesh) on the CPU over gloo, held to mtlx.

One group of four spawned processes takes, on the same weights and JAX's
draws:
  * one step of the tiny MTL model of __graft_entry__ (resnet10, 64x64,
    float32) over a (data=2, spatial=2) grid, over the hybrid
    (data_dcn=2, data=2) grid and over four flat ranks, on a global batch
    of 4: the ranks' parameters are bitwise equal in each, and the loss
    (1e-4 relative), every parameter (1e-4 of the tensor's largest
    magnitude) and the sum of |parameter| (1e-4 relative) are mtlx's
    jitted step on the whole batch (tests/test_torch_distributed.py's
    tolerances); every all-gather moves either a halo of at most 5 rows
    or the trunk's output, never the image or an earlier map. mtlx's step
    runs with backbone_remat (nn.remat, which changes no value:
    tests/test_remat.py), and so does the port's step on the whole batch
    in one process, held to it as well;
  * the bucketed batch of tests/test_parallel.py (120x200 padded to
    128x256, batch 2) over (2, 2), against the port's plain step on it in
    one process (which tests/test_torch_train_step.py holds to mtlx);
  * `spatially_sharded_features` at (data=1, spatial=4) on 128x64 images
    against mtlx's (2e-4, mtlx's own tolerance), and the Inception-v2 and
    Inception-ResNet-v2 trunks at (2, 2) against the port's trunk on the
    whole images (1e-5 of the largest magnitude);
  * a live batch norm step with backbone remat over (2, 2) against the
    port's step on the whole batch in one process (loss, parameters and
    moving statistics within 1e-4).
The validation errors of both meshes and the slab-divisibility raise are
tested in one process.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_distributed as two_ranks
from test_torch_rfcn import seeded_variables

LR = 0.01

_GRID_RANK = r"""
import sys
import torch
import torch.distributed as dist
from mtlx_torch.detector.faster_rcnn import FasterRCNN
from mtlx_torch.parallel import distributed, spatial
from mtlx_torch.train import train_step as tts

torch.set_num_threads(1)
data = torch.load(sys.argv[1], weights_only=False)
device, replicas = distributed.init_process_group("cpu")
gathered = []  # the shape of every tensor an all-gather moves
_all_gather = dist.all_gather


def spy(out, x, group=None, **kw):
    gathered.append(tuple(x.shape))
    return _all_gather(out, x, group=group, **kw)


dist.all_gather = spy


def model_of(run):
    model = FasterRCNN(run["cfg"], device="cpu")
    model.modules.load_state_dict(run["weights"], strict=True)
    return model


def step(run, mesh):
    model = model_of(run)
    state = tts.create_train_state(model, tts.make_optimizer(learning_rate=run["lr"]))
    if isinstance(mesh, spatial.SpatialMesh):
        fn = spatial.make_spatial_train_step(model, mesh)
        batch = spatial.shard_batch_spatial(mesh, run["batch"])
    else:
        fn = tts.make_train_step(model, replicas=mesh)
        batch = {k: mesh.rows(v) for k, v in run["batch"].items()}
    draws = {k: mesh.rows(v) for k, v in run["draws"].items()}
    del gathered[:]
    state, metrics = fn(state, batch, draws=draws)
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "state": {k: v.detach().clone() for k, v in model.modules.state_dict().items()},
            "gathered": list(gathered)}


grid = spatial.create_spatial_mesh(2, 2)
column = spatial.create_spatial_mesh(1, 4)
hybrid = distributed.create_hybrid_mesh(num_slices=2)
assert hybrid.axis_names == ("data_dcn", "data") and hybrid.shape == (2, 2)
out = {"spatial": step(data["mtl"], grid), "hybrid": step(data["mtl"], hybrid),
       "flat": step(data["mtl"], replicas), "bucketed": step(data["bucketed"], grid),
       "live_bn": step(data["live_bn"], grid)}
features = data["features"]
del gathered[:]
out["features"] = {"slab": spatial.spatially_sharded_features(
    model_of(features), features["images"], column), "gathered": list(gathered)}
for name in ("inception_v2", "inception_resnet_v2"):
    out[name] = spatial.spatially_sharded_features(model_of(data[name]), data[name]["images"],
                                                   grid)
torch.save(out, f"{sys.argv[2]}.{replicas.rank}")
distributed.destroy_process_group()
"""


def _port_cfg(jcfg, **changes):
    """The port's FasterRCNNConfig of an mtlx one (float32)."""
    import dataclasses

    from mtlx_torch.detector.faster_rcnn import FasterRCNNConfig, MTLConfig

    fields = {f.name for f in dataclasses.fields(FasterRCNNConfig)}
    kw = {k: v for k, v in vars(jcfg).items() if k in fields and k not in ("dtype", "mtl")}
    kw.update(changes)
    return FasterRCNNConfig(**kw, dtype=torch.float32, mtl=MTLConfig(**vars(jcfg.mtl)))


def _mtlx_step(jmodel, variables, batch, rng):
    """mtlx's jitted step on the whole batch: (its metrics, its new
    parameters and statistics as a port state dict)."""
    from mtlx.train import train_step as jts
    from mtlx_torch.bridge import flax_to_state_dict

    tx = jts.make_optimizer(learning_rate=LR)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    new_state, metrics = jax.jit(jts.make_train_step(jmodel))(state, batch, rng)
    new = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                              "batch_stats": new_state.batch_stats})
    return ({k: float(v) for k, v in metrics.items()},
            flax_to_state_dict(new, training_heads=jmodel.cfg.mtl.any))


def _bucketed_case():
    """tests/test_parallel.py's bucketed batch on its config (resnet10 for
    the CPU's time), seeded weights and draws: 2 images of 120x200 padded
    to the 128x256 bucket."""
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from mtlx_torch.train import train_step as tts

    cfg = FasterRCNNConfig(
        num_classes=3, canvas_size=(256, 256), backbone="resnet10", anchor_scales=(0.5, 1.0),
        anchor_aspect_ratios=(1.0,), anchor_base_size=(32.0, 32.0), rpn_depth=16,
        first_stage_pre_nms_top_k=16, first_stage_max_proposals=8,
        first_stage_minibatch_size=16, second_stage_batch_size=8, max_gt_boxes=4,
        dtype=torch.float32)
    model = FasterRCNN(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(2))
    rs = np.random.RandomState(0)
    batch = tts.pad_for_model(model, {
        "image": torch.from_numpy(rs.uniform(0, 255, (2, 120, 200, 3)).astype(np.float32)),
        "true_shape": torch.tensor([[120, 200]] * 2, dtype=torch.int32),
        "gt_boxes": torch.tensor([[[8, 8, 40, 40], [20, 28, 56, 60], [0, 0, 0, 0],
                                   [0, 0, 0, 0]]] * 2, dtype=torch.float32),
        "gt_classes": torch.zeros(2, 4, dtype=torch.int32),
        "gt_mask": torch.tensor([[True, True, False, False]] * 2),
    }, multiple=128)
    assert batch["image"].shape[1:3] == (128, 256)
    draws = tts.make_draws(model, 2, (128, 256), torch.Generator().manual_seed(3))
    return model, batch, draws


def _plain_step(model, batch, draws):
    """The port's step on the whole batch in this process: (metrics, the
    state after it)."""
    from mtlx_torch.train import train_step as tts

    state = tts.create_train_state(model, tts.make_optimizer(learning_rate=LR))
    _, metrics = tts.make_train_step(model)(state, batch, draws=draws)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().clone() for k, v in model.modules.state_dict().items()})


def _features_case():
    """tests/test_parallel.py's features config (resnet10): 2 images of
    128x64."""
    from mtlx.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig

    cfg = FasterRCNNConfig(
        num_classes=3, canvas_size=(128, 64), backbone="resnet10", anchor_scales=(1.0,),
        anchor_aspect_ratios=(1.0,), rpn_depth=16, first_stage_pre_nms_top_k=8,
        first_stage_max_proposals=4, max_gt_boxes=4, dtype=jnp.float32)
    images = np.random.RandomState(0).uniform(-1, 1, (2, 128, 64, 3)).astype(np.float32)
    return FasterRCNN(cfg), images


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Spawn the four ranks, compute the references while they run, and
    return (each rank's results, the references)."""
    import __graft_entry__ as graft
    from mtlx.parallel import spatial as jspatial
    from mtlx_torch.bridge import flax_to_state_dict
    from mtlx_torch.detector.faster_rcnn import FasterRCNN

    tmp = tmp_path_factory.mktemp("grid")
    jmodel = graft._flagship(canvas=(64, 64), dtype=jnp.float32, backbone_remat=True,
                             **graft._TINY_KW)
    dummy = jnp.zeros((1, 64, 64, 3))
    variables = seeded_variables(jmodel.modules.init, 7, dummy)
    batch = two_ranks._global_batch()
    rng = jax.random.PRNGKey(1)
    c = jmodel.cfg
    draws = two_ranks._jax_draws(rng, 4, c.first_stage_max_proposals,
                                 jmodel.anchors_for((64, 64)).shape[0])
    weights = flax_to_state_dict(variables, training_heads=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mtl = {"cfg": _port_cfg(c, backbone_remat=False), "weights": weights, "batch": tb,
           "draws": draws, "lr": LR}

    bmodel, bbatch, bdraws = _bucketed_case()
    bucketed = {"cfg": bmodel.cfg, "batch": bbatch, "draws": bdraws, "lr": LR,
                "weights": {k: v.clone() for k, v in bmodel.modules.state_dict().items()}}

    fmodel, fimages = _features_case()
    fvars = seeded_variables(fmodel.modules.init, 9, dummy)
    features = {"cfg": _port_cfg(fmodel.cfg), "weights": flax_to_state_dict(fvars),
                "images": torch.from_numpy(fimages)}

    live_bn = dict(mtl, cfg=_port_cfg(c, batch_norm_trainable=True))

    trunks = {}
    for seed, name in enumerate(("inception_v2", "inception_resnet_v2")):
        model = FasterRCNN(_port_cfg(fmodel.cfg, backbone=name), device="cpu")
        model.init_weights(torch.Generator().manual_seed(seed))
        trunks[name] = {"cfg": model.cfg, "images": torch.from_numpy(fimages),
                        "weights": {k: v.clone() for k, v in model.modules.state_dict().items()},
                        "model": model}
    data = str(tmp / "data.pt")
    torch.save({"mtl": mtl, "bucketed": bucketed, "features": features, "live_bn": live_bn,
                **{k: {f: v for f, v in t.items() if f != "model"} for k, t in trunks.items()}},
               data)
    out = str(tmp / "out.pt")
    port = two_ranks._free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GRID_RANK, data, out],
                              env=two_ranks._env(r, 4, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        ref = {"mtl": _mtlx_step(jmodel, variables, batch, rng),
               "bucketed": _plain_step(bmodel, bbatch, bdraws)}
        smesh = jspatial.create_spatial_mesh(1, 4)
        ref["features"] = np.asarray(jspatial.spatially_sharded_features(
            fmodel, fvars, jnp.asarray(fimages), smesh))
        # the live batch norm step in one process, without remat
        model = FasterRCNN(_port_cfg(c, batch_norm_trainable=True, backbone_remat=False),
                           device="cpu")
        model.modules.load_state_dict(weights)
        ref["live_bn"] = _plain_step(model, tb, draws)
        # mtlx's model in one process, with remat
        model = FasterRCNN(_port_cfg(c), device="cpu")
        assert model.modules.backbone.block1.remat and model.modules.classifier_backbone.block4.remat
        model.modules.load_state_dict(weights)
        ref["remat"] = _plain_step(model, tb, draws)
        for name, trunk in trunks.items():
            with torch.no_grad():
                ref[name] = trunk["model"].modules.eval().backbone(trunk["images"]).numpy()
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, logs
    return [torch.load(f"{out}.{r}") for r in range(4)], ref


def _assert_step_equal(got, want, keys=None):
    metrics, params = want
    for key in keys or metrics:
        np.testing.assert_allclose(float(got["metrics"][key]), metrics[key], rtol=1e-4,
                                   err_msg=key)
    state = got["state"]
    for name, w in params.items():
        w = w.numpy()
        np.testing.assert_allclose(state[name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30), err_msg=name)
    got_sum = sum(float(state[k].double().abs().sum()) for k in params)
    want_sum = sum(float(np.abs(v.numpy().astype(np.float64)).sum()) for v in params.values())
    assert abs(got_sum - want_sum) <= 1e-4 * want_sum, (got_sum, want_sum)


@pytest.mark.parametrize("run", ["spatial", "hybrid", "flat", "bucketed", "live_bn"])
def test_grid_ranks_bitwise_equal(grid, run):
    ranks, _ = grid
    for other in ranks[1:]:
        for name, value in ranks[0][run]["state"].items():
            assert torch.equal(value, other[run]["state"][name]), (run, name)
        for name, value in ranks[0][run]["metrics"].items():
            assert torch.equal(value, other[run]["metrics"][name]), (run, name)


@pytest.mark.parametrize("run", ["spatial", "hybrid", "flat"])
def test_grid_step_equals_mtlx_global_step(grid, run):
    ranks, ref = grid
    _assert_step_equal(ranks[0][run], ref["mtl"])


def test_remat_step_equals_mtlx_remat_step(grid):
    _, ref = grid
    metrics, params = ref["remat"]
    _assert_step_equal({"metrics": {k: torch.tensor(v) for k, v in metrics.items()},
                        "state": params}, ref["mtl"])


def test_hybrid_equals_flat(grid):
    ranks, _ = grid
    flat = ranks[0]["flat"]
    want = ({k: float(v) for k, v in flat["metrics"].items()}, flat["state"])
    _assert_step_equal(ranks[0]["hybrid"], want)


def test_spatial_bucketed_step_equals_plain_step(grid):
    ranks, ref = grid
    _assert_step_equal(ranks[0]["bucketed"], ref["bucketed"])


def test_live_batch_norm_remat_step_under_spatial(grid):
    ranks, ref = grid
    got = ranks[0]["live_bn"]
    _assert_step_equal(got, ref["live_bn"])
    # the moving statistics moved, once
    moved = [k for k, v in ref["live_bn"][1].items() if k.endswith(".mean") and v.abs().sum()]
    assert moved, "no live batch norm committed its statistics"


def test_spatially_sharded_features_equal_mtlx(grid):
    ranks, ref = grid
    want = ref["features"]  # [2, 8, 4, 1024], the whole map
    for r, out in enumerate(ranks):
        slab = out["features"]["slab"].numpy()
        assert slab.shape == (2, 2, 4, 1024)
        np.testing.assert_allclose(slab, want[:, 2 * r:2 * r + 2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["inception_v2", "inception_resnet_v2"])
def test_inception_trunks_split_over_slabs(grid, name):
    """The Inception trunks pad through the same halo helpers: each rank of
    (data=2, spatial=2) holds its data row's image's slab of the map."""
    ranks, ref = grid
    want = ref[name]  # [2, 8, 4, C]
    for r, out in enumerate(ranks):
        d, s = divmod(r, 2)
        np.testing.assert_allclose(out[name].numpy(), want[d:d + 1, 4 * s:4 * s + 4],
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("run", ["spatial", "bucketed", "live_bn"])
def test_only_halos_and_the_trunk_output_are_gathered(grid, run):
    """Every all-gather of a spatial step moves an NCHW halo of at most 5
    rows (a 7x7/2 conv's 3 above and 2 below) or the trunk's NHWC output
    slab, once; never the image's slab or a map before the trunk's end."""
    ranks, _ = grid
    out = ranks[0][run]
    trunk = [s for s in out["gathered"] if s[-1] == 1024 and len(s) == 4 and s[1] != 1024]
    halos = [s for s in out["gathered"] if s not in trunk]
    b, h = (1, 64) if run == "bucketed" else (2, 32)  # each data row's images, slab rows
    width = 256 if run == "bucketed" else 64
    assert trunk == [(b, h // 16, width // 16, 1024)], out["gathered"]
    assert halos and all(s[2] <= 5 < h for s in halos), halos


def test_spatial_mesh_validation():
    from mtlx_torch.parallel import spatial
    from mtlx_torch.parallel.distributed import Replicas

    few = Replicas(rank=0, world_size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="need 4 ranks, have 2"):
        spatial.create_spatial_mesh(2, 2, few)
    many = Replicas(rank=0, world_size=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="every rank"):
        spatial.create_spatial_mesh(2, 2, many)


def test_hybrid_mesh_validation(monkeypatch):
    from mtlx_torch.parallel.distributed import Replicas, create_hybrid_mesh

    ranks = Replicas(rank=0, world_size=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="slices"):
        create_hybrid_mesh(num_slices=3, replicas=ranks)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="num_slices"):
        create_hybrid_mesh(replicas=ranks)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="uneven slices"):
        create_hybrid_mesh(replicas=ranks)


def test_slabs_fall_on_the_trunk_stride():
    """A kept difference: mtlx shards a bucket of any height (GSPMD pads
    the shards); the port's slab boundaries fall on the trunk's stride, so
    a 96-row bucket over 4 slabs raises (24 rows, not a multiple of 16)."""
    from mtlx.parallel import spatial as jspatial
    from mtlx_torch.parallel import spatial

    batch = {"image": np.zeros((2, 96, 64, 3), np.float32),
             "gt_mask": np.ones((2, 4), bool)}
    sharded = jspatial.shard_batch_spatial(jspatial.create_spatial_mesh(2, 4), batch)
    assert sharded["image"].shape == (2, 96, 64, 3)  # mtlx takes it
    mesh = spatial.SpatialMesh(rank=5, world_size=8, device=torch.device("cpu"), n_data=2,
                               n_spatial=4, spatial_group=None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="multiple of 64"):
        spatial.shard_batch_spatial(mesh, tb)
    tb["image"] = torch.zeros(2, 128, 64, 3)
    out = spatial.shard_batch_spatial(mesh, tb)  # rank 5: data row 1, slab 1
    assert out["image"].shape == (1, 32, 64, 3) and out["gt_mask"].shape == (1, 4)

"""Data parallelism of the port (mtlx_torch/parallel/distributed.py, the
loader's record shard and the train CLI's --distributed) on the CPU over
gloo, held to mtlx.

  * the loader's shards [p::P] hold mtlx's records;
  * two ranks, each a spawned process, take one step of the tiny MTL
    model of __graft_entry__ (resnet10, 64x64, float32) on their halves of
    a global batch of 4 whose halves hold different numbers of valid boxes
    (so the multi-object and closeness terms, whose denominator is the
    count over the whole batch, show whether the ranks share it), with
    JAX's draws for the global batch: the ranks' parameters are bitwise
    equal, and the loss, every parameter (rtol 1e-4 of the tensor's
    largest magnitude, as tests/test_torch_train_step.py) and the sum of
    |parameter| are within 1e-4 relative of mtlx's jitted single-process
    step on the whole batch (mtlx's own cross-program tolerance,
    __graft_entry__._collect_mp_children);
  * the train CLI under `torch.distributed.run --nproc_per_node=2` with
    `--device cpu`: rank 0 alone prints, writes checkpoints and event
    files; the first step's loss equals a one-process run's on the same
    global batch (1e-4 relative), and a second launch resumes from the
    checkpoint.
"""

import ast
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _records(path: str, n: int):
    from mtlx_torch.data import imgcodec, tfrecord
    from mtlx_torch.data.example_decoder import build_example

    rs = np.random.RandomState(0)
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            arr = rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)
            k = 1 + i % 3  # 1-3 boxes: the ranks' rows hold different counts
            boxes = (np.asarray([[8, 8, 28, 36]], np.float32) / 64
                     + np.arange(k, dtype=np.float32)[:, None] * 0.1)
            w.write(build_example(imgcodec.encode_png(arr), b"png", 64, 64, f"im{i}.png",
                                  boxes, [1 + i % 3] * k, ["abc"[i % 3]] * k))
    return path


@pytest.mark.parametrize("count", [2, 3])
def test_record_shards_equal_mtlx(tmp_path, count):
    from mtlx.data.loader import DetectionDataset as JDataset
    from mtlx_torch.data.loader import DetectionDataset as TDataset

    paths = [_records(str(tmp_path / f"r{j}.record"), 5 + j) for j in range(2)]
    kw = dict(canvas_size=(64, 64), resizer=("fixed", {"height": 64, "width": 64}),
              max_boxes=4)
    seen = []
    for index in range(count):
        port = TDataset(paths, process_index=index, process_count=count, **kw)
        ref = JDataset(paths, process_index=index, process_count=count, **kw)
        assert port._files == ref._files
        assert [port.get(i)["source_id"] for i in range(len(port))] == \
            [ref.get(i)["source_id"] for i in range(len(ref))]
        seen += port._files
        port.close()
    assert sorted(seen) == sorted(TDataset(paths, **kw)._files)  # every record once


# one rank of the two-rank step: loads the model, batch and draws the
# test wrote, takes its rows through make_train_step and saves what it got
_RANK_STEP = r"""
import sys
import torch
from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig, MTLConfig
from mtlx_torch.parallel import distributed
from mtlx_torch.train import train_step as tts

torch.set_num_threads(1)
data = torch.load(sys.argv[1], weights_only=False)
device, replicas = distributed.init_process_group("cpu")
cfg = FasterRCNNConfig(num_classes=20, canvas_size=(64, 64), dtype=torch.float32,
                       mtl=MTLConfig(multiobject=True, closeness=True, foreground=True),
                       **data["tiny_kw"])
model = FasterRCNN(cfg, device="cpu")
model.modules.load_state_dict(data["weights"], strict=True)
state = tts.create_train_state(model, tts.make_optimizer(learning_rate=data["lr"]))
batch = {k: replicas.rows(v) for k, v in data["batch"].items()}
draws = {k: replicas.rows(v) for k, v in data["draws"].items()}
state, metrics = tts.make_train_step(model, replicas=replicas)(state, batch, draws=draws)
torch.save({"metrics": {k: v.clone() for k, v in metrics.items()},
            "params": {k: v.detach().clone() for k, v in model.modules.state_dict().items()}},
           f"{sys.argv[2]}.{replicas.rank}")
distributed.destroy_process_group()
"""


def _jax_draws(rng, batch_size, num_proposals, num_anchors):
    """The uniforms mtlx's train step draws at step 0, keyed as the port's."""
    rng_predict, rng_loss = jax.random.split(jax.random.fold_in(rng, 0))

    def sampler_draws(key, n):
        pos, neg = [], []
        for k in jax.random.split(key, batch_size):
            kp, kn = jax.random.split(k)
            pos.append(np.asarray(jax.random.uniform(kp, (n,))))
            neg.append(np.asarray(jax.random.uniform(kn, (n,))))
        return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))

    d = {}
    d["proposal_pos"], d["proposal_neg"] = sampler_draws(rng_predict, num_proposals)
    d["anchor_pos"], d["anchor_neg"] = sampler_draws(rng_loss, num_anchors)
    return d


def _randomize(variables, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rs.normal(0, 0.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _global_batch():
    """4 images; rank 0's rows hold 4 + 3 valid boxes, rank 1's 1 + 2.
    Boxes stay off the canvas edge (jitted mtlx moves a crop sample on the
    map's last row out of range by an ulp: ROADMAP.md queue 3)."""
    rs = np.random.RandomState(0)
    z = [0, 0, 0, 0]
    return {
        "image": rs.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
        "true_shape": np.asarray([[56, 60], [48, 56], [60, 52], [52, 60]], np.int32),
        "gt_boxes": np.asarray([
            [[2, 3, 54, 58], [20, 10, 50, 45], [4, 30, 30, 50], [10, 4, 40, 20]],
            [[4, 4, 44, 50], [10, 20, 30, 40], [24, 6, 46, 30], z],
            [[6, 8, 50, 44], z, z, z],
            [[3, 5, 40, 30], [20, 22, 48, 50], z, z]], np.float32),
        "gt_classes": np.asarray([[1, 3, 3, 7], [19, 0, 5, 0], [2, 0, 0, 0], [4, 11, 0, 0]],
                                 np.int32),
        "gt_mask": np.asarray([[1, 1, 1, 1], [1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 0, 0]], bool),
    }


def test_two_rank_step_equals_mtlx_global_step(tmp_path):
    import __graft_entry__ as graft
    from mtlx.train import train_step as jts
    from mtlx_torch.bridge import flax_to_state_dict
    from mtlx_torch.labels import recycle

    jmodel = graft._flagship(canvas=(64, 64), dtype=jnp.float32, **graft._TINY_KW)
    variables = _randomize(jmodel.init_variables(jax.random.PRNGKey(0)), 7)
    batch = _global_batch()
    rng = jax.random.PRNGKey(1)
    c = jmodel.cfg
    draws = _jax_draws(rng, 4, c.first_stage_max_proposals, jmodel.anchors_for((64, 64)).shape[0])
    tx = jts.make_optimizer(learning_rate=LR)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    new_state, jmetrics = jax.jit(jts.make_train_step(jmodel))(state, batch, rng)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}), training_heads=True)

    # the halves hold different counts of valid closeness boxes
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    labels = recycle.closeness_labels(tb["gt_boxes"], tb["gt_classes"].long(), tb["gt_mask"],
                                      20, c.mtl.closeness_sigma)
    valid = (tb["gt_mask"] & (labels.sum(-1) > 0)).sum(-1)
    assert int(valid[:2].sum()) != int(valid[2:].sum()), valid

    data = str(tmp_path / "data.pt")
    torch.save({"weights": flax_to_state_dict(variables, training_heads=True), "batch": tb,
                "draws": draws, "tiny_kw": graft._TINY_KW, "lr": LR}, data)
    out = str(tmp_path / "out.pt")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_STEP, data, out],
                              env=_env(r, 2, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(f"{out}.{r}") for r in range(2)]

    # the ranks agree bit for bit
    for name, value in ranks[0]["params"].items():
        assert torch.equal(value, ranks[1]["params"][name]), name
    for name, value in ranks[0]["metrics"].items():
        assert torch.equal(value, ranks[1]["metrics"][name]), name
    # and with mtlx's step on the whole batch
    for key, w in jmetrics.items():
        np.testing.assert_allclose(float(ranks[0]["metrics"][key]), float(w), rtol=1e-4,
                                   err_msg=key)
    params = ranks[0]["params"]
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(params[name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30), err_msg=name)
    got_sum = sum(float(v.double().abs().sum()) for k, v in params.items() if k in want)
    want_sum = sum(float(np.abs(v.numpy().astype(np.float64)).sum()) for v in want.values())
    assert abs(got_sum - want_sum) <= 1e-4 * want_sum, (got_sum, want_sum)


def _cli_config(workdir) -> str:
    """tests/test_end_to_end.py's pipeline (ResNet-50 MTL, batch 2) at
    64x64 on eight PNG records."""
    with open(os.path.join(_REPO, "tests", "test_end_to_end.py")) as f:
        tree = ast.parse(f.read())
    text = next(n.value.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "CONFIG")
    text = text.replace("height: 96 width: 96", "height: 64 width: 64")
    record = _records(str(workdir / "train.record"), 8)
    label_map = str(workdir / "label_map.pbtxt")
    with open(label_map, "w") as f:
        for i, name in enumerate("abc"):
            f.write(f"item {{ id: {i + 1} name: '{name}' }}\n")
    path = str(workdir / "pipeline.config")
    with open(path, "w") as f:
        f.write(text.format(record=record, label_map=label_map))
    return path


def _run_distributed(config, train_dir, num_steps):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
           f"--master_port={_free_port()}", "-m", "mtlx_torch.train.train", "--distributed",
           "--device", "cpu", "--pipeline_config_path", config, "--train_dir", train_dir,
           "--num_steps", str(num_steps), "--log_every", "1", "--deterministic"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300, cwd=_REPO)
    assert run.returncode == 0, run.stdout + run.stderr
    return run.stdout


def _losses(out: str):
    import json

    lines = [json.loads(ln[8:]) for ln in out.splitlines() if ln.startswith("[train] {")]
    return [(ln["step"], ln["total_loss"]) for ln in lines]


def test_train_cli_two_ranks_write_on_rank_0_and_resume(tmp_path, capsys):
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli

    config = _cli_config(tmp_path)
    train_dir = str(tmp_path / "train")
    out = _run_distributed(config, train_dir, 2)
    # one process prints: each step once, one end line
    assert [s for s, _ in _losses(out)] == [1, 2], out
    assert out.count("[train] done at step 2") == 1, out
    assert "world size 2 over gloo, 1 a rank" in out
    assert ckpt_lib.CheckpointManager(train_dir).all_steps() == [2]
    events = [f for f in os.listdir(train_dir) if f.startswith("events.out.tfevents")]
    assert len(events) == 1, events

    # the same global batch in one process: rank r reads records [r::2] in
    # order, so step 1's global batch is records 0 and 1 either way. Step 1
    # only: the pipeline computes in bfloat16, where the gradients of a
    # batch of one and of two differ at bfloat16's precision, so step 2
    # starts from parameters that differ by more than 1e-4
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        train_cli.main(["--pipeline_config_path", config, "--train_dir",
                        str(tmp_path / "single"), "--num_steps", "1", "--log_every", "1",
                        "--deterministic", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    (step, want), = _losses(capsys.readouterr().out)
    assert _losses(out)[0][1] == pytest.approx(want, rel=1e-4)

    # a second launch resumes from rank 0's checkpoint
    out = _run_distributed(config, train_dir, 3)
    assert out.count("[train] resumed from step 2") == 1, out
    assert [s for s, _ in _losses(out)] == [3]
    assert ckpt_lib.CheckpointManager(train_dir).all_steps() == [2, 3]
    events = [f for f in os.listdir(train_dir) if f.startswith("events.out.tfevents")]
    assert len(events) == 2, events
    # the checkpoints of a full-width R50: pytest keeps each run's tmp_path
    shutil.rmtree(tmp_path)


def test_per_rank_batch_raises_when_ranks_do_not_divide():
    from mtlx_torch.parallel.distributed import Replicas

    r = Replicas(rank=1, world_size=4, device=torch.device("cpu"))
    assert r.per_rank_batch(16) == 4
    assert r.rows(torch.arange(16)).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not divide"):
        r.per_rank_batch(6)

"""mtlx_torch imports neither JAX nor anything of mtlx, reads pipeline
files and label maps without protobuf and PIL, and converts a TF
checkpoint without TensorFlow.

Checked in a subprocess: tests/conftest.py has already imported jax into
the pytest process, so only a fresh interpreter can show what importing
the port loads.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import mtlx_torch
names = [m.name for m in pkgutil.walk_packages(mtlx_torch.__path__, "mtlx_torch.")]
for name in names:
    importlib.import_module(name)
# the lazy paths too: parsing a pipeline file and a label map, building
# the model config
import os, tempfile
from mtlx_torch.config import config_util
from mtlx_torch.builders import model_builder
from mtlx_torch.utils import label_map_util
configs = config_util.get_configs_from_pipeline_file(
    sys.argv[1] + "/configs/faster_rcnn_resnet50_mtl_voc0712.config")
model_builder.build_config(configs["model"], is_training=False)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "label_map.pbtxt")
    with open(path, "w") as f:
        f.write("item { id: 1 name: 'aeroplane' } item { id: 2 name: 'bicycle' }")
    assert label_map_util.get_label_map_dict(path) == {"aeroplane": 1, "bicycle": 2}
    # a TF checkpoint read and converted (chip_smoke.py's writer makes it)
    import numpy as np
    import chip_smoke
    from mtlx_torch.tools import convert_checkpoint
    prefix = os.path.join(tmp, "model.ckpt")
    chip_smoke.write_tf_checkpoint(prefix, {"resnet_v1_50/conv1/weights":
                                            np.ones((7, 7, 3, 64), np.float32)}, 1)
    assert convert_checkpoint.convert(prefix, "classification", 50)[1:] == (1, 0)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "mtlx", "PIL",
                                    "tensorflow")
             or m == "google.protobuf" or m.startswith("google.protobuf."))
print(len(names), bad)
"""


def test_port_loads_no_jax_and_no_mtlx():
    # -I: no PYTHONPATH and no user site, so nothing but the probe can
    # bring jax in; the probe puts the repo on the path itself
    res = subprocess.run(
        [sys.executable, "-I", "-c", _PROBE, _REPO], cwd=_REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 83, res.stdout  # every module of the port was imported
    assert bad == "[]", f"mtlx_torch loaded {bad}"

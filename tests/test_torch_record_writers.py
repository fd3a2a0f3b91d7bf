"""The port's dataset record writers (mtlx_torch/data/voc.py, coco.py,
pet.py) and their CLIs (mtlx_torch/tools/create_{pascal,coco,pet}_tf_record.py)
against mtlx's on tiny devkits that the test writes.

Exact: the same number of records, and each record parses to mtlx's
message (`Example.FromString(port) == mtlx's`): difficult objects kept
or dropped (--ignore_difficult_instances), absent truncated / pose
fields, crowd annotations dropped or kept in the difficult field
(--include_crowd), boxes past the image clipped, --max_examples, a
missing image file (COCO) and a missing XML (Pet) skipped, `--year
merged`, a label map file in place of the defaults; the label map files
the CLIs write and the ones the port keeps equal to mtlx's, byte for
byte. The records decode through the port's reader.
"""

import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
from PIL import Image

from mtlx.config.protos import example_pb2
from mtlx.data import coco as jcoco
from mtlx.data import pet as jpet
from mtlx.data import voc as jvoc
from mtlx_torch.data import coco as tcoco
from mtlx_torch.data import pet as tpet
from mtlx_torch.data import voc as tvoc
from mtlx_torch.data.example_decoder import decode_example, parse_features
from mtlx_torch.data.tfrecord import read_records
from mtlx_torch.tools import create_coco_tf_record as tcoco_cli
from mtlx_torch.tools import create_pascal_tf_record as tvoc_cli
from mtlx_torch.tools import create_pet_tf_record as tpet_cli
from mtlx_torch.utils import label_map_util

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(rs, h, w):
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def _voc_xml(filename, h, w, objects):
    parts = [f"<annotation><folder>VOC</folder><filename>{filename}</filename>"
             f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
    for i, (name, box, difficult) in enumerate(objects):
        extra = "" if i == 1 else f"<pose>Left</pose><truncated>{(i // 2 + 1) % 2}</truncated>"
        diff = "" if difficult is None else f"<difficult>{difficult}</difficult>"
        parts.append(f"<object><name>{name}</name>{extra}{diff}<bndbox>"
                     f"<xmin>{box[1]}</xmin><ymin>{box[0]}</ymin><xmax>{box[3]}</xmax>"
                     f"<ymax>{box[2]}</ymax></bndbox></object>")
    return "".join(parts) + "</annotation>"


def _objects(rs, names, h, w, k):
    out = []
    for _ in range(k):
        y0, x0 = rs.randint(0, h // 2), rs.randint(0, w // 2)
        box = (y0, x0, y0 + rs.randint(2, h // 2), x0 + rs.randint(2, w // 2))
        out.append((names[rs.randint(len(names))], box, [None, 0, 1][rs.randint(3)]))
    return out


def _write_voc(root, rs, n=5):
    for year in ("VOC2007", "VOC2012"):
        d = os.path.join(root, year)
        for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
            os.makedirs(os.path.join(d, sub))
        ids = []
        for i in range(n):
            h, w = [(24, 32), (30, 20)][i % 2]
            ex_id = f"{year[-4:]}_{i:06d}"
            ids.append(ex_id)
            with open(os.path.join(d, "JPEGImages", f"{ex_id}.jpg"), "wb") as f:
                f.write(_jpeg(rs, h, w))
            with open(os.path.join(d, "Annotations", f"{ex_id}.xml"), "w") as f:
                f.write(_voc_xml(f"{ex_id}.jpg", h, w,
                                 _objects(rs, jvoc.VOC_CLASSES, h, w, i % 4)))
        with open(os.path.join(d, "ImageSets", "Main", "train.txt"), "w") as f:
            f.write("".join(f"{e} {1 - 2 * (j % 2)}\n" for j, e in enumerate(ids)))


def _write_coco(root, rs, n=6):
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir)
    cats = [{"id": i, "name": f"cat{i}"} for i in (1, 3, 17, 90)]
    images, anns = [], []
    for i in range(n):
        h, w = [(24, 32), (30, 20)][i % 2]
        images.append({"id": 100 + i, "file_name": f"{i:012d}.jpg", "height": h, "width": w})
        if i != 2:  # image 2's file is missing
            with open(os.path.join(images_dir, f"{i:012d}.jpg"), "wb") as f:
                f.write(_jpeg(rs, h, w))
        for j in range(i % 4):
            x, y = float(rs.uniform(-3, w - 2)), float(rs.uniform(-3, h - 2))
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": cats[rs.randint(len(cats))]["id"],
                         "bbox": [x, y, float(rs.uniform(1, w)), float(rs.uniform(1, h))],
                         "iscrowd": int(j == 1)})
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path, images_dir


def _write_pet(root, rs, n=6):
    for sub in ("images", "annotations/xmls"):
        os.makedirs(os.path.join(root, sub))
    ids = []
    for i in range(n):
        breed = jpet.PET_CLASSES[(7 * i) % len(jpet.PET_CLASSES)]
        ex_id = f"{breed}_{i + 1}"
        ids.append(ex_id)
        h, w = [(24, 32), (30, 20)][i % 2]
        with open(os.path.join(root, "images", f"{ex_id}.jpg"), "wb") as f:
            f.write(_jpeg(rs, h, w))
        if i == 3:
            continue  # annotated subset: this one has no XML
        kind = "cat" if breed[0].isupper() else "dog"
        with open(os.path.join(root, "annotations", "xmls", f"{ex_id}.xml"), "w") as f:
            f.write(_voc_xml(f"{ex_id}.jpg", h, w, _objects(rs, [kind], h, w, 1 + i % 2)))
    for split in ("trainval", "test"):
        with open(os.path.join(root, "annotations", f"{split}.txt"), "w") as f:
            f.write("".join(f"{e} 1 1 1\n" for e in ids))


def _records_equal(port_path, mtlx_path):
    port = list(read_records(port_path, verify_crc=True))
    ref = list(read_records(mtlx_path, verify_crc=True))
    assert len(port) == len(ref) and port
    for p, r in zip(port, ref):
        assert example_pb2.Example.FromString(p) == example_pb2.Example.FromString(r)
        decoded = decode_example(p)
        assert decoded["image"].ndim == 3
    return port


def _run_mtlx_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(_REPO, "tools", name), run_name="__main__")


@pytest.mark.parametrize("ignore_difficult", [False, True])
def test_voc_writer_equal_mtlx(tmp_path, ignore_difficult):
    _write_voc(str(tmp_path / "devkit"), np.random.RandomState(0))
    devkit = str(tmp_path / "devkit")
    for year in ("VOC2007", "VOC2012"):
        port, ref = str(tmp_path / f"p{year}"), str(tmp_path / f"m{year}")
        n = tvoc.create_voc_tf_record(devkit, port, "train", year,
                                      ignore_difficult_instances=ignore_difficult)
        assert n == jvoc.create_voc_tf_record(devkit, ref, "train", year,
                                              ignore_difficult_instances=ignore_difficult) == 5
        _records_equal(port, ref)
    # parse_annotation / annotation_to_example on their own
    xml = str(tmp_path / "devkit" / "VOC2007" / "Annotations" / "2007_000003.xml")
    data = tvoc.parse_annotation(xml)
    assert data == jvoc.parse_annotation(xml) and len(data["object"]) == 3
    port_ex = tvoc.annotation_to_example(data, b"x", {n: i for i, n in
                                                      enumerate(tvoc.VOC_CLASSES, 1)},
                                         ignore_difficult)
    ref_ex = jvoc.annotation_to_example(data, b"x", {n: i for i, n in
                                                     enumerate(jvoc.VOC_CLASSES, 1)},
                                        ignore_difficult)
    assert example_pb2.Example.FromString(port_ex) == ref_ex


def test_pascal_cli_equal_mtlx(tmp_path, monkeypatch, capsys):
    devkit = str(tmp_path / "devkit")
    _write_voc(devkit, np.random.RandomState(1))
    label_map = str(tmp_path / "voc_map.pbtxt")
    with open(label_map, "w") as f:  # other ids than the defaults
        f.writelines(f"item {{ id: {i + 3} name: '{n}' }}\n" for i, n in enumerate(tvoc.VOC_CLASSES))
    common = ["--data_dir", devkit, "--set", "train", "--year", "merged",
              "--label_map_path", label_map, "--ignore_difficult_instances"]
    assert tvoc_cli.main(common + ["--output_path", str(tmp_path / "port.record"),
                                   "--write_label_map", str(tmp_path / "port_map.pbtxt")]) == 10
    assert "wrote 10 examples" in capsys.readouterr().out
    _run_mtlx_tool("create_pascal_tf_record.py",
                   common + ["--output_path", str(tmp_path / "mtlx.record"),
                             "--write_label_map", str(tmp_path / "mtlx_map.pbtxt")], monkeypatch)
    assert "wrote 10 examples" in capsys.readouterr().out
    for year in ("VOC2007", "VOC2012"):
        records = _records_equal(str(tmp_path / f"port.record.{year}"),
                                 str(tmp_path / f"mtlx.record.{year}"))
        labels = [decode_example(r)["groundtruth_classes"] for r in records]
        assert min(int(c.min()) for c in labels if c.size) >= 3  # the file's ids
    assert (tmp_path / "port_map.pbtxt").read_bytes() == (tmp_path / "mtlx_map.pbtxt").read_bytes()


@pytest.mark.parametrize("include_crowd,max_examples", [(False, None), (True, 3)])
def test_coco_writer_and_cli_equal_mtlx(tmp_path, monkeypatch, capsys, include_crowd,
                                        max_examples):
    ann, images = _write_coco(str(tmp_path), np.random.RandomState(2))
    n = tcoco.create_coco_tf_record(ann, images, str(tmp_path / "p.record"), include_crowd,
                                    max_examples)
    assert n == jcoco.create_coco_tf_record(ann, images, str(tmp_path / "m.record"),
                                            include_crowd, max_examples)
    assert n == (3 if max_examples else 5)  # image 2's file is missing
    records = _records_equal(str(tmp_path / "p.record"), str(tmp_path / "m.record"))
    crowd = np.concatenate([decode_example(r)["groundtruth_difficult"] for r in records])
    assert bool(crowd.any()) == include_crowd
    boxes = np.concatenate([decode_example(r)["groundtruth_boxes"] for r in records])
    assert boxes.min() == 0.0 and boxes.max() <= 1.0  # clipped
    flags = ["--annotations_file", ann, "--image_dir", images]
    flags += ["--include_crowd"] if include_crowd else []
    flags += ["--max_examples", str(max_examples)] if max_examples else []
    assert tcoco_cli.main(flags + ["--output_path", str(tmp_path / "pc.record")]) == n
    _run_mtlx_tool("create_coco_tf_record.py", flags + ["--output_path",
                                                        str(tmp_path / "mc.record")], monkeypatch)
    out = capsys.readouterr().out
    assert out.count(f"wrote {n} examples") == 2
    _records_equal(str(tmp_path / "pc.record"), str(tmp_path / "mc.record"))


def test_pet_writer_and_cli_equal_mtlx(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "pet")
    _write_pet(root, np.random.RandomState(3))
    for ignore in (False, True):
        n = tpet.create_pet_tf_record(root, str(tmp_path / "p.record"), "test",
                                      ignore_difficult_instances=ignore)
        assert n == jpet.create_pet_tf_record(root, str(tmp_path / "m.record"), "test",
                                              ignore_difficult_instances=ignore) == 5
        records = _records_equal(str(tmp_path / "p.record"), str(tmp_path / "m.record"))
    texts = [t.decode() for r in records
             for t in parse_features(r).get("image/object/class/text", (None, []))[1]]
    assert texts and all(t in tpet.PET_CLASSES for t in texts)  # the breed, not cat / dog
    assert tpet.get_class_name_from_filename("Abyssinian_100.jpg") == "Abyssinian"
    with pytest.raises(ValueError, match="cannot parse breed"):
        tpet.get_class_name_from_filename("100.jpg")
    flags = ["--data_dir", root, "--set", "trainval"]
    assert tpet_cli.main(flags + ["--output_path", str(tmp_path / "pc.record"),
                                  "--write_label_map", str(tmp_path / "p_map.pbtxt")]) == 5
    _run_mtlx_tool("create_pet_tf_record.py",
                   flags + ["--output_path", str(tmp_path / "mc.record"), "--write_label_map",
                            str(tmp_path / "m_map.pbtxt")], monkeypatch)
    assert capsys.readouterr().out.count("wrote 5 examples to") == 2
    _records_equal(str(tmp_path / "pc.record"), str(tmp_path / "mc.record"))
    assert (tmp_path / "p_map.pbtxt").read_bytes() == (tmp_path / "m_map.pbtxt").read_bytes()


@pytest.mark.parametrize("name,classes", [("pascal", tvoc.VOC_CLASSES),
                                          ("pet", tpet.PET_CLASSES)])
def test_kept_label_maps_equal_mtlx(name, classes):
    kept = os.path.join(_REPO, "mtlx_torch", "data", "label_maps", f"{name}_label_map.pbtxt")
    with open(kept, "rb") as f, \
            open(os.path.join(_REPO, "mtlx", "data", "label_maps",
                              f"{name}_label_map.pbtxt"), "rb") as g:
        assert f.read() == g.read()
    assert label_map_util.get_label_map_dict(kept) == {n: i for i, n in enumerate(classes, 1)}
    assert classes == (jvoc.VOC_CLASSES if name == "pascal" else jpet.PET_CLASSES)

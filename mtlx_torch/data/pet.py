"""Oxford-IIIT Pet -> TFRecord (port of mtlx/data/pet.py; the TF OD API's
create_pet_tf_record.py).

Layout: images/<Breed>_<n>.jpg, annotations/xmls/<Breed>_<n>.xml (VOC
XML whose object name is only cat or dog) and annotations/{trainval,
test}.txt lists. The class of every object is the breed parsed from the
file name, in the dataset's capitalization (cat breeds capitalized, dog
breeds lower case). An example without its XML is skipped (the dataset
annotates a subset). No masks, as in mtlx.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

from mtlx_torch.data import tfrecord
from mtlx_torch.data.voc import (load_label_map, objects_to_example, parse_annotation, read_ids,
                                 write_label_map)

# the 37 breeds, in the dataset's capitalization (pet_label_map.pbtxt)
PET_CLASSES = (
    "Abyssinian", "american_bulldog", "american_pit_bull_terrier",
    "basset_hound", "beagle", "Bengal", "Birman", "Bombay", "boxer",
    "British_Shorthair", "chihuahua", "Egyptian_Mau",
    "english_cocker_spaniel", "english_setter", "german_shorthaired",
    "great_pyrenees", "havanese", "japanese_chin", "keeshond", "leonberger",
    "Maine_Coon", "miniature_pinscher", "newfoundland", "Persian",
    "pomeranian", "pug", "Ragdoll", "Russian_Blue", "saint_bernard",
    "samoyed", "scottish_terrier", "shiba_inu", "Siamese", "Sphynx",
    "staffordshire_bull_terrier", "wheaten_terrier", "yorkshire_terrier",
)

_FILENAME_RE = re.compile(r"([A-Za-z_]+)_[0-9]+\.(jpg|jpeg|png)", re.IGNORECASE)


def get_class_name_from_filename(file_name: str) -> str:
    """'Abyssinian_100.jpg' -> 'Abyssinian'."""
    m = _FILENAME_RE.match(os.path.basename(file_name))
    if not m:
        raise ValueError(f"cannot parse breed from {file_name!r}")
    return m.groups()[0]


def pet_annotation_to_example(data: Dict, image_bytes: bytes, label_map: Dict[str, int],
                              ignore_difficult_instances: bool = False) -> bytes:
    """voc.annotation_to_example with the file name's breed as the class
    of every object."""
    breed = get_class_name_from_filename(data["filename"])
    return objects_to_example(data, image_bytes, lambda obj: breed, label_map,
                              ignore_difficult_instances)


def create_pet_tf_record(data_dir: str, output_path: str, split: str = "trainval",
                         label_map_path: Optional[str] = None,
                         ignore_difficult_instances: bool = False) -> int:
    """Walk the pet layout and write a TFRecord; returns the example count."""
    label_map = load_label_map(label_map_path, PET_CLASSES)
    count = 0
    with tfrecord.TFRecordWriter(output_path) as writer:
        for example_id in read_ids(os.path.join(data_dir, "annotations", f"{split}.txt")):
            xml_path = os.path.join(data_dir, "annotations", "xmls", f"{example_id}.xml")
            if not os.path.exists(xml_path):
                continue
            data = parse_annotation(xml_path)
            with open(os.path.join(data_dir, "images", data["filename"]), "rb") as f:
                image_bytes = f.read()
            writer.write(pet_annotation_to_example(data, image_bytes, label_map,
                                                   ignore_difficult_instances))
            count += 1
    return count


def write_pet_label_map(path: str) -> None:
    write_label_map(path, PET_CLASSES)

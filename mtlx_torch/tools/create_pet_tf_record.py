"""Oxford-IIIT Pet -> TFRecord (port of tools/create_pet_tf_record.py).

  python -m mtlx_torch.tools.create_pet_tf_record --data_dir /data/pet \
      --set trainval --output_path /data/pet_train.record \
      [--label_map_path ...] [--ignore_difficult_instances] [--write_label_map ...]
"""

from __future__ import annotations

import argparse

from mtlx_torch.data.pet import create_pet_tf_record, write_pet_label_map


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", required=True,
                   help="pet root (contains images/ and annotations/)")
    p.add_argument("--set", default="trainval", dest="split", choices=["trainval", "test"])
    p.add_argument("--output_path", required=True)
    p.add_argument("--label_map_path", default=None)
    p.add_argument("--ignore_difficult_instances", action="store_true")
    p.add_argument("--write_label_map", default=None,
                   help="also write the canonical 37-breed label map here")
    args = p.parse_args(argv)
    if args.write_label_map:
        write_pet_label_map(args.write_label_map)
    n = create_pet_tf_record(args.data_dir, args.output_path, split=args.split,
                             label_map_path=args.label_map_path,
                             ignore_difficult_instances=args.ignore_difficult_instances)
    print(f"wrote {n} examples to {args.output_path}")
    return n


if __name__ == "__main__":
    main()

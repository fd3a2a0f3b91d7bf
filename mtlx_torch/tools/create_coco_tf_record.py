"""COCO instances JSON -> TFRecord (port of tools/create_coco_tf_record.py).

  python -m mtlx_torch.tools.create_coco_tf_record \
      --annotations_file /data/coco/annotations/instances_train2017.json \
      --image_dir /data/coco/train2017 --output_path /data/coco/coco_train.record \
      [--include_crowd] [--max_examples N]
"""

from __future__ import annotations

import argparse

from mtlx_torch.data.coco import create_coco_tf_record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--annotations_file", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--include_crowd", action="store_true")
    p.add_argument("--max_examples", type=int, default=None)
    args = p.parse_args(argv)
    n = create_coco_tf_record(args.annotations_file, args.image_dir, args.output_path,
                              include_crowd=args.include_crowd, max_examples=args.max_examples)
    print(f"wrote {n} examples")
    return n


if __name__ == "__main__":
    main()

"""Pascal VOC XML annotations -> TFRecord (port of
tools/create_pascal_tf_record.py).

  python -m mtlx_torch.tools.create_pascal_tf_record --data_dir /data/VOCdevkit \
      --year VOC2007 --set train --output_path /data/pascal_train.record \
      [--label_map_path ...] [--ignore_difficult_instances] [--write_label_map ...]

`--year merged` writes VOC2007 and VOC2012 to `<output_path>.VOC2007`
and `<output_path>.VOC2012`.
"""

from __future__ import annotations

import argparse

from mtlx_torch.data.voc import create_voc_tf_record, write_voc_label_map


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", required=True, help="VOCdevkit root")
    p.add_argument("--set", default="train", dest="split",
                   choices=["train", "val", "trainval", "test"])
    p.add_argument("--year", default="VOC2007", choices=["VOC2007", "VOC2012", "merged"])
    p.add_argument("--output_path", required=True)
    p.add_argument("--label_map_path", default=None)
    p.add_argument("--ignore_difficult_instances", action="store_true")
    p.add_argument("--write_label_map", default=None,
                   help="also write the canonical VOC label map here")
    args = p.parse_args(argv)

    years = ["VOC2007", "VOC2012"] if args.year == "merged" else [args.year]
    total = 0
    for year in years:
        out = args.output_path if len(years) == 1 else f"{args.output_path}.{year}"
        total += create_voc_tf_record(args.data_dir, out, split=args.split, year=year,
                                      label_map_path=args.label_map_path,
                                      ignore_difficult_instances=args.ignore_difficult_instances)
    if args.write_label_map:
        write_voc_label_map(args.write_label_map)
    print(f"wrote {total} examples")
    return total


if __name__ == "__main__":
    main()

"""Category lists in CSV files (port of mtlx/utils/category_util.py): the
[{'id', 'name'}] lists an evaluator takes, one `id,name` row each."""

from __future__ import annotations

import csv
from typing import List


def load_categories_from_csv_file(path: str) -> List[dict]:
    categories = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if row:
                categories.append({"id": int(row[0]), "name": row[1]})
    return categories


def save_categories_to_csv_file(categories: List[dict], path: str) -> None:
    """Write the categories by id."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        for cat in sorted(categories, key=lambda c: c["id"]):
            writer.writerow([cat["id"], cat["name"]])

"""Split-keyed annotation JSON merging (counterpart of
``batch3dmot_tpu/utils/json_tools.py``): two ``{split: [entries]}`` files,
such as the halves of a mini detection file, joined split by split."""

from __future__ import annotations

import json
from typing import Dict


def merge_split_keyed(a: Dict[str, list], b: Dict[str, list]) -> Dict[str, list]:
    """Concatenate the per-split lists of two {split: [entries]} dicts."""
    out: Dict[str, list] = {k: list(v) for k, v in a.items()}
    for k, v in b.items():
        out.setdefault(k, [])
        out[k] = out[k] + list(v)
    return out


def merge_split_keyed_files(path_a: str, path_b: str, out_path: str) -> None:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    with open(out_path, "w") as f:
        json.dump(merge_split_keyed(a, b), f)

"""Annotation list creators (train/val/test 'path label' CSVs).

A copy of mofo_tpu/factory/annot.py (host-side; the port keeps its own).

Parity targets:
  - SSV2: scripts/data/annot_creator.py — labels.json gives
    {Template: class_id}; train/validation.json entries carry bracketed
    templates that are lowercased and de-bracketed before lookup.
  - EK-100: scripts/data/Epic-kitchen/annot_creator_epic.py — verb / noun /
    action class CSVs from the EPIC_100 annotation CSVs (action ids come
    from the sorted 'verb:noun' space, utils.py:556-582).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence, Tuple


def clean_ssv2_template(template: str) -> str:
    """Lowercase + strip the [bracketed] placeholders
    (annot_creator.py:25-38 chain of replacements, generalized: the
    reference enumerates each known bracket; regex covers the same set)."""
    t = template.lower()
    return re.sub(r"\[([^\]]*)\]", r"\1", t)


def ssv2_label_id(labels: Dict[str, int], template: str) -> int:
    """labels.json lookup: capitalized cleaned template
    (annot_creator.py:39)."""
    name = clean_ssv2_template(template)
    return int(labels[name.capitalize()])


def build_ssv2_list(
    labels_json: str,
    split_json: str,
    video_root: str,
    require_exists: bool = True,
) -> List[Tuple[str, int]]:
    with open(labels_json) as f:
        labels = json.load(f)
    with open(split_json) as f:
        split = json.load(f)
    out = []
    for item in split:
        path = os.path.join(video_root, item["id"] + ".mp4")
        if require_exists and not os.path.exists(path):
            continue
        out.append((path, ssv2_label_id(labels, item["template"])))
    return out


def write_setting_file(path: str, entries: Sequence[Tuple[str, int]]):
    """'path label' lines readable by data.filelist.read_setting_file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for p, label in entries:
            f.write(f"{p} {label}\n")


def build_epic_lists(
    train_csv: str,
    val_csv: str,
    video_root: str,
    classtype: str = "action",
) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]:
    """EK-100 per-segment lists labeled by verb, noun, or action id.
    Segment i maps to video_<i>.mp4 under <root>/<split>
    (epic_kitchens.py:460-463)."""
    from mofo_tpu_torch.data.filelist import epic_action_space, read_epic_csv

    _, mapping, _ = epic_action_space([train_csv, val_csv])

    def build(csv_path: str, split: str) -> List[Tuple[str, int]]:
        out = []
        for e in read_epic_csv(csv_path):
            if classtype == "verb":
                label = e.verb
            elif classtype == "noun":
                label = e.noun
            else:
                label = mapping[f"{e.verb}:{e.noun}"]
            path = os.path.join(video_root, split, f"video_{e.index}.mp4")
            out.append((path, label))
        return out

    return build(train_csv, "train"), build(val_csv, "validation")

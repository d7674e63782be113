"""Dataset downloaders (SSV2 + EPIC-KITCHENS) with an offline --dry-run.

A copy of mofo_tpu/cli/download.py:

    python -m mofo_tpu_torch.cli.download ssv2 --output data/ --dry-run

Reference surfaces:
  scripts/data/SSV2/download_somethingsomething.py — the 21 Qualcomm
    zip shards (+ labels), resume-by-existence, then unzip + `cat | tar`
    assembly;
  scripts/data/Epic-kitchen/downloader.py — EPIC-55/100 RDSF trees
    (different remote layouts per version), split CSVs, md5
    skip-if-downloaded, errata URL redirects.

The rebuild keeps the remote path construction and resume semantics but
factors them into a testable plan/execute split: `plan_*` builds the
(url, output, md5) work list as pure data; `execute` streams with
resume and optional md5 verification. `--dry-run` prints the plan as
JSON lines with no network access — the only mode exercisable in tests
and on machines without a network.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import hashlib
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

EPIC_55_BASE = (
    "https://data.bris.ac.uk/datasets/3h91syskeag572hl6tvuovwv4d"
)
EPIC_100_BASE = (
    "https://data.bris.ac.uk/datasets/2g1n6qdydwa9u22shpxqzp0t8m"
)
EPIC_MASKS_BASE = (
    "https://data.bris.ac.uk/datasets/3l8eci2oqgst92n14w2yqi5ytu"
)

# the reference's shard list: qfile ids 68975..68994 for parts 00..19
# plus 68943 for the labels package
SSV2_SHARDS = [
    (68975 + i, f"20bn-something-something-v2-{i:02d}.zip")
    for i in range(20)
] + [(68943, "20bn-something-something-download-package-labels.zip")]
SSV2_URL = "https://developer.qualcomm.com/qfile/{qid}/{name}"


@dataclasses.dataclass(frozen=True)
class Item:
    url: str
    output: str
    md5: Optional[str] = None

    def as_json(self) -> str:
        d = {"url": self.url, "output": self.output}
        if self.md5:
            d["md5"] = self.md5
        return json.dumps(d)


# ---------------------------------------------------------------------------
# SSV2
# ---------------------------------------------------------------------------


def plan_ssv2(output_dir: str) -> List[Item]:
    root = os.path.join(output_dir, "somethingsomething")
    return [
        Item(SSV2_URL.format(qid=qid, name=name),
             os.path.join(root, name))
        for qid, name in SSV2_SHARDS
    ]


SSV2_ASSEMBLY = (
    "unzip '{root}/20bn-something-something-v2-??.zip' -d {root} && "
    "unzip {root}/20bn-something-something-download-package-labels.zip "
    "-d {root} && cat {root}/20bn-something-something-v2-?? | "
    "tar -xvzf - -C {root}"
)


# ---------------------------------------------------------------------------
# EPIC-KITCHENS
# ---------------------------------------------------------------------------


def is_extension(video_id: str) -> bool:
    """EPIC-100 extension videos have a 3-digit sequence part
    (P01_101); originals have 2 (P01_01)."""
    return len(video_id.split("_")[1]) == 3


def _epic_remote(video_id: str, what: str, split: str) -> List[str]:
    """Remote path parts for one video, per the reference's per-version
    layouts (downloader.py:132-205)."""
    pid = video_id.split("_")[0]
    ext = is_extension(video_id)
    if what == "videos":
        return (
            [pid, "videos", f"{video_id}.MP4"]
            if ext
            else ["videos", split, pid, f"{video_id}.MP4"]
        )
    if what == "rgb_frames":
        return (
            [pid, "rgb_frames", f"{video_id}.tar"]
            if ext
            else ["frames_rgb_flow", "rgb", split, pid, f"{video_id}.tar"]
        )
    if what == "flow_frames":
        return (
            [pid, "flow_frames", f"{video_id}.tar"]
            if ext
            else ["frames_rgb_flow", "flow", split, pid, f"{video_id}.tar"]
        )
    if what == "hand_masks":
        return ["hand-objects", pid, f"{video_id}.pkl"]
    if what == "masks":
        return ["masks", pid, f"{video_id}.pkl"]
    raise ValueError(f"unknown item kind: {what}")


def _epic_output(video_id: str, what: str) -> List[str]:
    """Local layout: always the EPIC-100 shape (the reference
    normalizes both versions to it)."""
    pid = video_id.split("_")[0]
    suffix = {
        "videos": f"videos/{video_id}.MP4",
        "rgb_frames": f"rgb_frames/{video_id}.tar",
        "flow_frames": f"flow_frames/{video_id}.tar",
        "hand_masks": f"hand-objects/{video_id}.pkl",
        "masks": f"masks/{video_id}.pkl",
    }[what]
    return [pid] + suffix.split("/")


def load_csv_map(path: Optional[str], key: str, val: str) -> Dict[str, str]:
    if not path:
        return {}
    with open(path) as f:
        return {row[key]: row[val] for row in csv.DictReader(f)}


def plan_epic(
    video_ids: Iterable[str],
    output_dir: str,
    what: Iterable[str] = ("videos",),
    splits: Optional[Dict[str, str]] = None,
    md5: Optional[Dict[str, str]] = None,
    errata: Optional[Dict[str, str]] = None,
) -> List[Item]:
    """Work list for EPIC downloads.

    splits: video_id -> epic-55 split name ('train'/'test'); only needed
    for non-extension videos (their remote tree is split-partitioned).
    errata: remote-path -> replacement URL (downloader.py errata.csv).
    """
    splits = splits or {}
    md5 = md5 or {}
    errata = errata or {}
    root = os.path.join(output_dir, "EPIC-KITCHENS")
    items = []
    for vid in video_ids:
        for w in what:
            if w in ("hand_masks", "masks"):
                base = EPIC_MASKS_BASE
            elif is_extension(vid):
                base = EPIC_100_BASE
            else:
                base = EPIC_55_BASE
            split = splits.get(vid, "train")
            parts = _epic_remote(vid, w, split)
            rp = "/".join(parts)
            url = errata.get(rp) or "/".join([base] + parts)
            out = os.path.join(root, *_epic_output(vid, w))
            items.append(Item(url, out, md5.get(rp)))
    return items


# ---------------------------------------------------------------------------
# Execution (resume + md5 verify)
# ---------------------------------------------------------------------------


def file_md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def already_done(item: Item) -> bool:
    """Resume rule: skip when the file exists and (if an md5 is known)
    the checksum matches (downloader.py file_already_downloaded)."""
    if not os.path.exists(item.output):
        return False
    if item.md5 is None:
        return True
    return file_md5(item.output) == item.md5


def execute(items: List[Item]) -> int:
    import shutil
    import urllib.request

    failures = 0
    for it in items:
        if already_done(it):
            print(f"skip (already downloaded): {it.output}")
            continue
        os.makedirs(os.path.dirname(it.output), exist_ok=True)
        print(f"downloading {it.url}\n         -> {it.output}")
        try:
            with urllib.request.urlopen(it.url) as r, open(
                it.output, "wb"
            ) as f:
                shutil.copyfileobj(r, f)
            if it.md5 and file_md5(it.output) != it.md5:
                print(f"MD5 MISMATCH: {it.output}")
                failures += 1
        except Exception as e:  # noqa: BLE001 — per-file resilience
            print(f"failed: {it.url}: {e}")
            failures += 1
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="dataset", required=True)

    ps = sub.add_parser("ssv2")
    ps.add_argument("--output", required=True)
    ps.add_argument("--dry-run", action="store_true")

    pe = sub.add_parser("epic")
    pe.add_argument("--output", required=True)
    pe.add_argument("--dry-run", action="store_true")
    pe.add_argument("--video-ids", nargs="+", default=None,
                    help="e.g. P01_01 P01_101")
    pe.add_argument("--video-list", default=None,
                    help="file with one video id per line")
    pe.add_argument("--what", nargs="+", default=["videos"],
                    choices=["videos", "rgb_frames", "flow_frames",
                             "hand_masks", "masks"])
    pe.add_argument("--participants", nargs="+", default=None,
                    help="filter to these participants (P01 ...)")
    pe.add_argument("--splits-csv", default=None,
                    help="csv with video_id,split columns (EPIC-55 tree)")
    pe.add_argument("--md5-csv", default=None,
                    help="csv with file_remote_path,md5 columns")
    pe.add_argument("--errata-csv", default=None,
                    help="csv with rdsf_path,dropbox_path columns")
    args = p.parse_args(argv)

    if args.dataset == "ssv2":
        items = plan_ssv2(args.output)
        post = SSV2_ASSEMBLY.format(
            root=os.path.join(args.output, "somethingsomething")
        )
    else:
        vids = list(args.video_ids or [])
        if args.video_list:
            with open(args.video_list) as f:
                vids += [ln.strip() for ln in f if ln.strip()]
        if not vids:
            print("no video ids given (--video-ids / --video-list)",
                  file=sys.stderr)
            return 2
        if args.participants:
            keep = set(args.participants)
            vids = [v for v in vids if v.split("_")[0] in keep]
        items = plan_epic(
            vids,
            args.output,
            what=args.what,
            splits=load_csv_map(args.splits_csv, "video_id", "split"),
            md5=load_csv_map(args.md5_csv, "file_remote_path", "md5"),
            errata=load_csv_map(args.errata_csv, "rdsf_path",
                                "dropbox_path"),
        )
        post = None

    if args.dry_run:
        for it in items:
            print(it.as_json())
        if post:
            print(json.dumps({"post_download": post}))
        return 0
    rc = execute(items)
    if post:
        print(f"assemble with:\n  {post}")
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())

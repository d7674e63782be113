"""EPIC-KITCHENS offline preprocessing CLI, a copy of
mofo_tpu/cli/epic_preprocess.py (the last two reference data scripts:
`scripts/data/Epic-kitchen/Preprocess_epic_data.py` and
`Preprocess_epic_annot.py`).

Subcommands:
  cut  — cut one mp4 per EPIC_100 action row from the official RGB
         frame dumps (the pre-cut layout data/epic.EpicClipDataset and
         the timestamp loader assume):
           python -m mofo_tpu_torch.cli.epic_preprocess cut \
               --csv EPIC_100_train.csv --frames_root EPIC-KITCHENS/ \
               --out EPIC_100_train/ [--workers 8] [--dry_run]
  hoa  — convert per-video GT hand-object detection pickles to
         per-action detection_{i}.json files, optionally merging the
         per-frame hand+object union boxes into one
         Unsupervised_BB-style json for the BB-focused finetune
         (GT-box experiments):
           python -m mofo_tpu_torch.cli.epic_preprocess hoa \
               --csv EPIC_100_train.csv --annot_root hand-objects/ \
               --out EPIC_100_hand_objects_train/ \
               [--merged_json Unsupervised_BB_EK_train.json]
"""

from __future__ import annotations

import argparse
import json


def get_args(argv=None):
    p = argparse.ArgumentParser("EPIC-KITCHENS preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    cut = sub.add_parser("cut", help="cut action segments to mp4s")
    cut.add_argument("--csv", required=True)
    cut.add_argument("--frames_root", required=True)
    cut.add_argument("--out", required=True)
    cut.add_argument("--workers", type=int, default=1)
    cut.add_argument("--dry_run", action="store_true")
    cut.add_argument("--limit", type=int, default=None)

    hoa = sub.add_parser("hoa", help="convert hand-object GT pickles")
    hoa.add_argument("--csv", required=True)
    hoa.add_argument("--annot_root", required=True)
    hoa.add_argument("--out", required=True)
    hoa.add_argument("--merged_json", default=None)
    hoa.add_argument("--limit", type=int, default=None)

    return p.parse_args(argv)


def main(args=None):
    from mofo_tpu_torch.factory import epic_segments

    args = args if args is not None else get_args()
    if args.cmd == "cut":
        counts = epic_segments.cut_action_segments(
            args.csv, args.frames_root, args.out,
            workers=args.workers, dry_run=args.dry_run, limit=args.limit,
        )
    else:
        counts = epic_segments.convert_hoa_detections(
            args.csv, args.annot_root, args.out,
            merged_json=args.merged_json, limit=args.limit,
        )
    print(json.dumps({"cmd": args.cmd, "counts": counts}))
    return counts


if __name__ == "__main__":
    main()

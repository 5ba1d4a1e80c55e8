"""Formats the VIST SIS annotations and downloads the validation images
that `generate_vist_images` reads (counterpart of
evals/download_vist_images.py; reference evals/download_vist_images.py).

    python -m gill_tpu_torch.evals.download_vist_images \
        [--vist-json sis/val.story-in-sequence.json] \
        [--out-images sis/val_images] [--out-formatted sis/val_formatted.json]

Writes `--out-formatted` as {"annotations": {story_id: [{caption,
image_id, sequence_index}]}} and fetches each annotated image's `url_o`
(http(s) only, `utils.image.get_image_from_url`: 224 x 224 RGB) to
`<out-images>/<image_id>.png`, skipping files that exist; a failed fetch
is printed and skipped. The fetch needs the network (~1 h for the
validation split); the formatting does not.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

from gill_tpu_torch.utils import image as image_utils


def format_vist(raw: dict):
    """(formatted annotations, {image_id: url_o} of the annotated images)
    from the SIS json."""
    vist = {"annotations": collections.defaultdict(list)}
    used = set()
    for ann in raw["annotations"]:
        if len(ann) != 1:
            raise ValueError(f"an annotation of {len(ann)} entries")
        ann = ann[0]
        vist["annotations"][ann["story_id"]].append({
            "caption": ann["text"],
            "image_id": ann["photo_flickr_id"],
            "sequence_index": ann["worker_arranged_photo_order"],
        })
        used.add(ann["photo_flickr_id"])
    id2url = {img["id"]: img["url_o"] for img in raw["images"]
              if img["id"] in used and img.get("url_o")}
    return vist, id2url


def download_images(vist: dict, id2url: dict, out_dir: str) -> int:
    """Fetches every annotated image with a url once; returns how many
    were saved."""
    saved, done = 0, set()
    for story in vist["annotations"].values():
        for s in story:
            iid = s["image_id"]
            if iid in done:
                continue
            done.add(iid)
            out = os.path.join(out_dir, f"{iid}.png")
            if iid in id2url and not os.path.exists(out):
                try:
                    image_utils.get_image_from_url(id2url[iid]).save(out)
                    saved += 1
                except Exception as e:  # noqa: BLE001 — one image lost
                    print("Error saving image", iid, e)
    return saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vist-json", default="sis/val.story-in-sequence.json")
    p.add_argument("--out-images", default="sis/val_images")
    p.add_argument("--out-formatted", default="sis/val_formatted.json")
    args = p.parse_args(argv)

    os.makedirs(args.out_images, exist_ok=True)
    with open(args.vist_json) as f:
        vist, id2url = format_vist(json.load(f))
    with open(args.out_formatted, "w") as wf:
        json.dump(vist, wf)
    n = download_images(vist, id2url, args.out_images)
    print(f"{len(vist['annotations'])} stories formatted, {n} images saved")
    return 0


if __name__ == "__main__":
    sys.exit(main())

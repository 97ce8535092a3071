"""Feature-extraction CLI: COCO / Visual Genome images (or the region crops
of the stage-1 artifacts) -> a feature store of 14x14x2048 grids + pool5.

    # whole images (VQA): store row k = k-th image, ids from file names
    python -m vqa_transfer_externaldata_torch.cli.extract \
        --image_dir /data/coco/train2014 --out features_train.hdf5 \
        [--pattern "*.jpg"] [--batch_size 64] [--image_size 448] \
        [--torch_checkpoint resnet101.pth] [--format raw]

    # region crops (stage 1): store row r = region_index r of the
    # visualgenome artifacts (region_meta.npz), so stage-1 training's
    # region_index join reads the right rows by position
    python -m vqa_transfer_externaldata_torch.cli.extract \
        --image_dir /data/vg/images --out region_feats \
        --regions <vlmap_out_dir>/region_meta.npz --format raw

Without ``--torch_checkpoint`` the ResNet's weights are random (pipeline
tests only). Runs on CUDA unless ``--device cpu``. Returns the store's
path.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import os
import re
import sys
from typing import Optional, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data.features import extract_features
from vqa_transfer_externaldata_torch.utils.logging import log


def image_id_from_name(path: str) -> int:
    """COCO / VG id = the trailing integer of the file's stem
    (``COCO_train2014_000000000123`` -> 123); a stem without one gets a
    digest of itself, the same in every process (Python's ``hash`` of a
    string is salted per process)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    m = re.search(r"(\d+)$", stem)
    if m:
        return int(m.group(1))
    digest = hashlib.blake2b(stem.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % (1 << 62)


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser("extract")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--pattern", default="*.jpg")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=448)
    p.add_argument("--torch_checkpoint", default=None,
                   help="torchvision-format resnet101 state_dict (.pth)")
    p.add_argument("--format", default="hdf5", choices=("hdf5", "raw"),
                   help="raw = a directory of memory-mappable arrays")
    p.add_argument("--regions", default=None,
                   help="region_meta.npz of the visualgenome preprocessing: "
                        "extract each region's CROP, row r = region_index r "
                        "(the stage-1 feature store)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    found = sorted(glob.glob(os.path.join(args.image_dir, args.pattern)))
    if not found:
        raise FileNotFoundError(
            f"no images matching {args.pattern} under {args.image_dir}")

    boxes = None
    if args.regions:
        meta = np.load(args.regions)
        by_id = {image_id_from_name(q): q for q in found}
        missing = sorted(set(meta["image_id"].tolist()) - set(by_id))
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} region image ids have no file under "
                f"{args.image_dir} (first: {missing[:5]})")
        paths = [by_id[int(i)] for i in meta["image_id"]]
        boxes = [tuple(int(v) for v in b) for b in meta["bbox"]]
        ids = list(range(len(paths)))  # row r == region_index r
        log.info("extracting %d region crops over %d images", len(paths),
                 len(by_id))
    else:
        paths = found
        ids = [image_id_from_name(q) for q in paths]
        log.info("extracting %d images from %s", len(paths), args.image_dir)

    state_dict = None
    if args.torch_checkpoint:
        import torch

        from vqa_transfer_externaldata_torch.ops.resnet import (
            BACKBONE_STEM, convert_torch_state_dict)

        sd = torch.load(args.torch_checkpoint, map_location="cpu",
                        weights_only=True)
        state_dict = convert_torch_state_dict(sd, stem=BACKBONE_STEM)
        log.info("loaded pretrained ResNet-101 from %s",
                 args.torch_checkpoint)

    return extract_features(paths, ids, args.out, boxes=boxes,
                            batch_size=args.batch_size,
                            image_size=args.image_size,
                            state_dict=state_dict, fmt=args.format,
                            device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Prediction CLI: answer questions with a trained run.

    python -m vqa_transfer_externaldata_torch.cli.predict \
        --train_dir runs/vqa --feature_path feats.hdf5 \
        --image_id 123 --question "what color is the dog?"

Multiple --question flags batch together; output is one JSON line
``{"answers": [...]}``. The attention models read the images' grids,
``vqa_baseline`` their pool5 vectors. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data.features import FeatureStore
from vqa_transfer_externaldata_torch.serving import Predictor


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser("predict")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--question", action="append", required=True)
    p.add_argument("--feature_path", default=None,
                   help="feature store (hdf5/npz/raw dir)")
    p.add_argument("--image_id", type=int, action="append", default=None,
                   help="image id per question (single id broadcasts)")
    p.add_argument("--image", action="append", default=None,
                   help="JPEG path per question (vqa_end2end)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    if args.image:
        raise NotImplementedError(
            "raw-image requests (vqa_end2end) are not ported yet "
            "(ROADMAP.md, section 1, item 13)")
    if not (args.feature_path and args.image_id):
        p.error("feature-store models need --feature_path and --image_id")
    n = len(args.question)
    ids = args.image_id
    if len(ids) == 1:
        ids = ids * n
    if len(ids) != n:
        p.error("--image_id count must be 1 or match --question")

    predictor = Predictor(args.train_dir, batch_size=args.batch_size,
                          device=args.device)
    store = FeatureStore(args.feature_path)
    try:
        rows = np.asarray([store.index_of[i] for i in ids], np.int64)
        visual = store.gather(rows)[predictor.visual_key]
    finally:
        store.close()

    answers = predictor.answer(visual, args.question)
    print(json.dumps({"answers": answers}))
    return answers


if __name__ == "__main__":
    main(sys.argv[1:])

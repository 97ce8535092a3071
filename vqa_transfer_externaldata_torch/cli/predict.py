"""Prediction CLI: answer questions with a trained run.

    # precomputed-feature models: features from a store + image ids
    python -m vqa_transfer_externaldata_torch.cli.predict \
        --train_dir runs/vqa --feature_path feats.hdf5 \
        --image_id 123 --question "what color is the dog?"

    # the raw-image model (vqa_end2end): JPEGs
    python -m vqa_transfer_externaldata_torch.cli.predict \
        --train_dir runs/e2e --image dog.jpg --question "..."

Multiple --question flags batch together (one --image_id or --image
broadcasts); output is one JSON line ``{"answers": [...]}``. The attention
models read the images' grids, ``vqa_baseline`` their pool5 vectors,
``vqa_end2end`` the images, decoded as training decodes them. Runs on CUDA
unless ``--device cpu``.
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

    n = len(args.question)

    def per_question(values, flag):
        values = values * n if len(values) == 1 else values
        if len(values) != n:
            p.error(f"{flag} count must be 1 or match --question")
        return values

    predictor = Predictor(args.train_dir, batch_size=args.batch_size,
                          device=args.device)
    if predictor.visual_key == "images":
        if not args.image:
            p.error("the raw-image model needs --image")
        from vqa_transfer_externaldata_torch.data.ingest import _decode

        size = predictor.cfg.data.image_size
        visual = np.stack([_decode(path, size)
                           for path in per_question(args.image, "--image")])
    else:
        if not (args.feature_path and args.image_id):
            p.error("feature-store models need --feature_path and "
                    "--image_id")
        ids = per_question(args.image_id, "--image_id")
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

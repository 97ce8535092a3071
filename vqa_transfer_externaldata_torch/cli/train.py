"""Training CLI of the port: stage-2 ``vqa_attention`` on the device-resident
synthetic corpus.

    python -m vqa_transfer_externaldata_torch.cli.train \
        --data.synthetic true --data.synthetic_layout joined \
        --train.device_data_cache true --train.train_dir runs/vqa

Writes ``config.json``, ``metrics.jsonl`` and ``params_final.pt`` (served by
``serving.Predictor``) into the run directory and returns its path. Runs on
CUDA unless ``--device cpu``. Not ported yet, each raising
``NotImplementedError`` with its ROADMAP item: transfer init from stage-1
parameters (item 8), the grain input pipeline (item 14) and streamed
(not device-resident) training (item 9).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import torch

from vqa_transfer_externaldata_torch.cli.common import (
    build_spec, resolve_train_dir)
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import load_dataset
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
from vqa_transfer_externaldata_torch.utils.checkpoint import save_params
from vqa_transfer_externaldata_torch.utils.logging import log


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args, rest = p.parse_known_args(argv)
    cfg = Config.from_args(rest)
    t = cfg.train
    for on, what, item in (
            (bool(t.pretrained_param_path),
             "transfer init (--train.pretrained_param_path)", "item 8"),
            (cfg.data.input_pipeline == "grain", "the grain input pipeline",
             "item 14"),
            (not t.device_data_cache,
             "streamed training (--train.device_data_cache false)",
             "item 9")):
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md, section 1, {item})")
    model, _, _ = build_spec(
        cfg, generator=torch.Generator().manual_seed(t.seed))
    train_dir = resolve_train_dir(cfg, "vqa")
    trainer = Trainer(cfg, model, train_dir=train_dir, device=args.device)
    log.info("train_dir: %s  device: %s", train_dir, trainer.device)
    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    train_ds = load_dataset(cfg, "train")
    state = trainer.init_state()
    state = trainer.fit_resident(train_ds, state)
    final = os.path.join(train_dir, PARAMS_FILE)
    save_params(final, model.state_dict())
    log.info("final params saved to %s", final)
    trainer.close()
    print(json.dumps({"train_dir": train_dir, "steps": state.step}))
    return train_dir


if __name__ == "__main__":
    main(sys.argv[1:])

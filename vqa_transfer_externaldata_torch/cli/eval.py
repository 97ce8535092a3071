"""Evaluation CLI of the port: restore a run's checkpoint, evaluate a whole
split, print the metrics as one JSON line and, for a stage-2 (VQA) run,
write the official-format result JSON.

    python -m vqa_transfer_externaldata_torch.cli.eval \
        --train.train_dir runs/vqa [--eval_split val] \
        [--checkpoint_step 1000] [--results_path runs/vqa/results.json]

The run's ``config.json`` is adopted, and the ``--section.field`` flags on
the command line still win over it. ``oov_split.json`` and ``types.json``
in ``data.dataset_dir`` add the in-/out-of-vocabulary and per-type
accuracy breakdowns when they exist. A stage-1 run reports its loss
metrics. Runs on CUDA unless ``--device cpu``. Under
``torch.distributed.run`` each rank evaluates its rows of every batch
(``Trainer.evaluate`` and the resident evaluator), every rank gets the
split's numbers, and rank 0 writes the result JSON and prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from vqa_transfer_externaldata_torch.cli.common import (
    build_spec, rank_device)
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import load_dataset
from vqa_transfer_externaldata_torch.parallel.evaler import evaluate_split
from vqa_transfer_externaldata_torch.parallel.mesh import (
    create_mesh, initialize_distributed_from)
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.logging import log


def main(argv: Optional[Sequence[str]] = None) -> dict:
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--eval_split", default="val")
    extra.add_argument("--results_path", default=None)
    extra.add_argument("--checkpoint_step", type=int, default=None)
    extra.add_argument("--device", default=None,
                       help="torch device (default: cuda)")
    eargs, rest = extra.parse_known_args(argv)
    cfg = Config.from_args(rest)

    train_dir = cfg.train.train_dir
    cfg_path = os.path.join(train_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            saved = json.load(fh)
        flat = {f"{s}.{k}": v for s, sec in saved.items()
                for k, v in sec.items()}
        cfg = _apply_explicit(Config().replace_flat(flat), rest)
        cfg = cfg.replace_flat({"train.train_dir": train_dir})

    started = initialize_distributed_from(
        cfg, backend="gloo" if eargs.device == "cpu" else None)
    mesh = create_mesh(cfg, rank_device(eargs.device))
    spec, _, answer_vocab = build_spec(cfg)
    ds = load_dataset(cfg, eargs.eval_split, stage=spec.stage)
    trainer = Trainer(cfg, spec, mesh=mesh, train_dir=train_dir)
    state = trainer.restore(trainer.init_state(), step=eargs.checkpoint_step)
    log.info("evaluating %s/%s at step %d (%d examples) on %s", spec.stage,
             eargs.eval_split, state.step, len(ds), trainer.device)

    results_path = eargs.results_path
    if results_path is None and spec.stage == "vqa":
        results_path = os.path.join(train_dir,
                                    f"results_{eargs.eval_split}.json")
    oov_ids = None
    oov_path = os.path.join(cfg.data.dataset_dir, "oov_split.json")
    if os.path.exists(oov_path):
        with open(oov_path) as fh:
            oov_ids = np.asarray(json.load(fh)["oov_ids"], np.int32)
    type_tables = None
    types_path = os.path.join(cfg.data.dataset_dir, "types.json")
    if os.path.exists(types_path):
        with open(types_path) as fh:
            type_tables = json.load(fh)
    metrics, _ = evaluate_split(
        trainer, state, ds,
        answer_vocab=answer_vocab if spec.stage == "vqa" else None,
        results_path=results_path, oov_answer_ids=oov_ids,
        type_tables=type_tables)
    if mesh.is_writer:
        print(json.dumps({"split": eargs.eval_split, "step": state.step,
                          **{k: round(float(v), 6)
                             for k, v in metrics.items()}}))
    trainer.close()
    if started:
        torch.distributed.destroy_process_group()
    return metrics


def _apply_explicit(cfg: Config, argv: Sequence[str]) -> Config:
    """Re-apply only the ``--section.field`` flags present on ``argv``."""
    parsed = Config.from_args(argv)
    overrides = {}
    for tok in argv:
        if not (tok.startswith("--") and "." in tok):
            continue
        key = tok[2:].split("=")[0]
        section, _, field = key.partition(".")
        try:
            overrides[key] = getattr(getattr(parsed, section), field)
        except AttributeError:
            continue
    return cfg.replace_flat(overrides)


if __name__ == "__main__":
    main(sys.argv[1:])

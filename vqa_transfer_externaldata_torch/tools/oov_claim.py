"""The paper's claim on out-of-vocabulary answers, run on the port with the
protocol of the JAX package's
``tests/test_transfer.py::test_transfer_beats_scratch_on_oov_answers``:
stage 1 (``vlmap``) pretrains the word space on ``synthetic_transfer_corpus``'s
external data, which covers every answer; stage 2 (``vqa_attention``)
trains on the in-vocabulary answers only, its answer table and logit bias
frozen, once transfer-initialized and once from a fresh table; both are
evaluated on a val split over all answers.

    python -m vqa_transfer_externaldata_torch.tools.oov_claim \
        [--device cpu] [--set model.rnn_dim=64 --set data.feature_dim=128 ...] \
        [--seed 0] [--concept_dim 32]

prints one JSON line: the OOV and in-vocabulary accuracies of both runs,
whether they meet the JAX test's thresholds, the settings and the seconds
of each stage. ``--concept_dim`` draws the corpus at that many channels and
zero-pads it to ``data.feature_dim`` (the kernels take C % 128 on a card).
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import (
    ArrayDataset, synthetic_transfer_corpus, synthetic_vocabs)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.evaler import evaluate_split
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import resolve_device
from vqa_transfer_externaldata_torch.utils.checkpoint import transfer_init

# The JAX tests' tiny_config (tests/conftest.py) with the protocol's
# training settings: 200 steps a stage at batch 64.
TINY = {
    "data.synthetic": True, "data.synthetic_size": 256,
    "data.vocab_size": 128, "data.num_answers": 32,
    "data.grid_h": 4, "data.grid_w": 4, "data.feature_dim": 32,
    "data.pool5_dim": 32, "data.max_question_len": 8,
    "model.word_dim": 16, "model.rnn_dim": 16, "model.fusion_dim": 32,
    "model.att_hidden": 16, "model.answer_dim": 16,
    "model.dtype": "float32", "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 16,
    "model.dropout": 0.1,
    "train.batch_size": 64, "train.max_steps": 200,
    "train.log_every": 200, "train.eval_every": 10_000,
    "train.checkpoint_every": 10_000, "train.warmup_steps": 1,
    "train.learning_rate": 3e-3,
}
CORPUS = {"n_vlmap": 2048, "n_train": 2048, "n_val": 384, "noise": 0.25,
          "seed": 0}
FROZEN = ("answer_embedding", "logit_bias")


def corpus(cfg: Config, concept_dim: Optional[int] = None, **kw):
    """``synthetic_transfer_corpus(cfg, **kw)``, drawn at ``concept_dim``
    channels (default ``data.feature_dim``) and zero-padded to
    ``data.feature_dim``."""
    C = cfg.data.feature_dim
    dim = concept_dim or C
    vlmap_ds, train_ds, val_ds, oov_ids = synthetic_transfer_corpus(
        cfg.replace_flat({"data.feature_dim": dim, "data.pool5_dim": dim}),
        **kw)

    def padded(ds: ArrayDataset, key: str) -> ArrayDataset:
        x = ds.arrays[key]
        pad = [(0, 0)] * (x.ndim - 1) + [(0, C - x.shape[-1])]
        return ArrayDataset(dict(ds.arrays, **{key: np.pad(x, pad)}))

    return (padded(vlmap_ds, "feature"), padded(train_ds, "features"),
            padded(val_ds, "features"), oov_ids)


def meets_thresholds(result: Dict[str, float], num_answers: int) -> bool:
    """The JAX test's thresholds: both runs learn the in-vocabulary answers
    (> 0.5), and the transferred table answers held-out ones (> 0.3, and
    more than 3x the scratch run or chance)."""
    t, s = result["oov_transfer"], result["oov_scratch"]
    return (result["in_vocab_transfer"] > 0.5
            and result["in_vocab_scratch"] > 0.5
            and t > 0.3 and t > 3 * max(s, 1.0 / num_answers))


def run(cfg: Config, *, device, train_dir: str,
        concept_dim: Optional[int] = None,
        corpus_kw: Optional[dict] = None) -> Dict[str, object]:
    """The protocol on ``cfg`` (``TINY``'s fields) on ``device``, the runs'
    directories under ``train_dir``. Raises if a frozen table moves."""
    dev = resolve_device(device)
    kw = dict(CORPUS, **(corpus_kw or {}))
    B = cfg.train.batch_size
    vlmap_ds, train_ds, val_ds, oov_ids = corpus(cfg, concept_dim, **kw)
    word_vocab, answer_vocab = synthetic_vocabs(cfg)
    seconds = {}

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    cfg1 = cfg.replace_flat({"model.model": "vlmap"})
    spec1 = build_model(cfg1, generator=torch.Generator().manual_seed(0))
    tr1 = Trainer(cfg1, spec1, train_dir=os.path.join(train_dir, "vlmap"),
                  device=str(dev))
    tr1.fit(vlmap_ds.batches(B, seed=1), tr1.init_state())
    tr1.close()
    sync()
    seconds["stage1"] = time.perf_counter() - t0
    vlmap_params = {k: v.detach().cpu().clone()
                    for k, v in spec1.module.state_dict().items()}

    cfg2 = cfg.replace_flat({"model.model": "vqa_attention",
                             "train.freeze_params": ",".join(FROZEN)})
    spec2 = build_model(cfg2, generator=torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in spec2.module.state_dict().items()}
    inits = {"transfer": transfer_init(fresh, vlmap_params, word_vocab,
                                       answer_vocab),
             "scratch": fresh}
    result: Dict[str, object] = {}
    for name, params in inits.items():
        t0 = time.perf_counter()
        tr = Trainer(cfg2, spec2, train_dir=os.path.join(train_dir, name),
                     device=str(dev))
        state = tr.init_state(params)
        before = {k: state.params[k].detach().clone() for k in FROZEN}
        state = tr.fit(train_ds.batches(B, seed=2), state)
        for k in FROZEN:  # the freeze holds bitwise
            if not torch.equal(state.params[k], before[k]):
                raise AssertionError(f"{name}: the frozen {k} moved")
        metrics, _ = evaluate_split(tr, state, val_ds,
                                    oov_answer_ids=oov_ids)
        tr.close()
        sync()
        seconds[name] = time.perf_counter() - t0
        result[f"oov_{name}"] = metrics["vqa_accuracy_oov_answers"]
        result[f"in_vocab_{name}"] = metrics["vqa_accuracy_in_vocab_answers"]
    result.update(meets_thresholds=meets_thresholds(
        result, cfg.data.num_answers), steps=cfg.train.max_steps,
        held_out=len(oov_ids), corpus=kw, concept_dim=concept_dim,
        device=str(dev), seconds=seconds)
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser("oov_claim")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.FIELD=VALUE",
                   help="a config field over TINY's (repeatable)")
    p.add_argument("--seed", type=int, default=CORPUS["seed"],
                   help="the corpus seed")
    p.add_argument("--concept_dim", type=int, default=None)
    args = p.parse_args(argv)
    flags = []
    for item in args.set:
        key, _, value = item.partition("=")
        flags += [f"--{key}", value]
    parsed, _ = Config.parser().parse_known_args(flags)
    cfg = Config().replace_flat(dict(TINY, **{
        k: v for k, v in vars(parsed).items()
        if v is not None and k != "config_json"}))
    with tempfile.TemporaryDirectory(prefix="oov_claim_") as tmp:
        result = run(cfg, device=args.device, train_dir=tmp,
                     concept_dim=args.concept_dim,
                     corpus_kw={"seed": args.seed})
    result["set"] = args.set
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])

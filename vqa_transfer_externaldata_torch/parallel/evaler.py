"""Split evaluation: run every row of a split, report the exact split-level
VQA accuracy with its breakdowns, and write the official-format result JSON
(``[{"question_id": ..., "answer": ...}]``), as the JAX package's
``parallel/evaler.py`` does."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from vqa_transfer_externaldata_torch.data.datasets import ArrayDataset
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer, TrainState
from vqa_transfer_externaldata_torch.utils.logging import log
from vqa_transfer_externaldata_torch.utils.metrics import per_question_scores
from vqa_transfer_externaldata_torch.utils.vocab import UNK_ID, Vocab


def padded_batches(ds: ArrayDataset, batch_size: int
                   ) -> Tuple[Iterator[Dict[str, np.ndarray]], int]:
    """One epoch of batches in order covering every row: the last partial
    batch is padded with copies of row 0, which get ``answer_id`` <unk> and
    ``example_mask`` 0 so the masked loss and accuracy leave them out; the
    caller trims the predictions to the returned row count. Rows come
    through ``ds.take``, so a ``JoinedDataset`` attaches its features."""
    n = len(ds)
    pad = (-n) % batch_size

    def gen():
        for start in range(0, n + pad, batch_size):
            stop = min(start + batch_size, n)
            idx = np.arange(start, stop)
            if stop - start < batch_size:  # pad the tail with row 0
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - idx.size, idx.dtype)])
            batch = ds.take(idx)
            mask = np.ones((batch_size,), np.float32)
            if stop - start < batch_size:
                mask[stop - start:] = 0.0
                if "answer_id" in batch:
                    batch["answer_id"] = batch["answer_id"].copy()
                    batch["answer_id"][stop - start:] = UNK_ID
            batch["example_mask"] = mask
            yield batch

    return gen(), n


def evaluate_split(trainer: Trainer, state: TrainState, ds: ArrayDataset,
                   *, answer_vocab: Optional[Vocab] = None,
                   question_ids: Optional[np.ndarray] = None,
                   results_path: Optional[str] = None,
                   oov_answer_ids: Optional[np.ndarray] = None,
                   type_tables: Optional[Dict[str, list]] = None
                   ) -> Tuple[Dict[str, float], np.ndarray]:
    """Evaluate every row of ``ds`` (the resident evaluator when the run is
    device-resident, else host batches) and return ``(metrics, preds)``.

    With an ``answer_scores`` table, ``vqa_accuracy`` is recomputed exactly
    over the split's rows; ``oov_answer_ids`` (answer ids held out of
    training) adds the accuracy on questions whose answer is one of them
    and on those whose answer is in the vocabulary otherwise (rows with an
    <unk> answer are in neither); ``type_tables`` (``types.json``) adds the
    accuracy per answer type and per question type when the split carries
    ``answer_type_id``/``question_type_id``. ``results_path`` receives the
    official result JSON, decoded through ``answer_vocab``: under a
    process group every rank returns the split's numbers and rank 0 alone
    writes the file."""
    n = len(ds)
    if trainer.cfg.train.device_data_cache:
        metrics, preds = trainer.evaluate_resident(state, ds)
    else:
        batches, n = padded_batches(ds, trainer.cfg.train.batch_size)
        metrics, preds = trainer.evaluate(state, batches)
        preds = preds[:n]
    if "answer_scores" in ds.arrays:
        per_q = per_question_scores(
            preds, np.asarray(ds.arrays["answer_scores"][:n]))
        metrics["vqa_accuracy"] = float(per_q.mean())
        if oov_answer_ids is not None and "answer_id" in ds.arrays:
            gt = np.asarray(ds.arrays["answer_id"][:n])
            oov = np.isin(gt, oov_answer_ids)
            in_vocab = ~oov & (gt != UNK_ID)
            if oov.any():
                metrics["vqa_accuracy_oov_answers"] = float(
                    per_q[oov].mean())
            if in_vocab.any():
                metrics["vqa_accuracy_in_vocab_answers"] = float(
                    per_q[in_vocab].mean())
        if type_tables is not None:
            for id_key, names_key, prefix in (
                    ("answer_type_id", "answer_types",
                     "vqa_accuracy_answer_type"),
                    ("question_type_id", "question_types",
                     "vqa_accuracy_question_type")):
                if id_key not in ds.arrays:
                    continue
                ids = np.asarray(ds.arrays[id_key][:n])
                for t, name in enumerate(type_tables[names_key]):
                    sel = ids == t
                    if sel.any():
                        slug = name.replace(" ", "_").replace("/", "_")
                        metrics[f"{prefix}/{slug}"] = float(
                            per_q[sel].mean())
    if results_path is not None and trainer.mesh.is_writer:
        if answer_vocab is None:
            raise ValueError("answer_vocab required to decode results")
        qids = (question_ids if question_ids is not None
                else ds.arrays.get("question_id",
                                   np.arange(n, dtype=np.int64)))
        results: List[dict] = [
            {"question_id": int(qids[i]),
             "answer": answer_vocab.tokens[int(preds[i])]}
            for i in range(n)]
        os.makedirs(os.path.dirname(os.path.abspath(results_path)),
                    exist_ok=True)
        with open(results_path, "w") as fh:
            json.dump(results, fh)
        log.info("wrote %d results to %s", n, results_path)
    return metrics, preds

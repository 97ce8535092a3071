"""VQA v2 preprocessing (the port's own copy of the JAX package's
numpy-only module): the official questions/annotations JSON -> training
artifacts, bit-equal to the JAX package's for the same files.

Per split, ``vqa_<split>.npz``: q_ids [N, T] int32, q_len [N], answer_id [N]
(the most common normalized answer in the top-K vocab, <unk> outside it),
answer_scores [N, A] (the official per-answer accuracy vectors, val split),
question_id [N], image_index [N] (the question's row in the feature store),
question_type_id / answer_type_id [N] (rows of ``types.json``). Beside them
``vocab.json`` and ``answer_vocab.json`` (built on the train split),
``types.json`` (the question/answer type names), and with an answer
holdout ``oov_split.json`` (the answer ids kept out of training).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vqa_transfer_externaldata_torch.utils.logging import log
from vqa_transfer_externaldata_torch.utils.metrics import (
    answer_scores, normalize_answer)
from vqa_transfer_externaldata_torch.utils.vocab import (
    UNK_ID, Vocab, build_answer_vocab)


def load_questions(path: str) -> List[dict]:
    with open(path) as fh:
        return json.load(fh)["questions"]


def load_annotations(path: str) -> Dict[int, dict]:
    with open(path) as fh:
        return {a["question_id"]: a for a in json.load(fh)["annotations"]}


def build_type_tables(annotations: Dict[int, dict]
                      ) -> Dict[str, List[str]]:
    """Question/answer type name tables from the (train) annotations,
    sorted; index 0 is <unk>, for types the table does not hold."""
    q_types = sorted({a.get("question_type", "") for a in
                      annotations.values()} - {""})
    a_types = sorted({a.get("answer_type", "") for a in
                      annotations.values()} - {""})
    return {"question_types": ["<unk>"] + q_types,
            "answer_types": ["<unk>"] + a_types}


def build_split(
    questions: Sequence[dict],
    annotations: Optional[Dict[int, dict]],
    word_vocab: Vocab,
    answer_vocab: Vocab,
    *,
    max_question_len: int = 26,
    image_id_to_index: Optional[Dict[int, int]] = None,
    with_scores: bool = False,
    type_tables: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, np.ndarray]:
    """The arrays of one split. Without ``image_id_to_index`` every
    ``image_index`` is 0."""
    n = len(questions)
    T = max_question_len
    q_ids = np.zeros((n, T), np.int32)
    q_len = np.zeros((n,), np.int32)
    qid = np.zeros((n,), np.int64)
    image_index = np.zeros((n,), np.int32)
    answer_id = np.full((n,), UNK_ID, np.int32)
    scores = (np.zeros((n, len(answer_vocab)), np.float32)
              if with_scores else None)
    qt_idx = at_idx = None
    if annotations is not None and type_tables is not None:
        qt = {t: i for i, t in enumerate(type_tables["question_types"])}
        at = {t: i for i, t in enumerate(type_tables["answer_types"])}
        qt_idx = np.zeros((n,), np.int32)
        at_idx = np.zeros((n,), np.int32)

    a2i = answer_vocab.token_to_id
    for i, q in enumerate(questions):
        q_ids[i], q_len[i] = word_vocab.encode(q["question"], T)
        qid[i] = q["question_id"]
        if image_id_to_index is not None:
            image_index[i] = image_id_to_index[q["image_id"]]
        if annotations is not None:
            ann = annotations[q["question_id"]]
            # Training target: the most common (normalized) answer.
            target = normalize_answer(ann["multiple_choice_answer"])
            answer_id[i] = a2i.get(target, UNK_ID)
            if with_scores:
                human = [a["answer"] for a in ann["answers"]]
                scores[i] = answer_scores(human, a2i, len(answer_vocab))
            if qt_idx is not None:
                qt_idx[i] = qt.get(ann.get("question_type", ""), 0)
                at_idx[i] = at.get(ann.get("answer_type", ""), 0)

    out = {"q_ids": q_ids, "q_len": q_len, "question_id": qid,
           "image_index": image_index, "answer_id": answer_id}
    if with_scores:
        out["answer_scores"] = scores
    if qt_idx is not None:
        out["question_type_id"] = qt_idx
        out["answer_type_id"] = at_idx
    return out


def preprocess_vqa_v2(
    out_dir: str,
    train_questions: str,
    train_annotations: str,
    *,
    val_questions: Optional[str] = None,
    val_annotations: Optional[str] = None,
    test_questions: Optional[str] = None,
    top_k_answers: int = 2000,
    max_question_len: int = 26,
    vocab_pad_to: Optional[int] = None,
    image_id_to_index: Optional[Dict[int, int]] = None,
    answer_holdout_fraction: float = 0.0,
    holdout_seed: int = 0,
) -> Tuple[Vocab, Vocab]:
    """The whole preprocessing into ``out_dir``; returns (word_vocab,
    answer_vocab).

    ``answer_holdout_fraction`` > 0 is the paper's out-of-vocabulary answer
    protocol: that fraction of the answer vocab (never the specials) is
    drawn from ``holdout_seed`` and kept out of *training* (those train
    rows get <unk> targets, which the loss masks), while evaluation still
    scores them. The held-out ids go to ``oov_split.json``.
    """
    if val_questions and not val_annotations:
        raise ValueError(
            "val_questions requires val_annotations (the val split carries "
            "answer targets + score vectors); pass an annotation-less "
            "question file as test_questions instead")
    os.makedirs(out_dir, exist_ok=True)
    tq = load_questions(train_questions)
    ta = load_annotations(train_annotations)
    word_vocab = Vocab.build((q["question"] for q in tq),
                             max_size=vocab_pad_to)
    answer_vocab = build_answer_vocab(
        (ann["multiple_choice_answer"] for ann in ta.values()),
        top_k=top_k_answers)
    word_vocab.save(os.path.join(out_dir, "vocab.json"))
    answer_vocab.save(os.path.join(out_dir, "answer_vocab.json"))
    type_tables = build_type_tables(ta)
    with open(os.path.join(out_dir, "types.json"), "w") as fh:
        json.dump(type_tables, fh)
    log.info("vocab %d words, %d answers; %d question / %d answer types",
             len(word_vocab), len(answer_vocab),
             len(type_tables["question_types"]),
             len(type_tables["answer_types"]))

    holdout_ids = np.zeros((0,), np.int32)
    if answer_holdout_fraction > 0:
        candidates = np.arange(4, len(answer_vocab))  # never the specials
        rng = np.random.default_rng(holdout_seed)
        n_hold = int(round(answer_holdout_fraction * candidates.size))
        holdout_ids = np.sort(rng.choice(candidates, size=n_hold,
                                         replace=False)).astype(np.int32)
        with open(os.path.join(out_dir, "oov_split.json"), "w") as fh:
            json.dump({"oov_ids": holdout_ids.tolist()}, fh)
        log.info("answer holdout: %d/%d answers excluded from training",
                 n_hold, len(answer_vocab))

    splits = [("train", tq, ta, False)]
    if val_questions:
        splits.append(("val", load_questions(val_questions),
                       load_annotations(val_annotations), True))
    if test_questions:
        splits.append(("test", load_questions(test_questions), None, False))
    for name, qs, anns, with_scores in splits:
        arrays = build_split(qs, anns, word_vocab, answer_vocab,
                             max_question_len=max_question_len,
                             image_id_to_index=image_id_to_index,
                             with_scores=with_scores,
                             type_tables=type_tables)
        if name == "train" and holdout_ids.size:
            held = np.isin(arrays["answer_id"], holdout_ids)
            arrays["answer_id"] = np.where(held, UNK_ID,
                                           arrays["answer_id"]).astype(
                                               np.int32)
        path = os.path.join(out_dir, f"vqa_{name}.npz")
        np.savez_compressed(path, **arrays)
        in_vocab = float((arrays["answer_id"] != UNK_ID).mean())
        log.info("%s: %d questions -> %s (%.1f%% answers in vocab)",
                 name, len(qs), path, 100 * in_vocab)
    return word_vocab, answer_vocab


def oov_answer_split(answer_vocab: Vocab, train_answers: Sequence[str]
                     ) -> Dict[str, np.ndarray]:
    """The paper's in-/out-of-vocabulary answer split: which answer-vocab
    entries never appear among the (normalized) *training* answers — the
    rows whose embeddings come from the pretrained space alone."""
    seen = {normalize_answer(a) for a in train_answers}
    mask = np.array([t in seen for t in answer_vocab.tokens], bool)
    return {"in_vocab_mask": mask,
            "oov_ids": np.where(~mask)[0].astype(np.int32)}

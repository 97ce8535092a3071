"""Official VQA v2 accuracy metric + answer normalization (the port's own
copy of the JAX package's numpy-only module).

A predicted answer scores ``min(#matching human answers / 3, 1)``, averaged
over the ten leave-one-annotator-out subsets, after both prediction and
ground truths pass the official normalization (contraction expansion,
punctuation stripping, digit/article mapping).

Host-side (numpy/python): the metric runs over decoded strings during
eval. ``per_question_scores`` and ``soft_accuracy`` work on precomputed
per-answer-id score vectors, from which the evaluator takes split-level
accuracy and its breakdowns.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

# --- Official VQA normalization tables (VQA evaluation protocol) -----------

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've",
    "mightve": "might've", "mustnt": "mustn't", "mustve": "must've",
    "neednt": "needn't", "notve": "not've", "oclock": "o'clock",
    "oughtnt": "oughtn't", "ow's'at": "'ow's'at", "'ows'at": "'ow's'at",
    "'ow'sat": "'ow's'at", "shant": "shan't", "shed've": "she'd've",
    "she'dve": "she'd've", "she's": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyd've": "they'd've", "they'dve": "they'd've", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed've": "we'd've", "we'dve": "we'd've",
    "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = {"a", "an", "the"}

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    """Official VQA eval ``processPunctuation``."""
    out = text
    # Loop-invariant (official code re-evaluates it per punctuation mark;
    # the RESULT is identical — hoisting drops ~20 wasted regex scans per
    # answer across the ~millions preprocessing normalizes).
    digit_comma = re.search(_COMMA_STRIP, text)
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or digit_comma:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    """Official VQA eval ``processDigitArticle``."""
    out: List[str] = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(answer: str) -> str:
    """Full official normalization applied to predictions and ground truths."""
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(answer))


# --- Accuracy ---------------------------------------------------------------


def _leave_one_out_score(candidate: str, gts: Sequence[str]) -> float:
    """min(#matches/3, 1) averaged over leave-one-annotator-out subsets —
    the official inner loop, shared by vqa_accuracy and answer_scores."""
    n = len(gts)
    if n <= 1:
        return float(candidate == (gts[0] if gts else ""))
    accs = []
    for i in range(n):
        others = list(gts[:i]) + list(gts[i + 1:])
        matches = sum(1 for g in others if g == candidate)
        accs.append(min(1.0, matches / 3.0))
    return float(np.mean(accs))


def vqa_accuracy(prediction: str, gt_answers: Sequence[str]) -> float:
    """Official VQA accuracy for one question.

    ``gt_answers`` is the list of (typically 10) human answers. The score is
    the average over each leave-one-annotator-out subset of
    ``min(#matches_in_subset / 3, 1)``.

    Protocol detail reproduced exactly (official ``vqaEval.py``): the
    prediction is always newline/tab-stripped, but the FULL normalization
    (punctuation, digits, articles, contractions) applies to prediction
    and ground truths ONLY when the ground-truth answers are not
    unanimous (``len(set(gtAnswers)) > 1``) — a unanimous question
    compares raw strings, so e.g. '2' vs 10x 'two' scores 0.0 there.
    """
    pred = prediction.replace("\n", " ").replace("\t", " ").strip()
    gts = list(gt_answers)
    if len(set(gts)) > 1:
        pred = normalize_answer(pred)
        gts = [normalize_answer(a) for a in gts]
    return _leave_one_out_score(pred, gts)


def answer_scores(gt_answers: Sequence[str],
                  answer_to_id: Dict[str, int],
                  num_answers: int) -> np.ndarray:
    """Precompute the per-vocab-answer accuracy vector for one question.

    Used at preprocessing time (reference C2) so that in-loop eval is a pure
    gather: ``score[argmax logits]``. Entry ``v`` holds ``vqa_accuracy`` of
    vocab answer ``v`` against the question's human answers — including the
    official unanimous-gt gate (see :func:`vqa_accuracy`): a unanimous
    question matches raw strings only, so a vocab answer differing from the
    raw unanimous form scores 0 exactly as the official server would.
    """
    scores = np.zeros((num_answers,), dtype=np.float32)
    raw = list(gt_answers)
    if len(set(raw)) > 1:
        gts = [normalize_answer(a) for a in raw]
        candidates = set(gts)
    else:
        gts = raw
        candidates = set(raw)
    for candidate in candidates:
        if candidate not in answer_to_id:
            continue
        scores[answer_to_id[candidate]] = _leave_one_out_score(candidate,
                                                               gts)
    return scores


def per_question_scores(predicted_ids: np.ndarray,
                        score_table: np.ndarray) -> np.ndarray:
    """[N] per-question VQA accuracy from predicted answer ids +
    precomputed score rows (:func:`answer_scores`) — the gather the
    evaler's split-level and per-type breakdowns are built from."""
    return score_table[np.arange(predicted_ids.shape[0]), predicted_ids]


def soft_accuracy(predicted_ids: np.ndarray, score_table: np.ndarray) -> float:
    """Mean VQA accuracy from predicted answer ids + precomputed score rows
    (the split-level reduction of :func:`per_question_scores`)."""
    return float(per_question_scores(predicted_ids, score_table).mean())

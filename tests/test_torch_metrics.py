"""Port parity: utils/metrics.py (the port's copy of the official VQA
accuracy and answer normalization) gives exactly the JAX package's
results."""

import numpy as np
import pytest

from vqa_transfer_externaldata_tpu.utils import metrics as jm
from vqa_transfer_externaldata_torch.utils import metrics as tm

ANSWERS = ["dont", "isnt it", "two", "a cat", "the one dog", "none",
           "yes!", "red, white", "1,000", "3.5", "ten.", " Yes\t", "cant",
           "y'all'll", "(left)", "the/other side", "hes", "none of them"]

GT_SETS = [["yes"] * 10, ["two"] * 9 + ["three"], ["cat"] * 3 + ["dog"] * 7,
           ["red, white"] * 4 + ["red white"] * 2 + ["white"] * 4,
           ["none"] * 5 + ["0"] * 5, ["2"], []]


@pytest.mark.parametrize("text", ANSWERS)
def test_normalization_equals_jax(text):
    assert tm.normalize_answer(text) == jm.normalize_answer(text)
    assert tm.process_punctuation(text) == jm.process_punctuation(text)
    assert tm.process_digit_article(text) == jm.process_digit_article(text)


def test_accuracy_and_score_tables_equal_jax():
    vocab = {a: i for i, a in enumerate(
        ["yes", "2", "two", "cat", "dog", "red white", "white", "0",
         "red, white", "three"])}
    for gts in GT_SETS:
        for pred in ANSWERS + list(vocab):
            assert tm.vqa_accuracy(pred, gts) == jm.vqa_accuracy(pred, gts)
        np.testing.assert_array_equal(
            tm.answer_scores(gts, vocab, len(vocab)),
            jm.answer_scores(gts, vocab, len(vocab)))


def test_split_reductions_equal_jax():
    rng = np.random.default_rng(0)
    table = rng.uniform(size=(50, 12)).astype(np.float32)
    preds = rng.integers(0, 12, size=50)
    np.testing.assert_array_equal(tm.per_question_scores(preds, table),
                                  jm.per_question_scores(preds, table))
    assert tm.soft_accuracy(preds, table) == jm.soft_accuracy(preds, table)

"""Port parity: the real-data preprocessing (``data/vqa_v2.py``,
``data/visualgenome.py``, ``cli/preprocess.py``, the answer vocab and the
GloVe matrix of ``utils/vocab.py``) against the JAX package on the same
fixtures, which the tests write (official-schema VQA v2 JSON, Visual
Genome region descriptions, a GloVe text file; nothing is downloaded).
Every artifact must be equal, bit for bit."""

import functools
import json
import os
import sys

import numpy as np
import pytest

from vqa_transfer_externaldata_tpu.cli.preprocess import main as jax_preprocess
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.data import visualgenome as jvg
from vqa_transfer_externaldata_tpu.data import vqa_v2 as jvqa
from vqa_transfer_externaldata_tpu.utils import vocab as jvocab
from vqa_transfer_externaldata_torch.cli.preprocess import main as preprocess
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data import visualgenome as vg
from vqa_transfer_externaldata_torch.data import vqa_v2
from vqa_transfer_externaldata_torch.data.features import FeatureStore
from vqa_transfer_externaldata_torch.utils import vocab

QUESTIONS = ["What color is the cat?", "Is the dog sleeping?",
             "How many cats are there?", "What color is the dog?",
             "Is the cat black?", "What is the dog doing?",
             "What color is the wall?", "How many dogs are there?"]
ANSWERS = ["black", "yes", "two", "brown", "no", "sleeping", "white", "one"]
ANSWER_TYPES = ["other", "yes/no", "number", "other", "yes/no", "other",
                "other", "number"]
QUESTION_TYPES = ["what color is the", "is the", "how many",
                  "what color is the", "is the", "what is the",
                  "what color is the", "how many"]


def write_vqa_json(root, n_images=3):
    """The JAX package's official-schema fixture
    (``tests/test_data_tools.py::vqa_json``): 8 questions over 3 images."""
    questions = {"questions": [
        {"question_id": 10 * i, "image_id": 100 + i % n_images,
         "question": q} for i, q in enumerate(QUESTIONS)]}
    annotations = {"annotations": [
        {"question_id": 10 * i, "image_id": 100 + i % n_images,
         "multiple_choice_answer": mca,
         "question_type": QUESTION_TYPES[i],
         "answer_type": ANSWER_TYPES[i],
         "answers": [{"answer": mca}] * 8 + [{"answer": "maybe"}] * 2}
        for i, mca in enumerate(ANSWERS)]}
    qp, ap = os.path.join(root, "questions.json"), \
        os.path.join(root, "annotations.json")
    with open(qp, "w") as fh:
        json.dump(questions, fh)
    with open(ap, "w") as fh:
        json.dump(annotations, fh)
    return qp, ap


@pytest.fixture()
def vqa_json(tmp_path):
    return write_vqa_json(str(tmp_path))


REGION_PHRASES = ((1, ["a black cat on the mat", "the white dog",
                       "black dog running", "a white cat sleeping"]),
                  (2, ["a red car", "the blue car", "white car parked",
                       "a black car", "dog on the car"]))
VG_WORDS = "black cat white dog red car blue mat running parked sleeping on"


def write_regions(root):
    """Visual Genome ``region_descriptions.json`` (9 regions over 2
    images) and a word vocab that holds its words."""
    data = [{"id": img, "regions": [
        {"region_id": 10 * img + k, "image_id": img, "phrase": p,
         "x": 2 * k, "y": 3, "width": 8, "height": 6}
        for k, p in enumerate(phrases)]} for img, phrases in REGION_PHRASES]
    rp = os.path.join(root, "regions.json")
    with open(rp, "w") as fh:
        json.dump(data, fh)
    vp = os.path.join(root, "vocab.json")
    vocab.Vocab.build([VG_WORDS]).save(vp)
    return rp, vp


def assert_same_files(ours, theirs, names):
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files), name
                for k in y.files:
                    assert x[k].dtype == y[k].dtype, (name, k)
                    np.testing.assert_array_equal(x[k], y[k],
                                                  err_msg=f"{name}:{k}")
        else:
            with open(a) as x, open(b) as y:
                assert json.load(x) == json.load(y), name


VQA_FILES = ["vqa_train.npz", "vqa_val.npz", "vocab.json",
             "answer_vocab.json", "types.json"]


@pytest.mark.parametrize("extra", [
    [], ["--answer_holdout_fraction", "0.5"],
    ["--answer_holdout_fraction", "0.25", "--holdout_seed", "3",
     "--top_k", "6", "--max_question_len", "4"]])
def test_vqa_v2_cli_artifacts_equal_jax(vqa_json, tmp_path, extra):
    qp, ap = vqa_json
    argv = ["--train_questions", qp, "--train_annotations", ap,
            "--val_questions", qp, "--val_annotations", ap,
            "--test_questions", qp, "--top_k", "8",
            "--max_question_len", "8", "--vocab_pad_to", "64"] + extra
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    preprocess(["vqa_v2", "--out_dir", ours] + argv)
    jax_preprocess(["vqa_v2", "--out_dir", theirs] + argv)
    names = VQA_FILES + ["vqa_test.npz"] + (
        ["oov_split.json"] if extra else [])
    assert_same_files(ours, theirs, names)
    assert os.path.exists(os.path.join(ours, "oov_split.json")) == \
        bool(extra)


def test_vqa_v2_image_index_from_a_feature_store(vqa_json, tmp_path):
    """``--feature_path`` maps each question's image to its store row,
    as the JAX function does with ``image_id_to_index``."""
    qp, ap = vqa_json
    raw = tmp_path / "store"
    raw.mkdir()
    ids = np.array([102, 100, 101], np.int64)
    np.zeros((3, 1, 1, 4), np.float16).tofile(raw / "grid.f16.bin")
    np.zeros((3, 4), np.float32).tofile(raw / "pool5.f32.bin")
    np.save(raw / "image_ids.npy", ids)
    (raw / "meta.json").write_text(json.dumps(
        {"grid_shape": [3, 1, 1, 4], "pool5_dim": 4}))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    preprocess(["vqa_v2", "--out_dir", ours, "--train_questions", qp,
                "--train_annotations", ap, "--val_questions", qp,
                "--val_annotations", ap, "--feature_path", str(raw)])
    jvqa.preprocess_vqa_v2(theirs, qp, ap, val_questions=qp,
                           val_annotations=ap, vocab_pad_to=8192,
                           image_id_to_index={102: 0, 100: 1, 101: 2})
    assert_same_files(ours, theirs, VQA_FILES)
    with np.load(os.path.join(ours, "vqa_train.npz")) as f:
        index = f["image_index"]
    assert index.tolist() == [1, 2, 0, 1, 2, 0, 1, 2]
    assert FeatureStore(str(raw)).index_of == {102: 0, 100: 1, 101: 2}


def test_vqa_v2_functions_equal_jax(vqa_json, tmp_path):
    qp, ap = vqa_json
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    wv, av = vqa_v2.preprocess_vqa_v2(
        ours, qp, ap, val_questions=qp, val_annotations=ap,
        top_k_answers=8, max_question_len=8,
        answer_holdout_fraction=0.5, holdout_seed=0,
        image_id_to_index={100: 0, 101: 1, 102: 2})
    jwv, jav = jvqa.preprocess_vqa_v2(
        theirs, qp, ap, val_questions=qp, val_annotations=ap,
        top_k_answers=8, max_question_len=8,
        answer_holdout_fraction=0.5, holdout_seed=0,
        image_id_to_index={100: 0, 101: 1, 102: 2})
    assert (wv.tokens, av.tokens) == (jwv.tokens, jav.tokens)
    assert_same_files(ours, theirs, VQA_FILES + ["oov_split.json"])
    anns = vqa_v2.load_annotations(ap)
    assert anns == jvqa.load_annotations(ap)
    assert vqa_v2.load_questions(qp) == jvqa.load_questions(qp)
    assert vqa_v2.build_type_tables(anns) == jvqa.build_type_tables(anns)
    train_answers = ANSWERS[:5]
    ours_split = vqa_v2.oov_answer_split(av, train_answers)
    theirs_split = jvqa.oov_answer_split(jav, train_answers)
    for k in theirs_split:
        np.testing.assert_array_equal(ours_split[k], theirs_split[k])
    # The holdout's train rows are <unk> targets; val still scores them.
    oov = json.load(open(os.path.join(ours, "oov_split.json")))["oov_ids"]
    train = np.load(os.path.join(ours, "vqa_train.npz"))
    val = np.load(os.path.join(ours, "vqa_val.npz"))
    held = np.isin(val["answer_id"], oov)
    assert held.any() and np.all(train["answer_id"][held] == vocab.UNK_ID)
    assert val["answer_scores"][held].max() == 1.0


def test_val_questions_need_annotations(vqa_json, tmp_path):
    qp, ap = vqa_json
    for fn in (vqa_v2.preprocess_vqa_v2, jvqa.preprocess_vqa_v2):
        with pytest.raises(ValueError, match="val_annotations"):
            fn(str(tmp_path / "pre"), qp, ap, val_questions=qp)


def test_answer_vocab_and_glove_matrix_equal_jax(tmp_path):
    answers = ["Two", "2", "yes", "Yes", "a dog", "dog", "", "no", "two "]
    for k in (0, 3, 10):
        assert vocab.build_answer_vocab(answers, k).tokens == \
            jvocab.build_answer_vocab(answers, k).tokens
    mat = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    vocab.save_matrix(ours, mat)
    jvocab.save_matrix(theirs, mat)
    np.testing.assert_array_equal(vocab.load_matrix(ours),
                                  jvocab.load_matrix(theirs))


def test_glove_cli_equals_jax(tmp_path):
    vp = tmp_path / "vocab.json"
    vocab.Vocab.build(["cat dog the cat"]).save(str(vp))
    gt = tmp_path / "glove.txt"
    gt.write_text("cat " + " ".join(["1.5"] * 8) + "\n"
                  "zebra " + " ".join(["2"] * 8) + "\n"
                  "dog " + " ".join(["0.25"] * 7) + "\n"
                  "the " + " ".join(f"{i / 8}" for i in range(8)) + "\n")
    argv = ["--glove_txt", str(gt), "--vocab", str(vp), "--dim", "8",
            "--pad_to", "16"]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    preprocess(["glove", "--out", ours] + argv)
    jax_preprocess(["glove", "--out", theirs] + argv)
    a, b = np.load(ours)["embedding"], np.load(theirs)["embedding"]
    assert a.shape == (16, 8) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    word = vocab.Vocab.load(str(vp))
    assert np.all(a[len(word):] == 0.0) and np.all(a[vocab.PAD_ID] == 0.0)
    np.testing.assert_array_equal(a[word.token_to_id["cat"]], 1.5)


LEXMAP = {"black": "adj.all", "white": "adj.all", "red": "adj.all",
          "blue": "adj.all", "cat": "noun.animal", "dog": "noun.animal",
          "car": "noun.artifact", "mat": "noun.artifact",
          "running": "verb.motion", "parked": None, "sleeping": None}


@pytest.mark.parametrize("lexmap", [None, LEXMAP],
                         ids=["frequency_buckets", "wordnet"])
@pytest.mark.parametrize("num_tasks", [2, 3])
def test_visualgenome_cli_artifacts_equal_jax(tmp_path, monkeypatch, lexmap,
                                              num_tasks):
    """Both preprocessings (word level and description blanks) through
    both CLIs, WordNet answered by the same map in both, or missing in
    both (no corpus here: the frequency buckets)."""
    if lexmap is not None:
        for mod in (vg, jvg):
            monkeypatch.setattr(mod, "_wordnet_lexname",
                                lambda w: lexmap.get(w))
    rp, vp = write_regions(str(tmp_path))
    argv = ["--region_descriptions", rp, "--vocab", vp,
            "--num_tasks", str(num_tasks), "--num_candidates", "5",
            "--min_word_count", "1", "--max_desc_len", "5", "--seed", "4"]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    preprocess(["visualgenome", "--out_dir", ours] + argv)
    jax_preprocess(["visualgenome", "--out_dir", theirs] + argv)
    names = [f"{p}_{s}.npz" for p in ("vlmap", "vlmap_desc")
             for s in ("train", "val")]
    assert_same_files(ours, theirs, names + [
        "region_meta.npz", "vlmap_meta.json", "vlmap_desc_meta.json"])
    meta = json.load(open(os.path.join(ours, "vlmap_meta.json")))
    if lexmap is None:
        assert meta["task_names"] == [f"freq_bucket_{i}"
                                      for i in range(num_tasks)]
    else:
        assert meta["task_names"][0] == "misc"


def test_visualgenome_functions_equal_jax(tmp_path):
    rp, vp = write_regions(str(tmp_path))
    regions = vg.load_region_descriptions(rp)
    assert regions == jvg.load_region_descriptions(rp)
    word_vocab = vocab.Vocab.load(vp)
    jword_vocab = jvocab.Vocab.load(vp)
    phrases = [r["phrase"] for r in regions]
    for mc in (1, 2, 3):
        assert vg.mine_visual_words(phrases, min_count=mc) == \
            jvg.mine_visual_words(phrases, min_count=mc)
    kw = dict(num_tasks=2, num_candidates=4, min_word_count=1,
              val_fraction=0.3, seed=2)
    for ours, theirs in (
            (vg.build_vlmap_artifacts(regions, word_vocab, **kw),
             jvg.build_vlmap_artifacts(regions, jword_vocab, **kw)),
            (vg.build_vlmap_description_artifacts(
                regions, word_vocab, max_desc_len=4, **kw),
             jvg.build_vlmap_description_artifacts(
                 regions, jword_vocab, max_desc_len=4, **kw))):
        assert sorted(ours) == sorted(theirs) == ["train", "val"]
        for split in theirs:
            for k, v in theirs[split].items():
                np.testing.assert_array_equal(ours[split][k], v)
    visual = frozenset(VG_WORDS.split())
    for phrase in phrases + ["", "the", "a 2 dog on the red car"]:
        tokens = vocab.tokenize(phrase)
        for pos in range(len(tokens)):
            assert vg.classify_blank_pattern(tokens, pos, visual) == \
                jvg.classify_blank_pattern(tokens, pos, visual)
    assert vg.PATTERN_NAMES == jvg.PATTERN_NAMES
    assert vg.STOPWORDS == jvg.STOPWORDS
    with pytest.raises(ValueError, match="no visual-word"):
        vg.build_vlmap_artifacts(regions, word_vocab, min_word_count=99)


@pytest.mark.parametrize("num_tasks,min_task_size", [(8, 8), (2, 8), (4, 1)])
def test_wordnet_task_grouping_equals_jax(monkeypatch, num_tasks,
                                          min_task_size):
    """The WordNet branch of task discovery (grouping, the small groups
    merged into misc, the num_tasks cap) on the JAX tests' lexname map."""
    lexmap = {w: "noun.animal" for w in
              ("cat", "dog", "bird", "horse", "cow", "fish", "sheep",
               "goat")}
    lexmap.update({w: "noun.artifact" for w in
                   ("car", "bus", "train", "boat", "chair", "table",
                    "lamp", "door")})
    lexmap.update({"red": "adj.all", "blue": "adj.all", "zzyzx": None})
    for mod in (vg, jvg):
        monkeypatch.setattr(mod, "_wordnet_lexname", lambda w: lexmap.get(w))
    words = list(lexmap)
    ours = vg.discover_tasks(words, num_tasks, min_task_size=min_task_size)
    theirs = jvg.discover_tasks(words, num_tasks,
                                min_task_size=min_task_size)
    assert ours == theirs
    assert ours[1][0] == "misc" and ours[0]["zzyzx"] == 0


def test_task_discovery_without_nltk(monkeypatch):
    """With ``nltk`` unimportable (as on a machine without it) the port
    falls back to the frequency buckets, the same ones JAX takes without
    the WordNet corpus, where JAX's ``_wordnet_lexname`` raises."""
    words = ["cat", "dog", "black", "car", "white"]
    want = jvg.discover_tasks(words, 3)  # no WordNet corpus on this box
    assert want[1] == ["freq_bucket_0", "freq_bucket_1", "freq_bucket_2"]
    for name in [m for m in sys.modules if m.split(".")[0] == "nltk"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "nltk", None)
    # A fresh cache of the WordNet loader, restored after the test.
    monkeypatch.setattr(vg, "_wordnet", functools.lru_cache(maxsize=1)(
        vg._wordnet.__wrapped__))
    assert vg._wordnet() is None
    assert vg._wordnet_lexname("cat") is None
    assert vg.discover_tasks(words, 3) == want
    with pytest.raises(ImportError):
        jvg._wordnet_lexname("cat")


def _resampler_base(n=40, seed=0):
    rng = np.random.default_rng(seed)
    task = rng.integers(0, 3, size=n).astype(np.int32)
    pools = {0: [10, 11, 12, 13], 1: [20, 21, 22], 2: [30]}
    word = np.asarray([pools[int(t)][i % len(pools[int(t)])]
                       for i, t in enumerate(task)], np.int32)
    arrays = {"task": task, "word": word,
              "feature": rng.normal(size=(n, 4)).astype(np.float32),
              "candidates": np.zeros((n, 6), np.int32),
              "label": np.zeros((n,), np.int32)}
    return arrays, pools


@pytest.mark.parametrize("count_vocab_size", [0, 40])
@pytest.mark.parametrize("shuffle", [False, True])
def test_candidate_resampler_equals_jax(count_vocab_size, shuffle):
    arrays, pools = _resampler_base()
    ours = vg.CandidateResampler(tds.ArrayDataset(dict(arrays)), pools,
                                 num_candidates=6, seed=5,
                                 count_vocab_size=count_vocab_size)
    theirs = jvg.CandidateResampler(jds.ArrayDataset(dict(arrays)), pools,
                                    num_candidates=6, seed=5,
                                    count_vocab_size=count_vocab_size)
    assert len(ours) == len(theirs) == 40
    got = list(ours.batches(16, seed=2, epochs=3, shuffle=shuffle))
    want = list(theirs.batches(16, seed=2, epochs=3, shuffle=shuffle))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(
            a["candidates"][np.arange(16), a["label"]], a["word"])
    assert ("cand_counts" in got[0]) == bool(count_vocab_size)
    idx = np.array([3, 1, 4])
    for k, v in theirs.take(idx).items():
        np.testing.assert_array_equal(ours.take(idx)[k], v)


def test_candidate_resampler_rejects_an_unknown_task():
    n = 16
    arrays = {"task": np.full((n,), 7, np.int32),
              "word": np.full((n,), 10, np.int32),
              "feature": np.zeros((n, 4), np.float32)}
    for mod, dsmod in ((vg, tds), (jvg, jds)):
        ds = mod.CandidateResampler(dsmod.ArrayDataset(dict(arrays)),
                                    {0: [10, 11, 12, 13]}, num_candidates=4)
        with pytest.raises(ValueError, match="no candidate pool"):
            next(ds.batches(8, seed=0, epochs=1, shuffle=False))

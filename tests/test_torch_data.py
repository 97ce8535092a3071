"""The port's own copies of the framework-free modules (config, vocab,
synthetic vocabs, feature stores) against the JAX package's originals:
same fields and defaults, same ids, same gathered rows (exact)."""

import dataclasses
import json
import os

import numpy as np
import pytest

from vqa_transfer_externaldata_tpu import config as jax_config
from vqa_transfer_externaldata_tpu.data import datasets as jax_datasets
from vqa_transfer_externaldata_tpu.data import features as jax_features
from vqa_transfer_externaldata_tpu.utils import vocab as jax_vocab
from vqa_transfer_externaldata_torch import config
from vqa_transfer_externaldata_torch.data import datasets, features
from vqa_transfer_externaldata_torch.utils import vocab


def test_config_has_the_same_fields_and_defaults():
    for section in ("DataConfig", "ModelConfig", "TrainConfig",
                    "MeshConfig"):
        ours = [(f.name, f.type) for f in
                dataclasses.fields(getattr(config, section))]
        theirs = [(f.name, f.type) for f in
                  dataclasses.fields(getattr(jax_config, section))]
        assert ours == theirs, section
    assert config.Config().to_dict() == jax_config.Config().to_dict()


def test_config_flag_overlay_matches(tmp_path):
    overrides = tmp_path / "o.json"
    overrides.write_text(json.dumps({"model.rnn_dim": 64,
                                     "train.seed": 5}))
    argv = ["--config_json", str(overrides), "--model.dtype", "float32",
            "--data.synthetic", "true", "--train.seed", "9", "--unknown", "1"]
    ours = config.Config.from_args(argv)
    assert ours.to_dict() == jax_config.Config.from_args(argv).to_dict()
    assert (ours.model.rnn_dim, ours.train.seed) == (64, 9)
    with pytest.raises(KeyError):
        config.Config().replace_flat({"model.nope": 1})


def test_vocab_and_synthetic_vocabs_match():
    cfg = config.Config().replace_flat({"data.vocab_size": 40,
                                        "data.num_answers": 12})
    jcfg = jax_config.Config().replace_flat({"data.vocab_size": 40,
                                             "data.num_answers": 12})
    for ours, theirs in zip(datasets.synthetic_vocabs(cfg),
                            jax_datasets.synthetic_vocabs(jcfg)):
        assert ours.tokens == theirs.tokens
    texts = ["What color is the dog?", "how many w3's, w5 w7!", ""]
    built = vocab.Vocab.build(texts + ["dog dog cat"], max_size=8)
    jbuilt = jax_vocab.Vocab.build(texts + ["dog dog cat"], max_size=8)
    assert built.tokens == jbuilt.tokens
    for t in texts:
        assert vocab.tokenize(t) == jax_vocab.tokenize(t)
        ids, n = built.encode(t, 4)
        jids, jn = jbuilt.encode(t, 4)
        np.testing.assert_array_equal(ids, jids)
        assert n == jn
    with pytest.raises(ValueError, match="specials"):
        vocab.Vocab.from_tokens(["a", "b"])


def _write_stores(tmp_path, rng):
    grid = rng.normal(size=(6, 2, 2, 8)).astype(np.float16)
    pool5 = rng.normal(size=(6, 8)).astype(np.float32)
    ids = np.arange(100, 106, dtype=np.int64)
    npz = str(tmp_path / "s.npz")
    np.savez(npz, grid=grid, pool5=pool5, image_ids=ids)
    import h5py

    h5 = str(tmp_path / "s.hdf5")
    with h5py.File(h5, "w") as f:
        f["grid"], f["pool5"], f["image_ids"] = grid, pool5, ids
    raw = tmp_path / "raw"
    raw.mkdir()
    grid.tofile(raw / "grid.f16.bin")
    pool5.tofile(raw / "pool5.f32.bin")
    np.save(raw / "image_ids.npy", ids)
    (raw / "meta.json").write_text(json.dumps(
        {"grid_shape": list(grid.shape), "pool5_dim": 8}))
    return [npz, h5, str(raw)]


def test_feature_stores_gather_like_the_jax_ones(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.array([5, 0, 3, 3])
    for path in _write_stores(tmp_path, rng):
        ours, theirs = features.FeatureStore(path), \
            jax_features.FeatureStore(path)
        assert ours.index_of == theirs.index_of
        for flatten in (True, False):
            a = ours.gather(rows, flatten_grid=flatten)
            b = theirs.gather(rows, flatten_grid=flatten)
            for k in ("features", "pool5"):
                assert a[k].dtype == np.float32, (path, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=path)
        ours.close()
        theirs.close()
    grid = rng.normal(size=(3, 4, 8)).astype(np.float32)
    mem = features.InMemoryFeatureStore(grid, grid[:, 0])
    assert mem.index_of == {0: 0, 1: 1, 2: 2}
    np.testing.assert_array_equal(mem.gather(np.array([2]))["features"],
                                  grid[[2]])
    assert os.path.basename(mem.path) == "<memory>"

"""Port parity: feature extraction (``data/features.py::extract_features``,
``cli/extract.py``), the JPEG ingest (``data/ingest.py``) and the raw-image
branch of ``load_dataset`` against the JAX package, on JPEGs the test
writes.

The extractor is ResNet-101 (the JAX package's extractor is always
ResNet-101) at 64 pixels, random weights from a seed, written as a
torchvision-format checkpoint for the CLIs. Tolerances:

- float32 extraction: pool5 1e-4 of its largest |value|; the grid 2^-10
  of its largest |value|: both sides' f32 grids agree to ~1e-6, and each
  is rounded to float16 (steps of 2^-11 of a value) where a last-bit
  difference may flip the rounding.
- bfloat16 extraction (the CLIs'): 2^-5 of the largest |value|, and 2^-6
  in the mean. Each of the 104 convolutions rounds its output to bf16
  (steps of 2^-8) after f32 sums in another order; over 33 blocks the
  flips add up (measured 1.3e-2 at most, 1.0e-2 in the mean).
- pixels: the port's PIL path is JAX's bit for bit, and its decoder
  (native libjpeg where built, as JAX's) is JAX's bit for bit, within
  one 8-bit step of PIL's.
- the stores' layouts, image ids and region rows: exact.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_end2end import SIZE, TINY_E2E, write_jpeg_artifacts
from vqa_transfer_externaldata_tpu.cli import extract as jax_extract_cli
from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.data import features as jfeatures
from vqa_transfer_externaldata_tpu.data import ingest as jingest
from vqa_transfer_externaldata_torch.cli import extract as extract_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data import ingest
from vqa_transfer_externaldata_torch.data.features import (
    FeatureStore, extract_features)
from vqa_transfer_externaldata_torch.ops.resnet import (
    ResNetV1, convert_torch_state_dict, torchvision_state_dict)
from vqa_transfer_externaldata_torch.utils.convert import (
    batch_stats_to_flax, params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TOL_POOL5_F32, TOL_GRID_F32 = 1e-4, 2.0 ** -10
TOL_BF16_MAX, TOL_BF16_MEAN = 2.0 ** -5, 2.0 ** -6


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """JPEGs (some resized), a region table over them and a seeded
    ResNet-101 checkpoint in torchvision's names."""
    root = str(tmp_path_factory.mktemp("extract"))
    out = write_jpeg_artifacts(root, n_images=5)
    model = ResNetV1(dtype=torch.float32, stem="conv",
                     generator=torch.Generator().manual_seed(0))
    out["pth"] = os.path.join(root, "resnet101.pth")
    torch.save(torchvision_state_dict(model), out["pth"])
    ids = out["ids"]
    regions = os.path.join(root, "region_meta.npz")
    # Rows r = regions; a box of width 0 still crops one pixel.
    np.savez(regions,
             image_id=np.asarray([ids[1], ids[0], ids[1], ids[4], ids[2],
                                  ids[3], ids[0]], np.int64),
             bbox=np.asarray([[0, 0, 30, 20], [5, 7, 40, 40],
                              [10, 3, 0, 12], [0, 0, 64, 64],
                              [20, 30, 33, 17], [1, 1, 8, 60],
                              [40, 40, 24, 24]], np.int32))
    out["regions"] = regions
    out["root"] = root
    return out


def assert_stores_close(got_path, want_path, tol_max, tol_mean=None,
                        tol_pool5=None):
    got, want = FeatureStore(got_path), FeatureStore(want_path)
    np.testing.assert_array_equal(got.image_ids, want.image_ids)
    assert got.image_ids.dtype == want.image_ids.dtype == np.int64
    for key, tol in (("grid", tol_max), ("pool5", tol_pool5 or tol_max)):
        a = np.asarray(getattr(got, key))
        b = np.asarray(getattr(want, key))
        assert a.dtype == b.dtype and a.shape == b.shape, key
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.isfinite(a).all(), key
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), key
        if tol_mean is not None:
            assert np.abs(a - b).mean() <= tol_mean * np.abs(b).mean(), key
    got.close()
    want.close()


@pytest.mark.parametrize("fmt", ["raw", "hdf5"])
def test_extract_features_f32_matches_jax(fx, tmp_path, fmt):
    """Whole images, float32, the same weights on both sides (JAX's as
    flax variables bridged from the port's), batches padded to 4."""
    sd = convert_torch_state_dict(torch.load(fx["pth"], weights_only=True),
                                  stem="space_to_depth")
    variables = {"params": params_to_flax(sd),
                 "batch_stats": batch_stats_to_flax(sd)}
    paths = [ingest.coco_image_path(fx["image_dir"], "train2014", int(i))
             for i in fx["ids"]]
    out = {}
    for name, run in (("jax", lambda p: jfeatures.extract_features(
            paths, fx["ids"], p, batch_size=4, image_size=SIZE,
            variables=variables, dtype="float32", fmt=fmt)),
                      ("port", lambda p: extract_features(
            paths, fx["ids"], p, batch_size=4, image_size=SIZE,
            state_dict=sd, dtype="float32", fmt=fmt, device="cpu"))):
        out[name] = str(tmp_path / (name + (".hdf5" if fmt == "hdf5"
                                            else "")))
        assert run(out[name]) == out[name]
    assert_stores_close(out["port"], out["jax"], TOL_GRID_F32,
                        tol_pool5=TOL_POOL5_F32)
    if fmt == "raw":
        assert sorted(os.listdir(out["port"])) == sorted(
            os.listdir(out["jax"]))
        # Each package's FeatureStore reads the other's store.
        theirs = jfeatures.FeatureStore(out["port"])
        ours = FeatureStore(out["port"])
        rows = np.asarray([3, 0, 3])
        a, b = theirs.gather(rows), ours.gather(rows)
        for k in ("features", "pool5"):
            np.testing.assert_array_equal(a[k], b[k])
        assert theirs.index_of == ours.index_of


def test_extract_cli_matches_jax(fx, tmp_path):
    """``cli.extract`` from the torchvision checkpoint in bf16 (both CLIs'
    dtype): whole images (ids from the file names, the JPEG order) and
    region crops (``--regions``: row r = region r, ids 0..R-1)."""
    common = ["--image_dir", fx["image_dir"], "--image_size", str(SIZE),
              "--torch_checkpoint", fx["pth"], "--batch_size", "4",
              "--pattern", "COCO_train2014_*.jpg"]
    for extra in ([], ["--regions", fx["regions"]]):
        tag = "regions" if extra else "images"
        want = jax_extract_cli.main(common + extra + [
            "--out", str(tmp_path / f"jax_{tag}"), "--format", "raw"])
        got = extract_cli.main(common + extra + [
            "--out", str(tmp_path / f"port_{tag}"), "--format", "raw",
            "--device", "cpu"])
        assert_stores_close(got, want, TOL_BF16_MAX, TOL_BF16_MEAN)
        store = FeatureStore(got)
        if extra:
            np.testing.assert_array_equal(store.image_ids, np.arange(7))
        else:
            assert sorted(store.image_ids.tolist()) == \
                sorted(int(i) for i in fx["ids"])
        assert store.grid.shape[1:] == (SIZE // 32, SIZE // 32, 2048)
        store.close()
    with pytest.raises(FileNotFoundError, match="no images"):
        extract_cli.main(["--image_dir", str(tmp_path), "--out",
                          str(tmp_path / "none"), "--device", "cpu"])


def test_image_id_and_coco_path_equal_jax():
    """A name with a trailing integer gets JAX's id. One without gets a
    digest that every process agrees on (JAX's ``hash`` is salted per
    process: ROADMAP.md section 3), in [0, 2**62)."""
    for name in ("COCO_train2014_000000000123.jpg", "/a/b/2345.jpg",
                 "img_7.png"):
        assert extract_cli.image_id_from_name(name) == \
            jax_extract_cli.image_id_from_name(name)
    ours = extract_cli.image_id_from_name("/a/plain.jpg")
    assert 0 <= ours < 1 << 62
    assert ours == extract_cli.image_id_from_name("plain.png")
    assert ours != extract_cli.image_id_from_name("plainer.jpg")
    code = ("from vqa_transfer_externaldata_torch.cli.extract import "
            "image_id_from_name as f; print(f('plain.jpg'))")
    for seed in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-c", code], check=True, capture_output=True,
            text=True, env={**os.environ, "PYTHONHASHSEED": seed},
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert int(out.stdout) == ours
    assert ingest.coco_image_path("d", "val2014", 42) == \
        jingest.coco_image_path("d", "val2014", 42)


def test_decode_equals_jax_pil_and_native_within_one_step(fx):
    """The port's PIL path is JAX's bit for bit and within one 8-bit step
    of JAX's decoder (native libjpeg where built); the port's decoder
    (native where built) is JAX's bit for bit."""
    paths = [ingest.coco_image_path(fx["image_dir"], "val2014", int(i))
             for i in fx["ids"]]
    for p in paths:
        ours = ingest._decode_pil(p, SIZE)
        assert ours.shape == (SIZE, SIZE, 3) and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, jingest._decode_pil(p, SIZE))
        theirs = jingest._decode(p, SIZE)
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
        np.testing.assert_array_equal(ingest._decode(p, SIZE), theirs)


@pytest.mark.parametrize("split", ["train", "val"])
def test_raw_image_load_dataset_equals_jax(fx, split, tmp_path):
    """The raw-image branch of ``load_dataset``: the table's columns and
    batches as JAX's, the paths named for the split's COCO split, and the
    decoded pixels within one step of JAX's (bit-equal to its PIL)."""
    over = dict(TINY_E2E, **{"data.synthetic": False,
                             "data.dataset_dir": fx["data_dir"],
                             "data.image_dir": fx["image_dir"]})
    ours = tds.load_dataset(Config().replace_flat(over), split)
    theirs = jds.load_dataset(JaxConfig().replace_flat(over), split)
    assert type(ours).__name__ == "ImageQuestionDataset"
    assert ours.image_paths == theirs.image_paths
    assert f"COCO_{split}2014_" in ours.image_paths[0]
    for k in theirs.arrays:
        np.testing.assert_array_equal(ours.arrays[k], theirs.arrays[k])
    a = next(ours.batches(4, seed=3))
    b = next(theirs.batches(4, seed=3))
    assert sorted(a) == sorted(b)
    for k in b:
        if k == "images":
            assert a[k].dtype == np.uint8 and a[k].shape == b[k].shape
            assert np.abs(a[k].astype(int) - b[k].astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # take() decodes too: the evaluator's padded batches carry images.
    assert ours.take(np.arange(3))["images"].shape == (3, SIZE, SIZE, 3)
    ours.close()
    theirs.close()
    shutil.copy(os.path.join(fx["data_dir"], f"vqa_{split}.npz"), tmp_path)
    with pytest.raises(FileNotFoundError, match="image_ids.npy"):
        tds.load_dataset(Config().replace_flat(dict(
            over, **{"data.dataset_dir": str(tmp_path)})), split)


def test_build_image_question_dataset_equals_jax(fx):
    npz = os.path.join(fx["data_dir"], "vqa_train.npz")
    ours = ingest.build_image_question_dataset(
        npz, fx["image_dir"], "train2014", fx["ids"], image_size=SIZE)
    theirs = jingest.build_image_question_dataset(
        npz, fx["image_dir"], "train2014", fx["ids"], image_size=SIZE)
    assert ours.image_paths == theirs.image_paths
    a, b = next(ours.batches(5, seed=0)), next(theirs.batches(5, seed=0))
    np.testing.assert_array_equal(a["image_index"], b["image_index"])
    assert np.abs(a["images"].astype(int) - b["images"].astype(int)).max() \
        <= 1
    ours.close()
    theirs.close()

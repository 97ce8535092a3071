"""Port parity: the native host-IO libraries (``data/native.py``,
``native/io_kernels.cc``, ``native/jpeg_decode.cc``) and where they are
wired (``FeatureStore.gather`` on raw stores, ``ingest._decode``,
``ImageQuestionDataset``), against numpy, PIL and the JAX package's own
native library.

Tolerances: the gathers bit for bit (numpy's and JAX's, f16 specials
included); the decoder bit for bit against JAX's native decoder (the same
source built by the same compiler) and against PIL at the file's own
size, within one 8-bit step of PIL after a resize (PIL's BILINEAR is the
same triangle filter in 8-bit fixed point, the library's in float).
"""

import logging
import os
import shutil

import numpy as np
import pytest

from vqa_transfer_externaldata_tpu.data import features as jfeatures
from vqa_transfer_externaldata_tpu.data import native as jnative
from vqa_transfer_externaldata_torch.data import features as tfeatures
from vqa_transfer_externaldata_torch.data import ingest
from vqa_transfer_externaldata_torch.data import native

SPECIALS = np.array([0.0, -0.0, 1.0, -2.5, 65504.0, -65504.0, 6.1e-5,
                     5.96e-8, -5.96e-8, 1e-6, np.inf, -np.inf, np.nan],
                    np.float16)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.fixture(scope="module", autouse=True)
def _built():
    assert native.available(), "g++ builds the gather library here"
    assert native.jpeg_available(), "g++ and libjpeg build the decoder here"


@pytest.mark.parametrize("shape,n", [((50, 7, 33), 17), ((9, 2, 2, 16), 9),
                                     ((3, 13), 0), ((4, 1), 5)])
def test_gathers_equal_numpy_and_jax(shape, n):
    """gather_f16 (widened and not) and gather_f32 give numpy's and JAX's
    native gathers' bits, f16 subnormals, infinities and NaN included."""
    rng = np.random.default_rng(n)
    base = rng.normal(size=shape).astype(np.float16)
    flat = base.reshape(-1)
    flat[:min(flat.size, SPECIALS.size)] = SPECIALS[:flat.size]
    idx = rng.integers(0, shape[0], size=n).astype(np.int32)
    idx[:1] = 0  # the row of specials
    base32 = rng.normal(size=shape).astype(np.float32)
    for got, numpy_ref, jax_ref in (
            (native.gather_f16(base, idx), base[idx].astype(np.float32),
             jnative.gather_f16(base, idx, widen=True)),
            (native.gather_f16(base, idx, widen=False), base[idx],
             jnative.gather_f16(base, idx, widen=False)),
            (native.gather_f32(base32, idx), base32[idx],
             jnative.gather_f32(base32, idx))):
        assert got.shape == numpy_ref.shape and got.dtype == numpy_ref.dtype
        np.testing.assert_array_equal(_bits(got), _bits(numpy_ref))
        np.testing.assert_array_equal(_bits(got), _bits(jax_ref))


def test_gathers_refuse_what_the_copy_cannot_read():
    """Rows outside the store, a base of another dtype and rows not laid
    out back to back raise before any native copy."""
    base = np.zeros((4, 3), np.float16)
    for bad in ([4], [-1], [0, 7]):
        with pytest.raises(IndexError):
            native.gather_f16(base, np.array(bad))
        with pytest.raises(IndexError):
            native.gather_f32(base.astype(np.float32), np.array(bad))
    with pytest.raises(TypeError):
        native.gather_f16(base.astype(np.float32), np.array([0]))
    with pytest.raises(TypeError):
        native.gather_f32(base, np.array([0]))
    with pytest.raises(ValueError):
        native.gather_f16(np.zeros((4, 6), np.float16)[:, ::2],
                          np.array([0]))


def _write_raw_store(path, m=6, g=2, c=8, seed=0):
    """A raw feature store as the extractor writes it."""
    import json

    rng = np.random.default_rng(seed)
    os.makedirs(path)
    grid = rng.normal(size=(m, g, g, c)).astype(np.float16)
    pool5 = rng.normal(size=(m, c)).astype(np.float32)
    grid.tofile(os.path.join(path, "grid.f16.bin"))
    pool5.tofile(os.path.join(path, "pool5.f32.bin"))
    np.save(os.path.join(path, "image_ids.npy"),
            np.arange(m, dtype=np.int64) + 100)
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"grid_shape": [m, g, g, c], "pool5_dim": c}, fh)
    return grid, pool5


@pytest.mark.parametrize("flatten", [True, False])
def test_raw_store_gathers_through_the_library(flatten, tmp_path,
                                               monkeypatch):
    """``FeatureStore.gather`` on a raw directory takes the native
    gathers (widened f16 grid, f32 pool5) and gives the memory map's rows
    and JAX's ``FeatureStore.gather``'s, bit for bit."""
    path = str(tmp_path / "raw")
    grid, pool5 = _write_raw_store(path)
    calls = []
    for name in ("gather_f16", "gather_f32"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    store = tfeatures.FeatureStore(path)
    assert store.index_of[102] == 2
    idx = np.array([5, 0, 2, 2], np.int32)
    got = store.gather(idx, flatten_grid=flatten)
    assert calls == ["gather_f16", "gather_f32"]
    want_grid = grid[idx].astype(np.float32)
    if flatten:
        want_grid = want_grid.reshape(4, 4, 8)
    np.testing.assert_array_equal(got["features"], want_grid)
    np.testing.assert_array_equal(got["pool5"], pool5[idx])
    theirs = jfeatures.FeatureStore(path).gather(idx, flatten_grid=flatten)
    for k in ("features", "pool5"):
        assert got[k].dtype == theirs[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], theirs[k])
    joined = tfeatures.JoinedDataset(
        {"image_index": idx, "answer_id": np.arange(4)}, store).take(
        np.array([3, 1]))
    np.testing.assert_array_equal(joined["pool5"], pool5[[2, 0]])


def _jpeg(path, h, w, seed, mode="RGB", quality=95):
    from PIL import Image

    rng = np.random.default_rng(seed)
    if mode == "L":
        img = Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8),
                              mode="L")
    else:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8))
        if mode == "CMYK":
            img = img.convert("CMYK")
    img.save(path, quality=quality)
    return path


@pytest.mark.parametrize("w,h,size,mode", [
    (96, 96, 96, "RGB"),    # no resize: PIL's bits
    (128, 96, 64, "RGB"),   # downscale
    (40, 60, 96, "RGB"),    # upscale
    (448, 448, 448, "RGB"),
    (500, 375, 448, "RGB"),  # a COCO-sized photo to the model's input
    (50, 50, 50, "L"),      # grayscale converts to RGB
    (70, 45, 32, "L")])
def test_decode_equals_jax_native_and_pil(w, h, size, mode, tmp_path):
    """The port's decoder gives JAX's native decoder's bits, PIL's at the
    file's size, and within one 8-bit step of PIL's after a resize."""
    path = _jpeg(str(tmp_path / "a.jpg"), h, w, seed=w * h, mode=mode)
    images, status = native.decode_jpeg_batch([path], size, threads=2)
    theirs, their_status = jnative.decode_jpeg_batch([path], size)
    assert status.tolist() == their_status.tolist() == [0]
    assert images.shape == (1, size, size, 3) and images.dtype == np.uint8
    np.testing.assert_array_equal(images, theirs)
    diff = np.abs(images[0].astype(int) - ingest._decode_pil(path, size))
    assert diff.max() <= (0 if (w, h) == (size, size) else 1), diff.max()
    np.testing.assert_array_equal(ingest._decode(path, size), images[0])


def test_rejected_files_are_flagged_and_decoded_by_pil(tmp_path,
                                                      monkeypatch):
    """A missing file, a CMYK JPEG and a truncated one are flagged (their
    images zeros); ``_decode`` and ``ImageQuestionDataset.take`` give PIL's
    pixels for the CMYK file and the native ones for the rest, in one
    native call a batch; a file neither reads raises."""
    good = _jpeg(str(tmp_path / "good.jpg"), 30, 40, seed=1)
    cmyk = _jpeg(str(tmp_path / "cmyk.jpg"), 30, 40, seed=2, mode="CMYK")
    broken = str(tmp_path / "broken.jpg")
    with open(good, "rb") as fh, open(broken, "wb") as out:
        out.write(fh.read()[:100])
    missing = str(tmp_path / "missing.jpg")
    images, status = native.decode_jpeg_batch([good, cmyk, missing, broken],
                                              16)
    assert status[0] == 0 and (status[1:] != 0).all()
    assert not images[1:].any()
    np.testing.assert_array_equal(ingest._decode(cmyk, 16),
                                  ingest._decode_pil(cmyk, 16))
    rows = {"answer_id": np.arange(4, dtype=np.int32),
            "image_index": np.array([0, 1, 1, 0], np.int32)}
    ds = ingest.ImageQuestionDataset(rows, [good, cmyk], image_size=16)
    calls, real = [], native.decode_jpeg_batch
    monkeypatch.setattr(native, "decode_jpeg_batch",
                        lambda p, size: calls.append(len(p)) or real(p, size))
    batch = ds.take(np.arange(4))
    ds.close()
    assert calls == [4]
    monkeypatch.undo()
    for i, path in enumerate([good, cmyk, cmyk, good]):
        np.testing.assert_array_equal(batch["images"][i],
                                      ingest._decode(path, 16))
    with pytest.raises(OSError):
        ingest._decode(missing, 16)


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def failed_build(tmp_path, monkeypatch):
    """The libraries forced not to build: a fresh build directory, no
    library loaded yet, and a build function that fails as a missing
    compiler would."""
    def no_compiler(src, out, link):
        raise FileNotFoundError(2, "No such file or directory", "g++")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_build", no_compiler)
    handler = _Warnings()
    logging.getLogger("vqa_torch").addHandler(handler)
    yield handler.messages
    logging.getLogger("vqa_torch").removeHandler(handler)


def test_failed_build_falls_back_to_numpy(failed_build):
    """Without the gather library: numpy's rows, one warning, and
    ``available()`` false."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(20, 3, 5)).astype(np.float16)
    idx = np.array([4, 0, 19, 4], np.int32)
    np.testing.assert_array_equal(native.gather_f16(base, idx),
                                  base[idx].astype(np.float32))
    np.testing.assert_array_equal(native.gather_f16(base, idx, widen=False),
                                  base[idx])
    base32 = base.astype(np.float32)
    np.testing.assert_array_equal(native.gather_f32(base32, idx),
                                  base32[idx])
    assert not native.available()
    assert len(failed_build) == 1 and "numpy gathers" in failed_build[0]


def test_failed_build_falls_back_to_pil(failed_build, tmp_path):
    """Without the decoder: ``decode_jpeg_batch`` returns None, and
    ``_decode`` and ``ImageQuestionDataset`` give PIL's pixels; one
    warning, ``jpeg_available()`` false."""
    paths = [_jpeg(str(tmp_path / f"{i}.jpg"), 20 + i, 30, seed=i)
             for i in range(3)]
    assert native.decode_jpeg_batch(paths, 16) is None
    for p in paths:
        np.testing.assert_array_equal(ingest._decode(p, 16),
                                      ingest._decode_pil(p, 16))
    ds = ingest.ImageQuestionDataset(
        {"image_index": np.array([2, 0, 1], np.int32)}, paths, image_size=16)
    batch = ds.take(np.arange(3))
    ds.close()
    np.testing.assert_array_equal(
        batch["images"], np.stack([ingest._decode_pil(p, 16)
                                   for p in (paths[2], paths[0], paths[1])]))
    assert not native.jpeg_available()
    assert len(failed_build) == 1 and "PIL decode" in failed_build[0]


def test_library_rebuilds_when_older_than_its_source(tmp_path, monkeypatch):
    """A first use builds into the build directory; a later process loads
    that build; a library older than its source is built again."""
    builds = []
    real = native._build
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_build",
                        lambda *a: builds.append(a[1]) or real(*a))
    lib = tmp_path / "libvqa_io.so"

    def first_use():
        monkeypatch.setattr(native, "_loaded", {})
        return native.available()

    assert first_use() and builds == [lib]
    assert first_use() and builds == [lib]
    old = (native.SRC_DIR / "io_kernels.cc").stat().st_mtime - 10
    os.utime(lib, (old, old))
    assert first_use() and builds == [lib, lib]
    assert [p.name for p in tmp_path.iterdir()] == ["libvqa_io.so"]


def test_library_that_does_not_load_is_rebuilt_once(tmp_path, monkeypatch):
    """A build newer than its source that does not load (a library it
    links moved, a truncated file) is built again once and loads."""
    builds = []
    real = native._build
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_build",
                        lambda *a: builds.append(a[1]) or real(*a))
    lib = tmp_path / "libvqa_io.so"
    lib.write_bytes(b"not a shared object")
    assert not native._stale(lib, [native.SRC_DIR / "io_kernels.cc"])
    assert native.available() and builds == [lib]


def test_pillow_build_is_stale_when_a_link_input_is_newer(tmp_path,
                                                          monkeypatch):
    """The second route's build is built again when a header copy or the
    libjpeg it links is newer than it, not only its source."""
    inc = tmp_path / "include"
    shutil.copytree(native.INCLUDE_DIR, inc)
    pil = tmp_path / "libjpeg-0.so.62"
    shutil.copy(native.pillow_libjpeg(), pil)
    monkeypatch.setattr(native, "INCLUDE_DIR", inc)
    monkeypatch.setattr(native, "pillow_libjpeg", lambda: str(pil))
    route, name, link, inputs = native._routes_of("jpeg")[1]
    assert route == "pillow" and str(pil) in link
    assert set(inputs) == {*inc.glob("*.h"), pil}
    out = tmp_path / name
    out.write_bytes(b"")
    src = native.SRC_DIR / "jpeg_decode.cc"
    t = max(src.stat().st_mtime, *(p.stat().st_mtime for p in inputs)) + 10
    os.utime(out, (t, t))
    assert not native._stale(out, (src, *inputs))
    for newer in (inc / "jpeglib.h", pil):
        os.utime(newer, (t + 10, t + 10))
        assert native._stale(out, (src, *inputs)), newer
        os.utime(out, (t + 20, t + 20))
        t += 20


@pytest.fixture
def pillow_route(tmp_path, monkeypatch):
    """The decoder forced onto its second route, as on a machine without
    libjpeg's headers: a fresh build directory, nothing loaded, and the
    system build (``-ljpeg``) failing as g++ does there. Returns the
    builds tried, in order."""
    builds, real = [], native._build

    def build(src, out, link):
        builds.append(out.name)
        if "-ljpeg" in link:
            raise OSError("jpeglib.h: No such file or directory")
        return real(src, out, link)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_routes", {})
    monkeypatch.setattr(native, "_build", build)
    assert native.pillow_libjpeg() is not None, "Pillow ships libjpeg here"
    yield builds


@pytest.mark.parametrize("w,h,size,mode,quality", [
    (96, 96, 96, "RGB", 95),
    (128, 96, 64, "RGB", 75),
    (40, 60, 96, "RGB", 50),
    (500, 375, 448, "RGB", 90),
    (33, 17, 24, "RGB", 10),
    (50, 50, 50, "L", 95),
    (70, 45, 32, "L", 60)])
def test_pillow_route_decodes_as_jax_native(w, h, size, mode, quality,
                                            tmp_path, pillow_route):
    """Built by the second route (the port's header copies, Pillow's
    libjpeg), the decoder gives JAX's native decoder's bits on PIL-written
    JPEGs of several sizes and qualities, grayscale included."""
    path = _jpeg(str(tmp_path / "a.jpg"), h, w, seed=w + h, mode=mode,
                 quality=quality)
    images, status = native.decode_jpeg_batch([path], size, threads=2)
    assert native.jpeg_route() == "pillow"
    assert pillow_route == ["libvqa_jpeg.so", "libvqa_jpeg_pillow.so"]
    theirs, their_status = jnative.decode_jpeg_batch([path], size)
    assert status.tolist() == their_status.tolist() == [0]
    np.testing.assert_array_equal(images, theirs)
    np.testing.assert_array_equal(ingest._decode(path, size), images[0])


def test_pillow_route_leaves_cmyk_to_pil(tmp_path, pillow_route):
    """On the second route a CMYK JPEG is flagged as on the first (zeros,
    a nonzero status) and ``_decode`` gives PIL's pixels for it."""
    good = _jpeg(str(tmp_path / "good.jpg"), 30, 40, seed=1)
    cmyk = _jpeg(str(tmp_path / "cmyk.jpg"), 30, 40, seed=2, mode="CMYK")
    images, status = native.decode_jpeg_batch([good, cmyk], 16)
    assert native.jpeg_route() == "pillow"
    assert status[0] == 0 and status[1] != 0 and not images[1].any()
    theirs, _ = jnative.decode_jpeg_batch([good], 16)
    np.testing.assert_array_equal(images[:1], theirs)
    np.testing.assert_array_equal(ingest._decode(cmyk, 16),
                                  ingest._decode_pil(cmyk, 16))


def test_system_route_is_tried_first(tmp_path, monkeypatch):
    """Where the system's libjpeg builds, the decoder takes it: one build,
    of ``libvqa_jpeg.so`` with ``-ljpeg``, and no Pillow build."""
    builds, real = [], native._build
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_routes", {})
    monkeypatch.setattr(native, "_build", lambda src, out, link: builds.append(
        (out.name, tuple(link))) or real(src, out, link))
    assert native.jpeg_available() and native.jpeg_route() == "system"
    assert builds == [("libvqa_jpeg.so", ("-ljpeg",))]
    assert [p.name for p in tmp_path.iterdir()] == ["libvqa_jpeg.so"]


def test_every_route_failing_falls_back_to_pil_once(failed_build, tmp_path,
                                                    monkeypatch):
    """Where neither route builds, both are tried, PIL decodes, the route
    is None and one warning names both routes' errors."""
    tried = []
    monkeypatch.setattr(native, "_routes", {})
    failing = native._build
    monkeypatch.setattr(native, "_build", lambda src, out, link: tried.append(
        out.name) or failing(src, out, link))
    path = _jpeg(str(tmp_path / "a.jpg"), 20, 30, seed=5)
    assert native.decode_jpeg_batch([path], 16) is None
    assert native.jpeg_route() is None
    assert tried == ["libvqa_jpeg.so", "libvqa_jpeg_pillow.so"]
    np.testing.assert_array_equal(ingest._decode(path, 16),
                                  ingest._decode_pil(path, 16))
    assert len(failed_build) == 1
    assert "system:" in failed_build[0] and "pillow:" in failed_build[0]

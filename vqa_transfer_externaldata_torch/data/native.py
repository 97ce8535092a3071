"""The port's native host-IO libraries, loaded with ``ctypes``:
multi-threaded row gathers over raw feature stores (``native/io_kernels.cc``)
and a batched libjpeg decoder with PIL's triangle resize
(``native/jpeg_decode.cc``).

Each library is compiled with ``g++`` at its first use (never at import)
into ``<repo>/build/torch_native/``, and again whenever it is older than
any of its inputs (its source; the header copies and the libjpeg it links
on the "pillow" route) or an existing build fails to load. The decoder
takes the first of two routes that builds: "system", against the
machine's libjpeg (``-ljpeg``, as the JAX package builds it); then
"pillow", against the port's copies of libjpeg-turbo's headers
(``native/include/``, with its license) linked to the libjpeg that Pillow
ships in the ``pillow.libs`` directory beside ``PIL``, with an rpath to it.
Where the machine has no ``jpeglib.h``, each process that decodes first
tries the system build, which stops at that missing header in a fraction
of a second. Where every route fails (no compiler, no libjpeg) the gathers
fall back to numpy fancy indexing and the decoder to PIL, with one logged
warning: :func:`available`, :func:`jpeg_available` and :func:`jpeg_route`
say which path is live.
"""

from __future__ import annotations

import ctypes
import glob
import importlib.util
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vqa_transfer_externaldata_torch.utils.logging import log

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

INCLUDE_DIR = SRC_DIR / "include"

# library -> (source, ABI entry, what runs without it). The decoder is its
# own object (it needs libjpeg), so the gathers build where libjpeg is
# missing.
_LIBS = {"io": ("io_kernels.cc", "vqa_io_abi_version", "numpy gathers"),
         "jpeg": ("jpeg_decode.cc", "vqa_jpeg_abi_version", "PIL decode")}

_lock = threading.Lock()
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
_routes: Dict[str, Optional[str]] = {}

_u16p = ctypes.POINTER(ctypes.c_uint16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def pillow_libjpeg() -> Optional[str]:
    """The libjpeg shared object that Pillow ships (``libjpeg-*.so.62*`` in
    the ``pillow.libs`` directory beside the ``PIL`` package), or None
    where Pillow is not installed or ships none (a build against the
    system's libjpeg)."""
    try:
        spec = importlib.util.find_spec("PIL")
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.submodule_search_locations:
        return None
    pil = Path(list(spec.submodule_search_locations)[0])
    found = sorted(glob.glob(str(pil.parent / "pillow.libs"
                                 / "libjpeg-*.so.62*")))
    return found[0] if found else None


def _routes_of(name: str
               ) -> List[Tuple[str, str, Tuple[str, ...], Tuple[Path, ...]]]:
    """The builds of library ``name`` to try in order: (route, output file
    name, compiler and link flags, the inputs besides the source that a
    build is older than when stale). The gathers have one; the decoder the
    system's libjpeg, then Pillow's through the port's header copies
    (where Pillow ships one)."""
    if name == "io":
        return [("system", "libvqa_io.so", (), ())]
    routes = [("system", "libvqa_jpeg.so", ("-ljpeg",), ())]
    pil = pillow_libjpeg()
    if pil is not None and (INCLUDE_DIR / "jpeglib.h").exists():
        routes.append(("pillow", "libvqa_jpeg_pillow.so", (
            f"-I{INCLUDE_DIR}", pil, f"-Wl,-rpath,{os.path.dirname(pil)}"),
            (*sorted(INCLUDE_DIR.glob("*.h")), Path(pil))))
    return routes


def _stale(out: Path, inputs: Sequence[Path]) -> bool:
    """Whether the build ``out`` is missing or older than any of its
    ``inputs`` that exist (a prebuilt library without its source just
    loads)."""
    try:
        built = out.stat().st_mtime
    except OSError:
        return True
    for path in inputs:
        try:
            if path.stat().st_mtime > built:
                return True
        except OSError:
            continue
    return False


def _open(name: str, out: Path, abi: str) -> ctypes.CDLL:
    """The built library ``out`` loaded, its ABI version checked and its
    functions declared; raises OSError where it cannot."""
    lib = ctypes.CDLL(str(out))
    getattr(lib, abi).restype = ctypes.c_int
    version = getattr(lib, abi)()
    if version != 1:
        raise OSError(f"{out}: {abi}() = {version}, expected 1")
    _declare(name, lib)
    return lib


def _build(src: Path, out: Path, link: Sequence[str]) -> None:
    """Compile ``src`` into the shared object ``out``: written beside it,
    then renamed, so a concurrent build never loads half a library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-pthread",
           "-std=c++17", str(src), *link, "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise OSError(f"{' '.join(cmd)}: {e.stderr.decode()[-500:]}") from e
    finally:
        tmp.unlink(missing_ok=True)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    i64, c_int = ctypes.c_int64, ctypes.c_int
    if name == "io":
        fns = {"gather_rows_f16": [_u16p, i64, _i32p, i64, _u16p, c_int],
               "gather_rows_f16_to_f32": [_u16p, i64, _i32p, i64, _f32p,
                                          c_int],
               "gather_rows_f32": [_f32p, i64, _i32p, i64, _f32p, c_int]}
    else:
        fns = {"decode_jpeg_batch": [ctypes.POINTER(ctypes.c_char_p), i64,
                                     c_int, _u8p, _i32p, c_int]}
    for fn, argtypes in fns.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The library ``name`` ("io" or "jpeg") of the first route of
    :func:`_routes_of` that builds and loads, built when missing or older
    than any of its inputs, and built again once where an earlier build
    does not load; None (and one warning naming every route's error) when
    none does. The outcome is kept for the process."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        source, abi, fallback = _LIBS[name]
        src = SRC_DIR / source
        lib, route, errors = None, None, []
        for route_name, file_name, link, inputs in _routes_of(name):
            out = BUILD_DIR / file_name
            built = _stale(out, (src, *inputs))
            try:
                if built:
                    _build(src, out, link)
                try:
                    lib = _open(name, out, abi)
                except OSError:
                    if built:
                        raise
                    _build(src, out, link)  # e.g. a moved libjpeg
                    lib = _open(name, out, abi)
                route = route_name
                break
            except (OSError, subprocess.SubprocessError) as e:
                errors.append(f"{route_name}: {e}")
                lib = None
        if lib is None:
            log.warning("native %s library unavailable (%s); using %s",
                        name, "; ".join(errors), fallback)
        elif name == "jpeg":
            log.info("native jpeg library built by the %s route%s", route,
                     f" (after {'; '.join(errors)})" if errors else "")
        _loaded[name], _routes[name] = lib, route
        return lib


def available() -> bool:
    """Whether the gathers run in the native library (else numpy)."""
    return _load("io") is not None


def jpeg_available() -> bool:
    """Whether :func:`decode_jpeg_batch` decodes (else it returns None)."""
    return _load("jpeg") is not None


def jpeg_route() -> Optional[str]:
    """The route the decoder was built by: "system" (``-ljpeg``), "pillow"
    (the port's headers and Pillow's libjpeg), or None where neither built
    and PIL decodes."""
    _load("jpeg")
    return _routes.get("jpeg")


def _threads() -> int:
    return min(8, os.cpu_count() or 1)


def _rows(base: np.ndarray, idx, dtype) -> tuple:
    """``idx`` as contiguous int32 and ``base`` as a [M, row] view. A base
    of another dtype, rows outside [0, M) and rows not laid out back to
    back raise: the native copy would read the wrong bytes or out of
    bounds."""
    if base.dtype != dtype:
        raise TypeError(f"expected {np.dtype(dtype).name} rows, got "
                        f"{base.dtype}")
    idx = np.ascontiguousarray(idx, np.int32)
    if idx.size and (idx.min() < 0 or idx.max() >= base.shape[0]):
        raise IndexError(f"rows {idx.min()}..{idx.max()} outside "
                         f"[0, {base.shape[0]})")
    flat = base.reshape(base.shape[0], -1)
    if not flat.flags.c_contiguous:
        raise ValueError("the rows must be C-contiguous")
    return idx, flat


def gather_f16(base: np.ndarray, idx, widen: bool = True) -> np.ndarray:
    """Rows ``idx`` of ``base`` ([M, ...] float16, C-contiguous, e.g. an
    ``np.memmap``): [n, ...] float32 (``widen``) or float16, copied by
    parallel threads. Bit-equal to ``base[idx]`` (widened)."""
    idx, flat = _rows(base, idx, np.float16)
    lib = _load("io")
    if lib is None:
        out = base[idx]
        return out.astype(np.float32) if widen else out
    n, row = idx.shape[0], flat.shape[1]
    out = np.empty((n, row), np.float32 if widen else np.float16)
    fn = lib.gather_rows_f16_to_f32 if widen else lib.gather_rows_f16
    fn(flat.ctypes.data_as(_u16p), row, idx.ctypes.data_as(_i32p), n,
       out.ctypes.data_as(_f32p if widen else _u16p), _threads())
    return out.reshape((n,) + base.shape[1:])


def gather_f32(base: np.ndarray, idx) -> np.ndarray:
    """Rows ``idx`` of ``base`` ([M, ...] float32, C-contiguous), copied by
    parallel threads; bit-equal to ``base[idx]``."""
    idx, flat = _rows(base, idx, np.float32)
    lib = _load("io")
    if lib is None:
        return np.ascontiguousarray(base[idx])
    n, row = idx.shape[0], flat.shape[1]
    out = np.empty((n, row), np.float32)
    lib.gather_rows_f32(flat.ctypes.data_as(_f32p), row,
                        idx.ctypes.data_as(_i32p), n,
                        out.ctypes.data_as(_f32p), _threads())
    return out.reshape((n,) + base.shape[1:])


def decode_jpeg_batch(paths: Sequence[str], size: int,
                      threads: Optional[int] = None):
    """Decode and resize JPEG files to [n, size, size, 3] uint8 RGB in
    ``threads`` C++ threads (default one a core, at most 16; the GIL is
    released for the whole call). Returns ``(images, status)``, where
    ``status[i] != 0`` marks a file the caller must decode itself
    (missing, corrupt, CMYK; its image is zeros), or None when the library
    is unavailable."""
    lib = _load("jpeg")
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.empty(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_jpeg_batch(c_paths, n, size, out.ctypes.data_as(_u8p),
                          status.ctypes.data_as(_i32p),
                          threads if threads else min(16, os.cpu_count() or 1))
    return out, status

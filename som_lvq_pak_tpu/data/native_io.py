"""ctypes binding to the native C++ data-file engine (native/somvq_io.cpp).

The native library is optional: `available()` reports whether it could be
loaded, and read/write fall back to the pure-Python implementation in
data.io when it is not.  The library is never committed: the first load
in a process runs the in-tree Makefile, which rebuilds it only when the
source is newer.

The reference's data layer is C (datafile.c); this is its framework
equivalent for the host-side hot path — parsing multi-gigabyte training
files into dense arrays at memcpy-like speed instead of Python-loop
speed."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsomvq_io.so")

_lib = None
_tried = False


class _SvqData(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("dim", ctypes.c_int32),
        ("topol", ctypes.c_int32),
        ("neigh", ctypes.c_int32),
        ("xdim", ctypes.c_int32),
        ("ydim", ctypes.c_int32),
        ("points", ctypes.POINTER(ctypes.c_float)),
        ("mask", ctypes.POINTER(ctypes.c_uint8)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("fixedpt", ctypes.POINTER(ctypes.c_int32)),
        ("labstr", ctypes.POINTER(ctypes.c_char)),
        ("labstr_len", ctypes.c_int64),
        ("labcnt", ctypes.POINTER(ctypes.c_int32)),
        ("total_labels", ctypes.c_int64),
        ("comments", ctypes.POINTER(ctypes.c_char)),
        ("comments_len", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
    ]


def _build() -> bool:
    if not os.path.isdir(_NATIVE_DIR):
        return False
    try:
        subprocess.run(
            ["make", "-s", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.svq_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_SvqData)
    ]
    lib.svq_parse_file.restype = ctypes.c_int
    lib.svq_parse_buffer.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(_SvqData),
    ]
    lib.svq_parse_buffer.restype = ctypes.c_int
    lib.svq_free.argtypes = [ctypes.POINTER(_SvqData)]
    lib.svq_format_entries.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.svq_format_entries.restype = ctypes.c_void_p
    lib.svq_free_text.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _collect(d: _SvqData, labels, skipped_header: bool = False):
    """Turn the C struct into a Dataset (intern labels on the way)."""
    from .dataset import Dataset, Neighborhood, Topology
    from .labels import GLOBAL_LABELS

    table = labels if labels is not None else GLOBAL_LABELS
    n, dim = int(d.n), int(d.dim)
    points = np.ctypeslib.as_array(d.points, shape=(n, dim)).copy() if n else \
        np.zeros((0, dim), dtype=np.float32)
    mask = None
    if d.mask:
        mask = np.ctypeslib.as_array(d.mask, shape=(n, dim)).copy()
    weight = None
    if d.weight:
        weight = np.ctypeslib.as_array(d.weight, shape=(n,)).copy()
    fixed = None
    if d.fixedpt:
        fixed = np.ctypeslib.as_array(d.fixedpt, shape=(n, 2)).copy()

    lab_arr = None
    if d.total_labels:
        labcnt = np.ctypeslib.as_array(d.labcnt, shape=(n,))
        width = int(labcnt.max()) if n else 0
        raw = ctypes.string_at(d.labstr, d.labstr_len)
        toks = raw.split(b"\0")[:-1] if d.labstr_len else []
        ids = [table.to_index(t.decode()) for t in toks]
        lab_arr = np.zeros((n, max(width, 1)), dtype=np.int32)
        k = 0
        for i in range(n):
            c = int(labcnt[i])
            lab_arr[i, :c] = ids[k : k + c]
            k += c

    comments: List[str] = []
    if d.comments_len:
        comments = ctypes.string_at(d.comments, d.comments_len).decode().split("\n")

    return Dataset(
        points=points,
        mask=mask,
        labels=lab_arr,
        weight=weight,
        fixed=fixed,
        topol=Topology(d.topol),
        neigh=Neighborhood(d.neigh),
        xdim=int(d.xdim),
        ydim=int(d.ydim),
        comments=comments,
    )


def read_data_native(
    name: str,
    labels=None,
    skip_empty: bool = True,
    mask_str: Optional[str] = None,
):
    """Parse a plain (uncompressed, file-backed) data file natively.
    Returns None if the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    if mask_str is None:
        from ..config import masked_string

        mask_str = masked_string()
    d = _SvqData()
    rc = lib.svq_parse_file(
        name.encode(), mask_str.encode(), int(skip_empty), ctypes.byref(d)
    )
    if rc != 0:
        err = d.error.decode(errors="replace")
        lib.svq_free(ctypes.byref(d))
        raise ValueError(f"{name}: {err}")
    try:
        return _collect(d, labels)
    finally:
        lib.svq_free(ctypes.byref(d))


def parse_text_native(
    text: str,
    labels=None,
    skip_empty: bool = True,
    mask_str: Optional[str] = None,
):
    """Parse an in-memory buffer (e.g. a decompressed gzip stream)."""
    lib = _load()
    if lib is None:
        return None
    if mask_str is None:
        from ..config import masked_string

        mask_str = masked_string()
    d = _SvqData()
    raw = text.encode()
    buf = ctypes.create_string_buffer(raw)  # parser tokenizes in place
    rc = lib.svq_parse_buffer(
        ctypes.cast(buf, ctypes.c_char_p), len(raw), mask_str.encode(),
        int(skip_empty), ctypes.byref(d),
    )
    if rc != 0:
        err = d.error.decode(errors="replace")
        lib.svq_free(ctypes.byref(d))
        raise ValueError(err)
    try:
        return _collect(d, labels)
    finally:
        lib.svq_free(ctypes.byref(d))


def format_entries_native(ds, labels=None, mask_str: Optional[str] = None) -> Optional[str]:
    """Format a Dataset's entry lines natively (header/comments stay in
    Python).  Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    from .labels import GLOBAL_LABELS

    table = labels if labels is not None else GLOBAL_LABELS
    if mask_str is None:
        from ..config import masked_string

        mask_str = masked_string()

    n, dim = ds.n, ds.dim
    pts = np.ascontiguousarray(ds.points, dtype=np.float32)
    mask_p = None
    if ds.mask is not None:
        mask_arr = np.ascontiguousarray(ds.mask, dtype=np.uint8)
        mask_p = mask_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    labcnt_p = None
    labstr = b""
    if ds.labels is not None:
        counts = np.zeros(n, dtype=np.int32)
        parts: List[bytes] = []
        for i in range(n):
            for lab in ds.labels[i]:
                if lab == 0:
                    break
                parts.append((table.to_label(int(lab)) or "").encode())
                counts[i] += 1
        labstr = b"\0".join(parts) + (b"\0" if parts else b"")
        labcnt_p = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    out_len = ctypes.c_int64(0)
    p = lib.svq_format_entries(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask_p, labstr, labcnt_p, n, dim, mask_str.encode(),
        ctypes.byref(out_len),
    )
    try:
        return ctypes.string_at(p, out_len.value).decode()
    finally:
        lib.svq_free_text(p)

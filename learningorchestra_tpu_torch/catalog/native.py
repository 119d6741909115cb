"""ctypes binding to the native C++ CSV tokenizer (``native/csv_parser.cpp``).

The reference's native horsepower lived in the external Spark JVM
(SURVEY.md §2); this framework's native tier is first-party C++. The parser
tokenizes CSV bytes into whole-column buffers — numeric columns as
contiguous float64/int64, string columns in Arrow layout (int32 offsets +
UTF-8 data + validity bitmap) — which Python adopts in bulk: numerics as
numpy arrays, strings as ``pyarrow`` arrays built from the raw buffers.
No per-cell Python work happens anywhere on the ingest path, and ctypes
releases the GIL for the duration of each parse call, so block parsing
scales across threads (catalog/ingest.py's parse pool).

Falls back to pandas when the shared library has not been built
(``make -C native`` builds it; tests cover both paths).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional

import numpy as np

_LIB_NAMES = ("libcsv_parser.so",)
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _lib_path() -> Optional[str]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in _LIB_NAMES:
        for sub in ("native", "native/build"):
            p = os.path.join(root, sub, name)
            if os.path.isfile(p):
                return p
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = _lib_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.lo_csv_parse.restype = ctypes.c_void_p
        lib.lo_csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
        lib.lo_csv_ncols.restype = ctypes.c_int
        lib.lo_csv_ncols.argtypes = [ctypes.c_void_p]
        lib.lo_csv_nrows.restype = ctypes.c_long
        lib.lo_csv_nrows.argtypes = [ctypes.c_void_p]
        lib.lo_csv_col_name.restype = ctypes.c_char_p
        lib.lo_csv_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_col_kind.restype = ctypes.c_int
        lib.lo_csv_col_kind.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_col_f64.restype = ctypes.POINTER(ctypes.c_double)
        lib.lo_csv_col_f64.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_col_i64.restype = ctypes.POINTER(ctypes.c_int64)
        lib.lo_csv_col_i64.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_col_offsets.restype = ctypes.POINTER(ctypes.c_int32)
        lib.lo_csv_col_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_col_strdata.restype = ctypes.c_void_p
        lib.lo_csv_col_strdata.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_col_validity.restype = ctypes.c_void_p
        lib.lo_csv_col_validity.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lo_csv_free.restype = None
        lib.lo_csv_free.argtypes = [ctypes.c_void_p]
        # No argtypes: called with bytes (char*) or with a from_buffer
        # view over a bytearray (zero-copy splitter path).
        lib.lo_csv_record_split.restype = ctypes.c_long
        _lib = lib
    except (OSError, AttributeError):
        # AttributeError: a stale pre-rebuild .so missing the new symbols.
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def record_split(data: bytes) -> int:
    """Index of the last newline terminating a complete CSV record (even
    quote parity), -1 if none — native-speed core of the block splitter."""
    lib = _load()
    assert lib is not None, "native parser not built"
    return lib.lo_csv_record_split(data, ctypes.c_size_t(len(data)))


def record_split_buffer(buf: bytearray, n: int) -> int:
    """record_split over the first ``n`` bytes of a bytearray WITHOUT
    copying — the splitter scans its accumulation buffer in place (the
    windows are tens of MB; two memcpys per block were measurable)."""
    lib = _load()
    assert lib is not None, "native parser not built"
    view = (ctypes.c_char * n).from_buffer(buf)
    try:
        return lib.lo_csv_record_split(view, ctypes.c_size_t(n))
    finally:
        del view  # release the exported buffer so `del buf[:k]` can resize


class _ParseHandle:
    """Owner of a native parse result. The RecordBatch built over the
    handle's buffers holds this object as every buffer's base, so the C++
    Table is freed exactly when the last reference (batch, or a numpy view
    of one of its columns) dies."""

    __slots__ = ("_free", "_h")

    def __init__(self, lib, h):
        self._free = lib.lo_csv_free
        self._h = h

    def __del__(self):
        try:
            self._free(self._h)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _addr(ptr) -> int:
    return ctypes.cast(ptr, ctypes.c_void_p).value or 0


def parse_csv_block_arrow(data: bytes,
                          names: Optional[List[str]] = None):
    """Parse a CSV byte block into a ``pyarrow.RecordBatch`` ZERO-COPY:
    every column buffer (numeric values, string offsets/data/validity) is
    adopted in place from the C++ parse result via ``pa.foreign_buffer``,
    with the parse handle as owner. No per-cell work, no memcpy.

    With ``names``, the block is headerless (a resumed or split block) and
    columns take the given names positionally; otherwise the first record
    is the header. Empty cells are nulls in string columns and NaN in
    float columns; all-integral no-missing numeric columns come back
    int64 (pandas/reference inference, database.py:163-168).
    """
    import pyarrow as pa

    lib = _load()
    assert lib is not None, "native parser not built"
    # `names is not None`: an empty list still means "headerless" (the
    # caller is naming columns positionally, it just has none to name).
    # The names' count is passed as the expected width so a ragged FIRST
    # record can't shrink the block's schema — every record pads or
    # truncates to it, exactly as the header (or pandas names=) would.
    handle = lib.lo_csv_parse(data, len(data),
                              0 if names is not None else 1,
                              len(names) if names else 0)
    if not handle:
        raise ValueError("native CSV parse failed")
    owner = _ParseHandle(lib, handle)
    ncols = lib.lo_csv_ncols(handle)
    nrows = lib.lo_csv_nrows(handle)
    empty = pa.py_buffer(b"")
    arrays, out_names = [], []
    for c in range(ncols):
        if names is not None and c < len(names):
            name = names[c]
        else:
            name = lib.lo_csv_col_name(handle, c).decode("utf-8")
        kind = lib.lo_csv_col_kind(handle, c)
        if kind == 2:
            offs_ptr = lib.lo_csv_col_offsets(handle, c)
            total = int(np.ctypeslib.as_array(offs_ptr,
                                              shape=(nrows + 1,))[-1]) \
                if nrows else 0
            offs_buf = (pa.foreign_buffer(_addr(offs_ptr), 4 * (nrows + 1),
                                          base=owner) if nrows else empty)
            data_addr = lib.lo_csv_col_strdata(handle, c)
            data_buf = (pa.foreign_buffer(data_addr, total, base=owner)
                        if total else empty)
            valid_buf = (pa.foreign_buffer(
                _addr(lib.lo_csv_col_validity(handle, c)),
                (nrows + 7) // 8, base=owner) if nrows else empty)
            arr = pa.Array.from_buffers(
                pa.utf8(), nrows, [valid_buf, offs_buf, data_buf])
        else:
            ptr = (lib.lo_csv_col_i64(handle, c) if kind == 1
                   else lib.lo_csv_col_f64(handle, c))
            buf = (pa.foreign_buffer(_addr(ptr), 8 * nrows, base=owner)
                   if nrows else empty)
            arr = pa.Array.from_buffers(
                pa.int64() if kind == 1 else pa.float64(), nrows,
                [None, buf])
        arrays.append(arr)
        out_names.append(name)
    return pa.RecordBatch.from_arrays(arrays, names=out_names)


def parse_csv_bytes(data: bytes, has_header: bool = True) -> dict:
    """Parse a complete CSV byte buffer into {name: np.ndarray} (numeric
    dtypes or object-with-None strings — the catalog's column domain)."""
    batch = parse_csv_block_arrow(data, names=None if has_header else [])
    out = {}
    for name, col in zip(batch.schema.names, batch.columns):
        out[name] = col.to_numpy(zero_copy_only=False)
    return out


def _record_split_py(buf, n: Optional[int] = None) -> int:
    """Python fallback for record_split over ``buf[:n]`` using C-speed
    primitives with explicit bounds (no copies — the window is tens of
    MB): try the rightmost newlines and verify even quote parity via
    count()."""
    if n is None:
        n = len(buf)
    if buf.find(b'"', 0, n) < 0:
        return buf.rfind(b"\n", 0, n)
    end = n
    while True:
        cut = buf.rfind(b"\n", 0, end)
        if cut < 0:
            return -1
        if buf.count(b'"', 0, cut) % 2 == 0:
            return cut
        end = cut


def parse_csv_chunks(fileobj, chunk_rows: int) -> Iterator[dict]:
    """Chunked parse over a stream: reads record-aligned byte blocks and
    feeds them to the native parser, re-attaching the header to every block."""
    header = fileobj.readline()
    if not header:
        return
    approx_row = max(len(header), 32)
    # Honor small configured chunk sizes (out-of-core tests/budgeted ingest
    # rely on chunk granularity); the default 65536-row config still reads
    # >=2 MiB blocks per native call.
    target = max(chunk_rows * approx_row, 1 << 12)
    carry = b""
    while True:
        block = fileobj.read(target)
        if not block:
            if carry.strip():
                yield parse_csv_bytes(header + carry)
            return
        block = carry + block
        cut = record_split(block)
        if cut < 0:
            carry = block
            continue
        carry = block[cut + 1:]
        chunk = block[:cut + 1]
        if chunk.strip():
            yield parse_csv_bytes(header + chunk)

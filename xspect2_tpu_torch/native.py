"""ctypes bindings for the repository's native host library (ABI 3).

The library (``native/build/libxspect.so``, built by ``make -C native``)
parses FASTA/FASTQ files into code arrays, inserts k-mers into an index
with several threads and 2-bit-packs read matrices for the device
wire.  It is host code shared by both packages; this module is the
port's own copy of the bindings it needs.  Every entry point has a
numpy fallback, used when the library is missing; the fallbacks stand
in for the host library only, never for the device.
"""

import ctypes
import fcntl
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libxspect.so"

# the library reports its generation via xs_abi_version(); a stale .so
# called with these argtypes would corrupt indices silently
ABI_VERSION = 3

_lib = None
_build_attempted = False


def _try_open(path: Path):
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    try:
        lib.xs_abi_version.restype = ctypes.c_int
        version = lib.xs_abi_version()
    except AttributeError:
        version = -1  # predates the handshake
    if version != ABI_VERSION:
        logging.getLogger(__name__).warning(
            "ignoring stale native library %s (abi %d, need %d): "
            "rebuild with `make -C native`",
            path,
            version,
            ABI_VERSION,
        )
        return None
    _configure(lib)
    return lib


def _build():
    """One ``make -C native`` per process, serialized across processes."""
    global _build_attempted
    _build_attempted = True
    if not (_NATIVE_DIR / "Makefile").exists():
        return
    build_dir = _NATIVE_DIR / "build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _try_open(_LIB_PATH) is None:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                capture_output=True,
                timeout=300,
                check=False,
            )


def _load():
    """The library, built on first use; None when it cannot be built."""
    global _lib
    if _lib is None and not _LIB_PATH.exists() and not _build_attempted:
        _build()
    if _lib is None and _LIB_PATH.exists():
        _lib = _try_open(_LIB_PATH)
    return _lib


def _configure(lib):
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.xs_scan_file.argtypes = [
        ctypes.c_char_p, i32,
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.xs_scan_file.restype = i32

    lib.xs_parse_file.argtypes = [ctypes.c_char_p, i32, u8p, i64p, ctypes.c_char_p]
    lib.xs_parse_file.restype = i64

    lib.xs_insert_kmers.argtypes = [
        u32p, i64, i32, i32, i32, i32, i32, u8p, i64, i32, i32,
    ]
    lib.xs_insert_kmers.restype = None

    lib.xs_pack_2bit.argtypes = [u8p, i64, i64, u8p, u8p, i32]
    lib.xs_pack_2bit.restype = None


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------- parsing


def _parse_file_numpy(path: Path):
    from xspect2_tpu_torch.core import dna
    from xspect2_tpu_torch.io.fasta import get_record_iterator

    ids, parts = [], []
    for rec in get_record_iterator(Path(path)):
        ids.append(rec.id)
        parts.append(dna.encode(rec.seq))
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return codes, offsets, ids


def parse_file(path: Path):
    """Parse a FASTA/FASTQ file into ``(codes, offsets, ids)``.

    ``codes`` are the concatenated uint8 codes, ``offsets`` the int64
    record offsets (len = n_records + 1), ``ids`` the record ids.
    """
    lib = _load()
    if lib is None:
        return _parse_file_numpy(path)
    from xspect2_tpu_torch.definitions import fastq_endings

    is_fastq = 1 if Path(path).suffix[1:] in fastq_endings else 0
    total_bases = ctypes.c_int64()
    num_records = ctypes.c_int64()
    id_bytes = ctypes.c_int64()
    rc = lib.xs_scan_file(
        str(path).encode(), is_fastq,
        ctypes.byref(total_bases), ctypes.byref(num_records), ctypes.byref(id_bytes),
    )
    if rc != 0:
        raise ValueError(f"cannot open {path}")

    codes = np.empty(total_bases.value, dtype=np.uint8)
    offsets = np.empty(num_records.value + 1, dtype=np.int64)
    ids_buf = ctypes.create_string_buffer(id_bytes.value + 1)
    nrec = lib.xs_parse_file(str(path).encode(), is_fastq, codes, offsets, ids_buf)
    if nrec < 0:
        raise ValueError(f"cannot parse {path}")
    ids = ids_buf.raw[: id_bytes.value].decode("utf-8", "replace").split("\0")[:nrec]
    return codes, offsets[: nrec + 1], ids


# ---------------------------------------------------------------- index build


def insert_kmers(index, class_idx: int, codes: np.ndarray, num_threads: int = 0):
    """Insert all canonical k-mers of ``codes`` into one class of the index."""
    lib = _load()
    if lib is None:
        from xspect2_tpu_torch.core import dna

        hi, lo, valid = dna.canonical_kmers(codes, index.k)
        index.insert_kmers(class_idx, hi, lo, valid)
        return
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    lib.xs_insert_kmers(
        index.table,
        index.num_blocks,
        index.rows_per_block,
        index.class_words,
        index.num_hashes,
        index.fields_per_word,
        class_idx,
        np.ascontiguousarray(codes, dtype=np.uint8),
        len(codes),
        index.k,
        num_threads,
    )


# ---------------------------------------------------------------- wire pack


def pack_2bit(reads: np.ndarray, num_threads: int = 0):
    """2-bit-pack an [n, len] uint8 code matrix for the device wire.

    Returns ``(packed [n, ceil(len/4)] uint8, bad_flags [n] uint8)``:
    base b sits at bits ``2*(b%4)`` of byte ``b//4``.  Invalid codes
    (>3) pack as 0 and flag their read; callers ship a patch list of
    invalid positions next to the packed payload (ops/query.py).
    """
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    n, length = reads.shape
    l4 = -(-length // 4)
    lib = _load()
    if lib is None:
        lp = l4 * 4
        codes = np.zeros((n, lp), dtype=np.uint8)
        codes[:, :length] = np.where(reads > 3, np.uint8(0), reads)
        packed = codes.reshape(n, l4, 4) << np.array(
            [0, 2, 4, 6], dtype=np.uint8
        )
        packed = np.bitwise_or.reduce(packed, axis=2)
        bad = (reads > 3).any(axis=1).astype(np.uint8)
        return packed, bad
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    packed = np.empty((n, l4), dtype=np.uint8)
    bad = np.empty(n, dtype=np.uint8)
    lib.xs_pack_2bit(reads, n, length, packed, bad, num_threads)
    return packed, bad

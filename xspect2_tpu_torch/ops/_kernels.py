"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface under
``build/torch_kernels/`` at the repository root (``build/`` is in
``.gitignore``), and loads with ``ctypes``.  The build happens at first
use, under a file lock, so concurrent processes build once; a library
is named by the hash of its source and of every ``csrc/`` header it
includes, so an edited source or header builds anew.  Nothing here
runs at import time.  A round of ``nvcc`` runs is the phase
``kernels.build`` of :mod:`xspect2_tpu_torch.profiling`.
"""

import ctypes
import fcntl
import hashlib
import re
import shutil
import subprocess
import time
from contextlib import nullcontext
from pathlib import Path

from xspect2_tpu_torch import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64

# C entry point and argtypes of each kernel library: every pointer and
# the stream as c_void_p, so ctypes never truncates them to 32 bits
SIGNATURES = {
    "unpack_2bit": ("xs_unpack_2bit", [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i64, _i32, _vp]),
    "reads_query": (
        "xs_reads_query",
        [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i64, _i32, _i32, _i32, _i32, _i32,
         _i64, _i32, _i64, _i64, _vp],
    ),
    "records_wire": (
        "xs_records_wire",
        [_vp, _i64, _vp, _i64, _i32, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp],
    ),
    "records_query": (
        "xs_records_query",
        [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i64, _i32, _i32, _i32, _i32, _i32, _i32,
         _i64, _i32, _i64, _i64, _vp],
    ),
    # tables, outs and the geometry rows are host arrays (ctypes arrays)
    "multi_records_query": (
        "xs_multi_records_query",
        [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp, _vp, _vp, _vp],
    ),
    "segment_reduce": (
        "xs_segment_reduce",
        [_vp, _vp, _vp, _i32, _vp, _i32, _i32, _i32, _i32, _i32, _vp],
    ),
    "bloom_count": ("xs_bloom_count", [_vp, _vp, _vp, _vp, _i64, _i32, _i64, _vp]),
    "xxh3_bloom": (
        "xs_xxh3_records_count",
        [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i64, _i32, _i32, _i64, _i32, _vp],
    ),
    "probe_select": ("xs_probe_select", [_vp, _vp, _vp, _i64, _i32, _i32, _vp]),
    "row_gather": ("xs_row_gather", [_vp, _vp, _vp, _i64, _i64, _i32, _i32, _i64, _i64, _vp]),
    "body_variants": (
        "xs_body_variants",
        [_vp, _vp, _vp, _i64, _i32, _i32, _i64, _i32, _i32, _i32, _i32, _i64, _i32, _vp],
    ),
    # the launch plan (a host struct, csrc/svm_head.cu:Plan) by pointer
    "svm_head": ("xs_svm_head", [_vp, _i32, _vp, _i64, _i32, _i64, _vp, _vp, _vp]),
}
# further C entry points of a kernel library: name -> (library, symbol, argtypes)
EXTRA_ENTRIES = {
    # the launch xs_body_variants makes at a read length (7 ints out)
    "body_variants_config": ("body_variants", "xs_body_variants_config", [_i32, _i32, _i32, _vp]),
    # the current device's opt-in shared memory a block (one int out); allows
    # K11's kernels that much there
    "svm_head_optin": ("svm_head", "xs_svm_head_optin", [_vp]),
    # an empty kernel on K11's block of one row, the launch floor
    "svm_head_empty": ("svm_head", "xs_svm_head_empty", [_vp]),
}
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict = {}  # kernel name -> configured ctypes entry point


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources(name: str) -> list[Path]:
    """``<name>.cu`` and every header it includes from ``csrc/``, transitively."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text(encoding="utf-8"))]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all by default), one ``nvcc`` each, in parallel.

    Returns each kernel's compiler output (``-Xptxas -v``: registers,
    shared memory, spills); raises ``RuntimeError`` when one fails.
    """
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                logs[name] = "(cached)"
                continue
            tmp = out.with_suffix(f".tmp{time.monotonic_ns()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                out,
            )
        failed = []
        with profiling.phase("kernels.build") if procs else nullcontext():
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                logs[name] = log
                if proc.returncode == 0:
                    tmp.replace(out)
                else:
                    failed.append(f"{name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def entry(name: str):
    """The C entry point of kernel ``name`` (or of :data:`EXTRA_ENTRIES`),
    its library built and loaded on first use."""
    fn = _loaded.get(name)
    if fn is None:
        if name in EXTRA_ENTRIES:
            library, symbol, argtypes = EXTRA_ENTRIES[name]
        else:
            library, (symbol, argtypes) = name, SIGNATURES[name]
        path = library_path(library)
        if not path.exists():
            build([library])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise when a kernel's C entry returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")

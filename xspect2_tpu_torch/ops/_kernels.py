"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface under
``build/torch_kernels/`` at the repository root (``build/`` is in
``.gitignore``), and loads with ``ctypes``.  The build happens at first
use, under a file lock, so concurrent processes build once; a library
is named by the hash of its source, so an edited source builds anew.
Nothing here runs at import time.
"""

import ctypes
import fcntl
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

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
    "unpack_2bit": ("xs_unpack_2bit", [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i64, _vp]),
    "reads_query": (
        "xs_reads_query",
        [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i64, _i32, _i32, _i32, _i32, _i32,
         _i64, _i32, _vp],
    ),
}

_loaded: dict = {}  # kernel name -> configured ctypes entry point


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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
    """The C entry point of kernel ``name``, built and loaded on first use."""
    fn = _loaded.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise when a kernel's C entry returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")

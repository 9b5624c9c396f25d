"""Process-wide LRU cache of loaded models.

A loaded model owns an index table resident on its device, so the
classification facades reuse it instead of reloading it per call.  An
entry is keyed on (model class, metadata path, device) and checked
against the metadata file's mtime: rewriting ``<slug>.json`` invalidates
it.  ``XSPECT_MODEL_CACHE``, read at every call as the JAX package reads
it, bounds the models kept loaded (default :data:`CAPACITY`, and a value
that is not a number means the default); 0 or less loads without
caching.  The oldest untouched entry goes first, and its device table is
freed with the model.  Each load from disk is the phase ``model.load`` of
:mod:`xspect2_tpu_torch.profiling`: its calls count the cache's misses.
"""

import os
import threading
from collections import OrderedDict
from pathlib import Path

import torch

from xspect2_tpu_torch import profiling

CAPACITY = 3

_LOCK = threading.Lock()
_CACHE: "OrderedDict[tuple[str, str, str], tuple[int, object]]" = OrderedDict()


def _capacity() -> int:
    try:
        return int(os.environ.get("XSPECT_MODEL_CACHE", str(CAPACITY)))
    except ValueError:
        return CAPACITY


def load_cached(model_class, path: Path, device: torch.device):
    """``model_class.load(path, device)`` memoized on (class, path, device, mtime)."""
    path = Path(path)
    cap = _capacity()
    if cap <= 0:
        with profiling.phase("model.load"):
            return model_class.load(path, device=device)
    key = (model_class.__name__, str(path), str(device))
    stamp = path.stat().st_mtime_ns
    with _LOCK:
        entry = _CACHE.get(key)
        if entry is not None and entry[0] == stamp:
            _CACHE.move_to_end(key)
            return entry[1]
    with profiling.phase("model.load"):
        model = model_class.load(path, device=device)
    with _LOCK:
        _CACHE[key] = (stamp, model)
        _CACHE.move_to_end(key)
        while len(_CACHE) > cap:
            _CACHE.popitem(last=False)
    return model


def clear() -> None:
    """Drop every cached model."""
    with _LOCK:
        _CACHE.clear()

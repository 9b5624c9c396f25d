"""Process-wide LRU cache of loaded models.

A loaded model owns an index table resident on its device, so the
classification facades reuse it instead of reloading it per call.  An
entry is keyed on (model class, metadata path, device) and checked
against the metadata file's mtime: rewriting ``<slug>.json`` invalidates
it.  At most :data:`CAPACITY` models stay loaded; the oldest untouched
entry goes first, and its device table is freed with the model.
"""

import threading
from collections import OrderedDict
from pathlib import Path

import torch

CAPACITY = 3

_LOCK = threading.Lock()
_CACHE: "OrderedDict[tuple[str, str, str], tuple[int, object]]" = OrderedDict()


def load_cached(model_class, path: Path, device: torch.device):
    """``model_class.load(path, device)`` memoized on (class, path, device, mtime)."""
    path = Path(path)
    key = (model_class.__name__, str(path), str(device))
    stamp = path.stat().st_mtime_ns
    with _LOCK:
        entry = _CACHE.get(key)
        if entry is not None and entry[0] == stamp:
            _CACHE.move_to_end(key)
            return entry[1]
    model = model_class.load(path, device=device)
    with _LOCK:
        _CACHE[key] = (stamp, model)
        _CACHE.move_to_end(key)
        while len(_CACHE) > CAPACITY:
            _CACHE.popitem(last=False)
    return model


def clear() -> None:
    """Drop every cached model."""
    with _LOCK:
        _CACHE.clear()

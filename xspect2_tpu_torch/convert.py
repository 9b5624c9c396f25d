"""Carry a JAX package's index and SVM head across as numpy arrays.

The two packages share their on-disk formats, so a saved model loads in
either.  These functions take the in-memory state instead: an index's
``meta_dict()`` and ``table``, and the fields of a fitted SVM head.
"""

import numpy as np

from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.models.svm_head import SVMHead


def index_from_arrays(meta: dict, table: np.ndarray) -> BlockedBitSlicedIndex:
    """The port's index from ``BlockedBitSlicedIndex.meta_dict()`` and ``.table``."""
    return BlockedBitSlicedIndex.from_meta(meta, np.array(table, dtype=np.uint32))


def svm_head_from_arrays(
    support_vectors,
    dual_coef,
    intercept,
    n_support,
    classes,
    kernel: str,
    gamma: float,
    degree: int = 3,
    coef0: float = 0.0,
) -> SVMHead:
    """An :class:`SVMHead` from the fields of a fitted one-vs-one SVC head."""
    return SVMHead(
        support_vectors, dual_coef, intercept, n_support, classes,
        kernel, gamma, degree, coef0,
    )

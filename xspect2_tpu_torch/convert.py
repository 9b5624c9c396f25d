"""Carry a JAX package's index, its table shards, filter, MLST model and
SVM head across as numpy arrays.

The two packages share their on-disk formats, so a saved model loads in
either.  These functions take the in-memory state instead: an index's
``meta_dict()`` and ``table``, a compat filter's geometry and words, an
MLST model's metadata and per-locus indices, and the fields of a fitted
SVM head.
"""

from pathlib import Path

import numpy as np
import torch

from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.core.compat import XXH3BloomFilter
from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel
from xspect2_tpu_torch.models.svm_head import SVMHead
from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard
from xspect2_tpu_torch.parallel.sharded import cls_table_shard


def index_from_arrays(meta: dict, table: np.ndarray) -> BlockedBitSlicedIndex:
    """The port's index from ``BlockedBitSlicedIndex.meta_dict()`` and ``.table``."""
    return BlockedBitSlicedIndex.from_meta(meta, np.array(table, dtype=np.uint32))


def table_shards(meta: dict, table: np.ndarray, axis: str, n_shards: int) -> list[torch.Tensor]:
    """The ``n_shards`` table shards of an index along the ``"cls"`` or
    ``"blk"`` mesh axis, in coordinate order, as the int32 tensors (uint32
    bits) the sharded classifiers query, slices of the row-major table:
    [num_blocks, rows * cw_local] for ``cls``, [local_blocks, rows *
    class_words] for ``blk``."""
    if axis not in ("cls", "blk"):
        raise ValueError(f"unknown mesh axis {axis!r}: expected 'cls' or 'blk'")
    index = index_from_arrays(meta, table)
    cut = cls_table_shard if axis == "cls" else blk_table_shard
    return [torch.from_numpy(cut(index, n_shards, c).view(np.int32)) for c in range(n_shards)]


def bloom_filter_from_arrays(meta: dict, words: np.ndarray, device=None) -> XXH3BloomFilter:
    """The port's compat filter from ``{num_bits, num_hashes, k}`` and the
    uint32 ``words`` of a JAX-package ``XXH3BloomFilter``."""
    filt = XXH3BloomFilter(meta["num_bits"], meta["num_hashes"], meta["k"], device)
    words = np.array(words, dtype=np.uint32)
    if words.shape != filt.words.shape:
        raise ValueError(f"{meta['num_bits']} bits need {filt.words.size} words, not {words.size}")
    filt.words = words
    return filt


def mlst_model_from_arrays(
    meta: dict, indices, base_path: Path, device=None
) -> ProbabilisticFilterMlstSchemeModel:
    """The port's MLST model from a JAX-package model's ``to_dict()`` and
    its per-locus ``(meta_dict(), table)`` pairs, in locus order."""
    model = ProbabilisticFilterMlstSchemeModel(
        meta["k"], meta["model_display_name"], base_path, meta["scheme_url"],
        meta["organism"], meta["fpr"], meta["num_hashes"], meta.get("author"),
        meta.get("author_email"), meta.get("model_type"), device=device,
    )
    model.loci = dict(meta["loci"])
    model.avg_locus_bp_size = list(meta["average_locus_base_pair_size"])
    model.indices = [index_from_arrays(m, table) for m, table in indices]
    if len(model.indices) != len(model.loci):
        raise ValueError("one index per locus is needed")
    return model


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

"""Hash-space (block-axis) index sharding.

The index table is a stack of ``num_blocks`` signature blocks addressed
by ``hash % num_blocks``; this classifier shards that stack over the
``blk`` mesh axis so each rank holds a contiguous window of blocks.
Reads stay data-sharded (every block shard of a data shard sees the
same reads); every block shard looks at all k-mers of its data shard
and its query kernels count only those whose block it owns (the
owned-block mode of ``reads_query`` and ``records_query``: one unsigned
compare before any table read), and an ``all_reduce`` over ``blk``
reassembles exact hit counts.

Unlike the ``cls`` axis it splits ANY geometry, including field-packed
(<= 16 class) and single-class genus tables, which have no class-word
axis.  The counterpart of the JAX package's
``xspect2_tpu/parallel/block_sharded.py``.
"""

import math

import numpy as np
import torch

from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.parallel.mesh import BLK_AXIS
from xspect2_tpu_torch.parallel.sharded import ShardedClassifier


def blk_table_shard(index: BlockedBitSlicedIndex, n_blk: int, coord: int) -> np.ndarray:
    """The block shard ``coord`` of ``n_blk`` of the index's table: uint32
    [local_blocks, rows_per_block * class_words], the blocks
    ``[coord * local_blocks, (coord + 1) * local_blocks)`` of the
    row-major table.  The block stack is padded to a multiple of
    ``n_blk``; padding blocks sit past ``hash % num_blocks`` and are
    never addressed."""
    blocks = index.num_blocks
    local_blocks = math.ceil(blocks / n_blk)
    b0 = coord * local_blocks
    t2 = index.table.reshape(blocks, index.rows_per_block * index.class_words)
    out = np.zeros((local_blocks, t2.shape[1]), dtype=np.uint32)
    b1 = min(blocks, b0 + local_blocks)
    if b1 > b0:
        out[: b1 - b0] = t2[b0:b1]
    return out


class BlockShardedClassifier(ShardedClassifier):
    """Classification step over a (data, blk) mesh.

    Shares the host-side batching, the per-rank steps and the result
    assembly of :class:`ShardedClassifier`; only the table shards, their
    geometry and the model-axis collective differ (a block window and a
    sum instead of class-word columns and a concatenation).
    """

    model_axis = BLK_AXIS

    def _plan_shards(self) -> None:
        self.n_blk = self.n_model
        # pad the block stack to a multiple of the blk axis
        self.blocks_pad = math.ceil(self.index.num_blocks / self.n_blk) * self.n_blk
        self.local_blocks = self.blocks_pad // self.n_blk

    def host_table_shard(self, coord: int) -> np.ndarray:
        return blk_table_shard(self.index, self.n_blk, coord)

    def shard_geometry(self, coord: int) -> dict:
        idx = self.index
        return dict(
            k=idx.k,
            num_blocks=int(idx.num_blocks),
            rows_per_block=idx.rows_per_block,
            class_words=idx.class_words,
            num_hashes=idx.num_hashes,
            fields_per_word=idx.fields_per_word,
            num_classes=idx.num_classes,
            local_blocks=self.local_blocks,
            block_offset=coord * self.local_blocks,
        )

    def _merge_model(self, hits_local: torch.Tensor) -> torch.Tensor:
        """Complete the counts across the block shards (all_reduce)."""
        return self.mesh.all_reduce(hits_local, BLK_AXIS)

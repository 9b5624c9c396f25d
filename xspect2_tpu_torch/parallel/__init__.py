"""Multi-device scale-out: process mesh, sharded classification step.

One process drives one device, and ``torch.distributed`` joins them
(NCCL between CUDA devices, gloo on the CPU):

- **data axis**: read batches sharded across ranks,
- **cls axis**: the index bit-matrix sharded by class word-columns
  (each rank holds ``class_words / n_cls`` 32-class word columns),
- **blk axis**: the index sharded by signature blocks (hash space):
  arbitrary granularity for any geometry (block_sharded.py),
- per-shard hit partials merged with ``all_gather`` (per-record vectors)
  and ``all_reduce`` (file-level totals, block partials) before SVM
  scoring.
"""

from xspect2_tpu_torch.parallel.block_sharded import BlockShardedClassifier
from xspect2_tpu_torch.parallel.mesh import make_block_mesh, make_mesh
from xspect2_tpu_torch.parallel.sharded import ShardedClassifier

__all__ = [
    "BlockShardedClassifier",
    "ShardedClassifier",
    "make_block_mesh",
    "make_mesh",
]

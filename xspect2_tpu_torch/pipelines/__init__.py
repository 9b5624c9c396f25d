"""Pipelines: the assembly and read benchmarks, pangenome training and
the SVM grid search, as plain Python loops over the port's entry points
(the JAX package's ``xspect2_tpu.pipelines``).  Each takes ``device``
(``None`` means CUDA; see :func:`xspect2_tpu_torch.resolve_device`).
"""

from xspect2_tpu_torch.pipelines.benchmark import (
    evaluate_assembly_classifications,
    evaluate_read_classifications,
    run_assembly_benchmark,
    run_read_benchmark,
)
from xspect2_tpu_torch.pipelines.pangenome import train_pangenome
from xspect2_tpu_torch.pipelines.score_svm import grid_search_svm

__all__ = [
    "run_assembly_benchmark",
    "run_read_benchmark",
    "evaluate_assembly_classifications",
    "evaluate_read_classifications",
    "train_pangenome",
    "grid_search_svm",
]

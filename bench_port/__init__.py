"""The benchmark of the PyTorch/CUDA port ``xspect2_tpu_torch``: see ``run.py``."""

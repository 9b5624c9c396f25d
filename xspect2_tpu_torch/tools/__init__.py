"""Measurement tools of the port, run as ``python -m xspect2_tpu_torch.tools.<name>``."""

"""Constants and data-directory layout.

Same layout as the JAX package: everything lives under
``~/xspect-data`` (or ``./xspect-data`` if that already exists), models
under ``models/``.  ``XSPECT_DATA_ROOT`` overrides the root, so both
packages read one model registry.
"""

import os
import re
from pathlib import Path

fasta_endings = ["fasta", "fna", "fa", "ffn", "frn"]
fastq_endings = ["fastq", "fq"]


def slugify(text: str) -> str:
    """Lowercase, replace runs of non-alphanumerics with "-", strip dashes."""
    text = text.lower()
    text = re.sub(r"[^a-z0-9]+", "-", text)
    return text.strip("-")


def get_xspect_root_path() -> Path:
    """Return the root path for XspecT data."""
    env_root = os.environ.get("XSPECT_DATA_ROOT")
    if env_root:
        root = Path(env_root)
        root.mkdir(exist_ok=True, parents=True)
        return root

    home_based_dir = Path.home() / "xspect-data"
    if home_based_dir.exists():
        return home_based_dir

    cwd_based_dir = Path(os.getcwd()) / "xspect-data"
    if cwd_based_dir.exists():
        return cwd_based_dir

    home_based_dir.mkdir(exist_ok=True, parents=True)
    return home_based_dir


def get_xspect_model_path() -> Path:
    """Return the path to the XspecT models directory."""
    path = get_xspect_root_path() / "models"
    path.mkdir(exist_ok=True, parents=True)
    return path

"""Model registry paths and metadata, as the JAX package lays them out.

A trained model is a ``<slug>.json`` metadata document plus a
``<slug>/`` directory of binary index artifacts under the models root
(:func:`definitions.get_xspect_model_path`).
"""

from json import loads
from pathlib import Path

from xspect2_tpu_torch.definitions import get_xspect_model_path, slugify


def metadata_path(slug: str) -> Path:
    # always slugify before joining, so "../"-style input cannot escape
    # the registry
    return get_xspect_model_path() / f"{slugify(slug)}.json"


def get_genus_model_path(genus: str) -> Path:
    return metadata_path(f"{genus}-genus")


def get_species_model_path(genus: str) -> Path:
    return metadata_path(f"{genus}-species")


def get_model_metadata(model: str | Path) -> dict:
    """Load a metadata document by slug or by direct file path."""
    target = model if isinstance(model, Path) else metadata_path(model)
    if not target.is_file():
        raise ValueError(f"Model at {target} does not exist.")
    return loads(target.read_text(encoding="utf-8"))


def is_svm_model(model_slug: str) -> bool:
    doc = get_model_metadata(model_slug)
    return doc.get("model_class") == "ProbabilisticFilterSVMModel"

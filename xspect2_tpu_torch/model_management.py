"""Model registry: discovery, metadata access, and path conventions.

The port's own copy of ``xspect2_tpu/model_management.py``.  A trained
model is a ``<slug>.json`` metadata document plus a ``<slug>/``
directory of binary index artifacts under the models root
(:func:`definitions.get_xspect_model_path`).  :class:`ModelRegistry`
owns the slug/path conventions and every metadata read and write; the
module functions are thin wrappers over one registry.
"""

from json import dumps, loads
from pathlib import Path
from typing import Iterator

from xspect2_tpu_torch.definitions import get_xspect_model_path, slugify


class ModelRegistry:
    """All registry operations over one models root directory.

    The root is resolved on every access, so ``XSPECT_DATA_ROOT`` can
    repoint the registry mid-process.
    """

    def __init__(self, root: Path | None = None):
        self._fixed_root = Path(root) if root is not None else None

    @property
    def root(self) -> Path:
        return self._fixed_root or get_xspect_model_path()

    # -------------------------------------------------- path conventions

    def metadata_path(self, slug: str) -> Path:
        # always slugify before joining, so "../"-style input cannot
        # escape the registry
        return self.root / f"{slugify(slug)}.json"

    def genus_path(self, genus: str) -> Path:
        return self.metadata_path(f"{genus}-genus")

    def species_path(self, genus: str) -> Path:
        return self.metadata_path(f"{genus}-species")

    def mlst_path(self, organism: str, scheme: str) -> Path:
        return self.metadata_path(f"{organism}-{scheme}-mlst")

    # -------------------------------------------------- metadata access

    def read_metadata(self, ref: str | Path) -> dict:
        """Load a metadata document by slug or by direct file path."""
        match ref:
            case Path():
                target = ref
            case str():
                target = self.metadata_path(ref)
            case _:
                raise ValueError("Model must be a string (slug) or a Path object.")
        if not target.is_file():
            raise ValueError(f"Model at {target} does not exist.")
        return loads(target.read_text(encoding="utf-8"))

    def amend_metadata(self, slug: str, **changes) -> dict:
        """Read-modify-write top-level metadata fields; returns the doc."""
        doc = self.read_metadata(slug)
        doc.update(changes)
        self.metadata_path(slug).write_text(dumps(doc, indent=4), encoding="utf-8")
        return doc

    def rename_filter(self, slug: str, filter_id: str, display_name: str) -> None:
        doc = self.read_metadata(slug)
        doc["display_names"][filter_id] = display_name
        self.metadata_path(slug).write_text(dumps(doc, indent=4), encoding="utf-8")

    # -------------------------------------------------- discovery

    def documents(self, pattern: str = "*.json") -> Iterator[dict]:
        for path in self.root.glob(pattern):
            yield self.read_metadata(path)

    def grouped(self, group_key: str, value_key: str, pattern: str = "*.json") -> dict[str, list[str]]:
        """Group one metadata field by another across matching documents.

        Documents missing either field are skipped (a partial registry
        from an interrupted import must not break listing).
        """
        groups: dict[str, list[str]] = {}
        for doc in self.documents(pattern):
            group, value = doc.get(group_key), doc.get(value_key)
            if group is None or value is None:
                continue
            groups.setdefault(group, []).append(value)
        return groups


_REGISTRY = ModelRegistry()


def metadata_path(slug: str) -> Path:
    return _REGISTRY.metadata_path(slug)


def get_genus_model_path(genus: str) -> Path:
    return _REGISTRY.genus_path(genus)


def get_species_model_path(genus: str) -> Path:
    return _REGISTRY.species_path(genus)


def get_mlst_model_path(organism: str, scheme: str) -> Path:
    return _REGISTRY.mlst_path(organism, scheme)


def get_model_metadata(model: str | Path) -> dict:
    return _REGISTRY.read_metadata(model)


def is_svm_model(model_slug: str) -> bool:
    doc = _REGISTRY.read_metadata(model_slug)
    return doc.get("model_class") == "ProbabilisticFilterSVMModel"


def update_model_metadata(model_slug: str, author: str, author_email: str) -> None:
    _REGISTRY.amend_metadata(model_slug, author=author, author_email=author_email)


def update_model_display_name(model_slug: str, filter_id: str, display_name: str) -> None:
    _REGISTRY.rename_filter(model_slug, filter_id, display_name)


def get_models() -> dict[str, list[str]]:
    """All available models: ``{model_type: [display names]}``."""
    return _REGISTRY.grouped("model_type", "model_display_name")


def get_model_display_names(model_slug: str) -> list[str]:
    return list(_REGISTRY.read_metadata(model_slug)["display_names"].values())


def get_available_mlst_schemes() -> dict[str, list[str]]:
    """Available MLST schemes: ``{organism: [scheme names]}``."""
    return _REGISTRY.grouped("organism", "model_display_name", pattern="*-mlst.json")

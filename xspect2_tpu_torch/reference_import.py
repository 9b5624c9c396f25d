"""Import models from a reference-XspecT bundle.

The port's own copy of ``xspect2_tpu/reference_import.py``.  The
reference XspecT project ships pre-trained models as a zip of
``<slug>.json`` metadata files plus per-model directories holding
COBS/rbloom binary indices and ``scores.csv``.  The binary indices are
hash-scheme-specific to the reference's native libraries and cannot be
consumed bit-level by the blocked bit-sliced index; what CAN be carried
over losslessly is everything the binaries were built FROM:

- the metadata (model class, k, fpr, display names, authorship: the
  reference and this package share the JSON schema),
- the training provenance (``training_accessions``/``svm_accessions``
  for NCBI assemblies, ``organism``+scheme for PubMLST alleles),
- ``scores.csv`` (plain CSV consumed by the SVM head).

So importing = translate metadata + **rebuild each index from its
recorded provenance** (NCBI downloads for species/genus models, PubMLST
allele downloads for MLST schemes).  The result is a fully functional
package-native model with the same classes, display names, and
statistical contract (same k, fpr) as the reference original.

Models whose provenance cannot be fetched (no network, no recorded
accessions) import in a degraded ``metadata-only`` state with a clear
status so the user knows to retrain.  Rebuilt models are fitted on
``device`` (``None`` means CUDA); the handlers are imported inside the
rebuilders.
"""

import json
import logging
import re
import shutil
from pathlib import Path
from tempfile import TemporaryDirectory

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.definitions import get_xspect_model_path
from xspect2_tpu_torch.file_io import (
    concatenate_metagenome,
    concatenate_species_fasta_files,
    extract_zip,
    get_ncbi_dataset_accession_paths,
)

logger = logging.getLogger("xspect2_tpu_torch.reference_import")


def _safe_slug(name, fallback: str = "imported-model") -> str:
    """Reduce an untrusted bundle name to a filesystem-safe slug.

    Bundle metadata is attacker-controlled (any zip can be imported);
    slugs and display names must never escape the model registry via
    path separators or ``..`` components.
    """
    name = re.sub(r"[^A-Za-z0-9._-]+", "-", str(name or ""))
    name = re.sub(r"\.{2,}", ".", name).strip("-.")
    return name or fallback


REFERENCE_MODEL_CLASSES = {
    "ProbabilisticFilterModel",
    "ProbabilisticFilterSVMModel",
    "ProbabilisticSingleFilterModel",
    "ProbabilisticFilterMlstSchemeModel",
}


def find_reference_models(source: Path) -> list[dict]:
    """Metadata dicts of all reference models under ``source`` (dir)."""
    models = []
    for meta_path in sorted(Path(source).rglob("*.json")):
        try:
            meta = json.loads(meta_path.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(meta, dict):
            continue
        if meta.get("model_class") in REFERENCE_MODEL_CLASSES and "k" in meta:
            meta["_path"] = meta_path
            models.append(meta)
    return models


def _download_accession_fastas(handler, accessions: list[str], dest: Path) -> dict:
    """Fetch NCBI assemblies (batched) -> {accession: fasta path}."""
    paths: dict[str, Path] = {}
    batch_size = 100
    for i in range(0, len(accessions), batch_size):
        batch = accessions[i : i + batch_size]
        batch_dir = dest / f"batch-{i}"
        handler.download_assemblies(accessions=batch, output_dir=batch_dir)
        extract_zip(batch_dir / "ncbi_dataset.zip", batch_dir)
        paths.update(get_ncbi_dataset_accession_paths(batch_dir))
    return paths


def _stage_label_dirs(split: dict, paths: dict, dest: Path) -> None:
    """cobs/svm layout: one folder per label with its accession FASTAs."""
    for label, accessions in split.items():
        label_dir = dest / str(label)
        label_dir.mkdir(parents=True, exist_ok=True)
        for acc in accessions:
            shutil.copy(paths[acc], label_dir / f"{acc}.fasta")


def _rebuild_species(meta: dict, ncbi_api_key: str | None, device) -> None:
    """Rebuild a (plain or SVM) species model from NCBI provenance."""
    from xspect2_tpu_torch.handlers.ncbi import NCBIHandler
    from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    training = meta.get("training_accessions") or {}
    svm_accessions = meta.get("svm_accessions") or {}
    if not training:
        raise ValueError("no training_accessions recorded in metadata")

    handler = NCBIHandler(api_key=ncbi_api_key)
    with TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        all_accs = [a for accs in training.values() for a in accs]
        all_accs += [a for accs in svm_accessions.values() for a in accs]
        paths = _download_accession_fastas(handler, list(dict.fromkeys(all_accs)), tmp)

        _stage_label_dirs(training, paths, tmp / "cobs")
        cobs_folders = sorted(f for f in (tmp / "cobs").iterdir() if f.is_dir())
        species_dir = tmp / "species"
        species_dir.mkdir()
        concatenate_species_fasta_files(cobs_folders, species_dir)

        common = dict(
            k=meta["k"],
            model_display_name=meta["model_display_name"],
            author=meta.get("author"),
            author_email=meta.get("author_email"),
            model_type=meta["model_type"],
            base_path=get_xspect_model_path(),
            fpr=meta.get("fpr", 0.01),
            device=device,
        )
        if meta["model_class"] == "ProbabilisticFilterSVMModel" and svm_accessions:
            _stage_label_dirs(svm_accessions, paths, tmp / "svm")
            model = ProbabilisticFilterSVMModel(
                kernel=meta.get("kernel", "rbf"), c=meta.get("C", 1.0), **common
            )
            model.fit(
                species_dir,
                tmp / "svm",
                display_names=meta.get("display_names"),
                training_accessions=training,
                svm_accessions=svm_accessions,
            )
        else:
            model = ProbabilisticFilterModel(**common)
            model.fit(
                species_dir,
                display_names=meta.get("display_names"),
                training_accessions=training,
            )
        model.save()


def _rebuild_genus(meta: dict, ncbi_api_key: str | None, device) -> None:
    """Rebuild a genus (single Bloom filter) model from NCBI provenance."""
    from xspect2_tpu_torch.handlers.ncbi import NCBIHandler
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

    accessions = meta.get("training_accessions") or []
    if isinstance(accessions, dict):
        accessions = [a for accs in accessions.values() for a in accs]
    if not accessions:
        raise ValueError("no training_accessions recorded in metadata")

    handler = NCBIHandler(api_key=ncbi_api_key)
    with TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = _download_accession_fastas(handler, accessions, tmp)
        genome_dir = tmp / "genomes"
        genome_dir.mkdir()
        for acc, path in paths.items():
            shutil.copy(path, genome_dir / f"{acc}.fasta")
        meta_fasta = tmp / f"{_safe_slug(meta['model_display_name'])}.fasta"
        concatenate_metagenome(genome_dir, meta_fasta)

        model = ProbabilisticSingleFilterModel(
            k=meta["k"],
            model_display_name=meta["model_display_name"],
            author=meta.get("author"),
            author_email=meta.get("author_email"),
            model_type=meta["model_type"],
            base_path=get_xspect_model_path(),
            fpr=meta.get("fpr", 0.01),
            device=device,
        )
        # fit() overwrites training_accessions from its own parameter, so
        # provenance must flow through the call to survive in metadata
        model.fit(
            meta_fasta,
            meta["model_display_name"],
            training_accessions=accessions,
        )
        model.save()


def _rebuild_mlst(meta: dict, device) -> None:
    """Rebuild an MLST scheme model from PubMLST provenance."""
    from xspect2_tpu_torch.handlers.pubmlst import PubMLSTHandler
    from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel

    organism = meta.get("organism")
    scheme = meta.get("model_display_name")
    if not organism or not scheme:
        raise ValueError("no organism/scheme recorded in metadata")

    handler = PubMLSTHandler()
    with TemporaryDirectory() as tmp:
        allele_path = Path(tmp)
        handler.download_alleles(organism, scheme, allele_path)
        model = ProbabilisticFilterMlstSchemeModel(
            meta["k"],
            scheme,
            get_xspect_model_path(),
            meta.get("scheme_url") or handler.get_scheme_url(organism, scheme),
            organism,
            fpr=meta.get("fpr", 0.001),
            num_hashes=meta.get("num_hashes", 1),
            author=meta.get("author"),
            author_email=meta.get("author_email"),
            model_type=meta.get("model_type", "MLST"),
            device=device,
        )
        model.fit(allele_path)
        model.save()


def _import_metadata_only(meta: dict) -> None:
    """Degraded import: metadata (+ scores.csv when present) without an index."""
    slug = _safe_slug(meta.get("model_slug") or meta["_path"].stem)
    model_dir = get_xspect_model_path() / slug
    model_dir.mkdir(parents=True, exist_ok=True)
    clean = {k: v for k, v in meta.items() if not k.startswith("_")}
    clean["model_slug"] = slug  # keep the field consistent with the file name
    clean["needs_rebuild"] = True
    (get_xspect_model_path() / f"{slug}.json").write_text(
        json.dumps(clean, indent=4), encoding="utf-8"
    )
    src_scores = meta["_path"].parent / slug / "scores.csv"
    if src_scores.exists():
        shutil.copy(src_scores, model_dir / "scores.csv")


def import_reference_models(
    source: Path,
    rebuild: bool = True,
    ncbi_api_key: str | None = None,
    device=None,
) -> dict[str, str]:
    """Import every reference model under ``source`` (a directory or zip).

    Returns {model_slug: status} where status is ``"rebuilt"`` or
    ``"metadata-only (<reason>)"``.  ``device`` is resolved before any
    model is read, so a missing card raises instead of degrading every
    model to metadata-only.
    """
    device = resolve_device(device)
    source = Path(source)
    with TemporaryDirectory() as tmp:
        if source.suffix == ".zip":
            extract_zip(source, Path(tmp))
            source = Path(tmp)
        models = find_reference_models(source)
        if not models:
            raise ValueError(f"no reference model metadata found under {source}")

        rebuilders = {
            "ProbabilisticFilterModel": lambda m: _rebuild_species(m, ncbi_api_key, device),
            "ProbabilisticFilterSVMModel": lambda m: _rebuild_species(m, ncbi_api_key, device),
            "ProbabilisticSingleFilterModel": lambda m: _rebuild_genus(m, ncbi_api_key, device),
            "ProbabilisticFilterMlstSchemeModel": lambda m: _rebuild_mlst(m, device),
        }
        statuses: dict[str, str] = {}
        for meta in models:
            slug = meta.get("model_slug", meta["_path"].stem)
            try:
                if not rebuild:
                    raise ValueError("rebuild disabled")
                rebuilders[meta["model_class"]](meta)
                statuses[slug] = "rebuilt"
                logger.info("rebuilt %s from provenance", slug)
            except Exception as exc:  # noqa: BLE001 - per-model degradation
                _import_metadata_only(meta)
                statuses[slug] = f"metadata-only ({exc})"
                logger.warning("imported %s without an index: %s", slug, exc)
        return statuses

"""Model training pipelines: local directory, NCBI, PubMLST.

The port's own copy of ``xspect2_tpu/train.py``: training
data is laid out as ``dir/cobs/<label>/*.fasta`` plus an optional
parallel ``dir/svm/<label>/*.fasta`` tree; species models use k=21 with
an rbf/C=1.0 SVM head when SVM data exists; the NCBI pipeline selects up
to 8 quality-ranked RefSeq accessions per species (first 4 feed the
filter index, last 4 the SVM scores), downloads them in batches of 100,
and filters out Candidatus and " sp." placeholder species; MLST models
train per-locus indices at k=31 from PubMLST allele downloads.

The implementation here is organized around two small value objects —
:class:`TrainingLayout` (a validated view of the on-disk training tree)
and :class:`SpeciesSelection` (one species' accession plan) — so each
pipeline is a short composition: select -> stage -> fit.

Each public function takes ``device`` (``None`` means CUDA; see
:func:`xspect2_tpu_torch.resolve_device`) and builds every model on it:
the SVM scoring of ``fit`` runs the records route there.  The handlers
(and with them ``requests``) are imported inside the functions.
"""

import logging
import shutil
from dataclasses import dataclass
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
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

logger = logging.getLogger("xspect2_tpu_torch.train")

SPECIES_K = 21
MLST_K = 31
SVM_KERNEL = "rbf"
SVM_C = 1.0
# NCBI accession plan: 8 best per species, first 4 -> index, last 4 -> SVM
ACCESSIONS_PER_SPECIES = 8
INDEX_ACCESSION_COUNT = 4
SVM_ACCESSION_COUNT = 4
DOWNLOAD_BATCH_SIZE = 100


# --------------------------------------------------------------- directory


@dataclass(frozen=True)
class TrainingLayout:
    """A validated view of a ``cobs/`` (+ optional ``svm/``) training tree."""

    root: Path
    labels: tuple[str, ...]
    has_svm: bool

    @property
    def cobs_dir(self) -> Path:
        return self.root / "cobs"

    @property
    def svm_dir(self) -> Path | None:
        return self.root / "svm" if self.has_svm else None

    @classmethod
    def scan(cls, root: Path) -> "TrainingLayout":
        if not isinstance(root, Path) or not root.is_dir():
            raise TypeError("dir must be Path object to a valid directory")
        labels = cls._subdir_names(root / "cobs", required=True)
        svm_labels = cls._subdir_names(root / "svm", required=False)
        if svm_labels is not None and svm_labels != labels:
            if len(svm_labels) != len(labels):
                raise ValueError(
                    "number of svm folders does not match number of cobs folders"
                )
            raise ValueError("cobs folder and svm folder names do not match")
        return cls(root=root, labels=labels, has_svm=svm_labels is not None)

    @staticmethod
    def _subdir_names(tree: Path, required: bool) -> tuple[str, ...] | None:
        if not tree.exists():
            if required:
                raise ValueError("cobs directory not found")
            return None
        names = tuple(sorted(f.name for f in tree.iterdir() if f.is_dir()))
        if required and not names:
            raise ValueError("no folders found in cobs directory")
        return names


def train_from_directory(
    display_name: str,
    dir_path: Path,
    meta: bool = False,
    training_accessions: dict[str, list[str]] | None = None,
    svm_accessions: dict[str, list[str]] | None = None,
    svm_step: int = 1,
    translation_dict: dict[str, str] | None = None,
    author: str | None = None,
    author_email: str | None = None,
    device=None,
):
    """Train a species (and optionally genus) model from local training data."""
    if not isinstance(display_name, str):
        raise TypeError("display_name must be a string")
    device = resolve_device(device)
    layout = TrainingLayout.scan(dir_path)
    if not layout.has_svm:
        print("SVM directory not found. Model will be trained without SVM.")

    common = dict(
        k=SPECIES_K,
        model_display_name=display_name,
        author=author,
        author_email=author_email,
        base_path=get_xspect_model_path(),
        device=device,
    )
    with TemporaryDirectory() as tmp:
        staged = Path(tmp) / "species"
        staged.mkdir(parents=True)
        logger.info("Concatenating genomes for species training...")
        concatenate_species_fasta_files(
            [layout.cobs_dir / label for label in layout.labels], staged
        )

        if layout.has_svm:
            logger.info("Training species SVM model...")
            model = ProbabilisticFilterSVMModel(
                model_type="Species", kernel=SVM_KERNEL, c=SVM_C, **common
            )
            model.fit(
                staged,
                layout.svm_dir,
                display_names=translation_dict,
                svm_step=svm_step,
                training_accessions=training_accessions,
                svm_accessions=svm_accessions,
            )
        else:
            logger.info("Training species model...")
            model = ProbabilisticFilterModel(model_type="Species", **common)
            model.fit(
                staged,
                display_names=translation_dict,
                training_accessions=training_accessions,
            )
        model.save()

        if meta:
            _train_genus_from_species_dir(
                staged, display_name, common, training_accessions
            )


def _train_genus_from_species_dir(
    species_dir: Path,
    display_name: str,
    common: dict,
    training_accessions: dict[str, list[str]] | None,
):
    """Build the whole-genus metagenome Bloom model from staged species FASTAs."""
    logger.info("Concatenating genomes for metagenome training...")
    metagenome = species_dir.parent / f"{display_name}.fasta"
    concatenate_metagenome(species_dir, metagenome)

    logger.info("Training metagenome model...")
    flat_accessions = None
    if training_accessions:
        flat_accessions = [
            acc for per_label in training_accessions.values() for acc in per_label
        ]
    genus_model = ProbabilisticSingleFilterModel(model_type="Genus", **common)
    genus_model.fit(metagenome, display_name, training_accessions=flat_accessions)
    genus_model.save()


# --------------------------------------------------------------------- NCBI


@dataclass(frozen=True)
class SpeciesSelection:
    """One species' training plan: taxon, display name, ranked accessions."""

    tax_id: int
    name: str
    accessions: tuple[str, ...]

    @property
    def index_accessions(self) -> list[str]:
        return list(self.accessions[:INDEX_ACCESSION_COUNT])

    @property
    def svm_accessions(self) -> list[str]:
        return list(self.accessions[-SVM_ACCESSION_COUNT:])


def _is_placeholder_name(name: str, allow_candidatus: bool, allow_sp: bool) -> bool:
    """Candidatus and " sp." taxa are placeholders, excluded by default."""
    lowered = name.lower()
    if not allow_candidatus and "candidatus" in lowered:
        return True
    if not allow_sp and " sp." in lowered:
        return True
    return False


def _select_species(
    handler,
    genus: str,
    *,
    min_n50: int,
    exclude_atypical: bool,
    allow_inconclusive: bool,
    allow_candidatus: bool,
    allow_sp: bool,
) -> list[SpeciesSelection]:
    """Resolve a genus to quality-ranked per-species accession plans."""
    from xspect2_tpu_torch.handlers.ncbi import AssemblySource

    genus_tax_id = handler.get_genus_taxon_id(genus)
    species_ids = handler.get_species(genus_tax_id)
    names = handler.get_taxon_names(species_ids)

    selections = []
    for tax_id in species_ids:
        if _is_placeholder_name(names[tax_id], allow_candidatus, allow_sp):
            continue
        ranked = handler.get_highest_quality_accessions(
            tax_id,
            AssemblySource.REFSEQ,
            ACCESSIONS_PER_SPECIES,
            min_n50,
            exclude_atypical,
            allow_inconclusive,
        )
        if not ranked:
            logger.warning("No assemblies found for tax_id %s. Skipping.", tax_id)
            continue
        selections.append(
            SpeciesSelection(tax_id, names[tax_id], tuple(ranked))
        )
    return selections


def _download_assembly_files(handler, accessions: list[str], work_dir: Path):
    """Batched zip download + extraction; returns {accession: fasta path}."""
    paths: dict[str, Path] = {}
    for start in range(0, len(accessions), DOWNLOAD_BATCH_SIZE):
        batch = accessions[start : start + DOWNLOAD_BATCH_SIZE]
        handler.download_assemblies(accessions=batch, output_dir=work_dir)
        extracted = work_dir / f"batch-{start}-{start + DOWNLOAD_BATCH_SIZE}"
        extract_zip(work_dir / "ncbi_dataset.zip", extracted)
        paths.update(get_ncbi_dataset_accession_paths(extracted))
    return paths


def _stage_training_tree(
    selections: list[SpeciesSelection],
    assembly_paths: dict[str, Path],
    work_dir: Path,
) -> None:
    """Materialize the cobs/ and svm/ trees train_from_directory expects."""
    plan = [
        ("cobs", lambda s: s.index_accessions),
        ("svm", lambda s: s.svm_accessions),
    ]
    for tree_name, pick in plan:
        for sel in selections:
            label_dir = work_dir / tree_name / str(sel.tax_id)
            label_dir.mkdir(parents=True, exist_ok=True)
            for accession in pick(sel):
                shutil.copy(
                    assembly_paths[accession], label_dir / f"{accession}.fasta"
                )


def train_from_ncbi(
    genus: str,
    svm_step: int = 1,
    author: str | None = None,
    author_email: str | None = None,
    ncbi_api_key: str | None = None,
    min_n50: int = 10000,
    exclude_atypical: bool = True,
    allow_inconclusive: bool = False,
    allow_candidatus: bool = False,
    allow_sp: bool = False,
    device=None,
):
    """Train species + genus models from NCBI assembly data for a genus."""
    from xspect2_tpu_torch.handlers.ncbi import NCBIHandler

    if not isinstance(genus, str):
        raise TypeError("genus must be a string")
    device = resolve_device(device)

    logger.info("Getting NCBI metadata...")
    handler = NCBIHandler(api_key=ncbi_api_key)
    selections = _select_species(
        handler,
        genus,
        min_n50=min_n50,
        exclude_atypical=exclude_atypical,
        allow_inconclusive=allow_inconclusive,
        allow_candidatus=allow_candidatus,
        allow_sp=allow_sp,
    )
    if not selections:
        raise ValueError(
            "No species with accessions found. "
            "Please check if the genus name is correct or if there are any data "
            "quality issues (e.g. inconclusive taxonomy check status, atypical "
            "assemblies, low N50 values)."
        )

    with TemporaryDirectory() as tmp:
        work_dir = Path(tmp)
        logger.info("Downloading genomes from NCBI...")
        wanted = [acc for sel in selections for acc in sel.accessions]
        assembly_paths = _download_assembly_files(handler, wanted, work_dir)
        _stage_training_tree(selections, assembly_paths, work_dir)

        train_from_directory(
            display_name=genus,
            dir_path=work_dir,
            meta=True,
            training_accessions={
                str(s.tax_id): s.index_accessions for s in selections
            },
            svm_accessions={str(s.tax_id): s.svm_accessions for s in selections},
            svm_step=svm_step,
            translation_dict={str(s.tax_id): s.name for s in selections},
            author=author,
            author_email=author_email,
            device=device,
        )


# -------------------------------------------------------------------- MLST


def train_mlst(
    organism: str,
    scheme: str,
    author: str | None = None,
    author_email: str | None = None,
    device=None,
):
    """Train an MLST model for the given organism and PubMLST scheme."""
    from xspect2_tpu_torch.handlers.pubmlst import PubMLSTHandler

    device = resolve_device(device)
    handler = PubMLSTHandler()
    with TemporaryDirectory() as tmp:
        allele_dir = Path(tmp)
        print(f"Downloading alleles for {organism} - {scheme}")
        handler.download_alleles(organism, scheme, allele_dir)

        print("Training MLST model...")
        model = ProbabilisticFilterMlstSchemeModel(
            MLST_K,
            scheme,
            get_xspect_model_path(),
            handler.get_scheme_url(organism, scheme),
            organism,
            author=author,
            author_email=author_email,
            device=device,
        )
        model.fit(allele_dir)
        model.save()

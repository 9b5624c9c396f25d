"""NCBI Datasets v2 REST client.

The port's own copy of ``xspect2_tpu/handlers/ncbi.py``: genus-taxid
validation (rank GENUS, bacteria lineage), species subtree listing,
quality-ranked accession selection walking assembly levels reference ->
complete -> chromosome -> scaffold -> contig with N50/atypical/ANI
filters, bulk zip download, and single reference-genome download per
taxid.

Rate limiting and exponential-backoff retries come from the shared
transport (:class:`~xspect2_tpu_torch.handlers.http.HttpClient`); report
filtering is a predicate over dataset reports, and the quality walk is
a fold over :data:`QUALITY_ORDER`.  The API host is overridable
(``XSPECT_NCBI_URL``) so tests run against a local mock server.
"""

import logging
import os
import shutil
import zipfile
from enum import Enum
from pathlib import Path
from urllib.parse import urlencode

from xspect2_tpu_torch.handlers.http import HttpClient

logger = logging.getLogger("xspect2_tpu_torch.ncbi")

BACTERIA_TAX_ID = 2


class AssemblyLevel(Enum):
    """Assembly quality levels."""

    REFERENCE = "reference"
    COMPLETE_GENOME = "complete_genome"
    CHROMOSOME = "chromosome"
    SCAFFOLD = "scaffold"
    CONTIG = "contig"


#: best-first walk order for quality-ranked accession selection
QUALITY_ORDER = (
    AssemblyLevel.REFERENCE,
    AssemblyLevel.COMPLETE_GENOME,
    AssemblyLevel.CHROMOSOME,
    AssemblyLevel.SCAFFOLD,
    AssemblyLevel.CONTIG,
)


class AssemblySource(Enum):
    """Assembly database source."""

    REFSEQ = "refseq"
    GENBANK = "genbank"


def _report_passes(report: dict, min_n50: int, allow_inconclusive: bool) -> bool:
    """Dataset-report quality predicate: contig N50 + ANI check status."""
    try:
        if report["assembly_stats"]["contig_n50"] < min_n50:
            return False
        if allow_inconclusive:
            return True
        ani = report["average_nucleotide_identity"]
        return ani["taxonomy_check_status"] == "OK"
    except (KeyError, TypeError):
        return False


class NCBIHandler:
    """Client for taxa metadata and assembly downloads from NCBI Datasets."""

    def __init__(self, api_key: str | None = None, base_url: str | None = None):
        self.api_key = api_key
        base_url = base_url or os.environ.get(
            "XSPECT_NCBI_URL", "https://api.ncbi.nlm.nih.gov/datasets/v2"
        )
        # NCBI allows 10 rps with an API key, otherwise 5 rps
        self.http = HttpClient(
            base_url,
            min_interval=1 / 10 if api_key else 1 / 5,
            headers={"api-key": api_key} if api_key else None,
        )

    # ------------------------------------------------------------------ taxonomy

    def get_genus_taxon_id(self, genus: str) -> int:
        """Validate a genus name and return its taxon id (must be a
        bacterial GENUS-rank taxon)."""
        payload = self.http.get_json(f"/taxonomy/taxon/{genus}")
        try:
            node = payload["taxonomy_nodes"][0]["taxonomy"]
        except (IndexError, KeyError, TypeError) as exc:
            raise ValueError(f"Invalid genus name: {genus}") from exc
        if node.get("rank") != "GENUS":
            raise ValueError(f"Genus name {genus} is not a genus.")
        lineage = node.get("lineage") or []
        if len(lineage) < 3 or lineage[2] != BACTERIA_TAX_ID:
            raise ValueError(f"Genus name {genus} does not belong to bacteria.")
        return node["tax_id"]

    def get_species(self, genus_id: int) -> list[int]:
        """Species taxon ids of a genus (visible children of the subtree)."""
        payload = self.http.get_json(f"/taxonomy/taxon/{genus_id}/filtered_subtree")
        try:
            return payload["edges"][str(genus_id)]["visible_children"]
        except (IndexError, KeyError, TypeError) as exc:
            raise ValueError(f"Invalid genus id: {genus_id}") from exc

    def get_taxon_names(self, taxon_ids: list[int]) -> dict[int, str]:
        """Organism names for up to 1000 taxon ids."""
        if not 1 <= len(taxon_ids) <= 1000:
            raise ValueError("taxon_ids must contain between 1 and 1000 ids")
        ids = ",".join(str(t) for t in taxon_ids)
        payload = self.http.get_json(f"/taxonomy/taxon/{ids}?page_size=1000")
        try:
            names = {
                int(node["taxonomy"]["tax_id"]): node["taxonomy"]["organism_name"]
                for node in payload["taxonomy_nodes"]
            }
        except (IndexError, KeyError, TypeError) as exc:
            raise ValueError(f"Invalid taxon ids: {taxon_ids}") from exc
        missing = set(taxon_ids) - set(names)
        if missing:
            raise ValueError(f"Not all taxon ids were found (missing {missing}).")
        return names

    # ------------------------------------------------------------------ assemblies

    def get_accessions(
        self,
        taxon_id: int,
        assembly_level: AssemblyLevel,
        assembly_source: AssemblySource,
        count: int,
        min_n50: int,
        exclude_atypical: bool,
        allow_inconclusive: bool,
        exclude_paired_reports: bool = True,
        current_version_only: bool = True,
    ) -> list[str]:
        """Accessions of one assembly level, filtered by N50 and ANI status."""
        filters = {
            "filters.tax_exact_match": "false",
            "filters.assembly_source": assembly_source.value,
            "filters.exclude_atypical": exclude_atypical,
            "filters.exclude_paired_reports": exclude_paired_reports,
            "filters.current_version_only": current_version_only,
            # headroom for entries removed by the N50/ANI predicate
            "page_size": count * 2,
        }
        if assembly_level == AssemblyLevel.REFERENCE:
            filters["filters.reference_only"] = "true"
        else:
            filters["filters.assembly_level"] = assembly_level.value
        query = urlencode(filters)

        payload = self.http.get_json(
            f"/genome/taxon/{taxon_id}/dataset_report?{query}"
        )
        reports = payload.get("reports") if isinstance(payload, dict) else None
        if not reports:
            logger.debug(
                "no %s reports for taxon %s", assembly_level.value, taxon_id
            )
            return []
        passing = [
            r["accession"]
            for r in reports
            if isinstance(r, dict)
            and "accession" in r
            and _report_passes(r, min_n50, allow_inconclusive)
        ]
        return passing[:count]

    def get_highest_quality_accessions(
        self,
        taxon_id: int,
        assembly_source: AssemblySource,
        count: int,
        min_n50: int,
        exclude_atypical: bool,
        allow_inconclusive: bool,
    ) -> list[str]:
        """Walk :data:`QUALITY_ORDER` best-first until ``count`` unique
        accessions are collected (deduplicated, quality order kept)."""
        collected: dict[str, None] = {}
        for level in QUALITY_ORDER:
            for acc in self.get_accessions(
                taxon_id,
                level,
                assembly_source,
                count,
                min_n50=min_n50,
                exclude_atypical=exclude_atypical,
                allow_inconclusive=allow_inconclusive,
            ):
                collected.setdefault(acc)
            if len(collected) >= count:
                break
        return list(collected)[:count]

    def download_assemblies(self, accessions: list[str], output_dir: Path) -> None:
        """Download the genome FASTA zip for the given accessions."""
        output_dir.mkdir(parents=True, exist_ok=True)
        self.http.download(
            f"/genome/accession/{','.join(accessions)}/download"
            "?include_annotation_type=GENOME_FASTA",
            output_dir / "ncbi_dataset.zip",
        )

    def download_reference_genome(
        self, taxon_id: int, output_dir: Path
    ) -> Path | None:
        """Download the RefSeq reference genome for a taxon as <taxid>.fna."""
        accessions = self.get_accessions(
            taxon_id=taxon_id,
            assembly_level=AssemblyLevel.REFERENCE,
            assembly_source=AssemblySource.REFSEQ,
            count=1,
            min_n50=0,
            exclude_atypical=True,
            allow_inconclusive=False,
        )
        if not accessions:
            return None

        logger.info(
            "downloading reference genome for taxon %s: %s", taxon_id, accessions[0]
        )
        self.download_assemblies(accessions, output_dir)
        zip_path = output_dir / "ncbi_dataset.zip"
        fna_file = None
        with zipfile.ZipFile(zip_path, "r") as zf:
            inner = next((n for n in zf.namelist() if n.endswith(".fna")), None)
            if inner is not None:
                extracted = zf.extract(inner, path=output_dir)
                fna_file = output_dir / f"{taxon_id}.fna"
                Path(extracted).rename(fna_file)
        zip_path.unlink()
        shutil.rmtree(output_dir / "ncbi_dataset", ignore_errors=True)
        return fna_file

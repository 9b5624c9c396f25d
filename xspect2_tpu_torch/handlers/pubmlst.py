"""PubMLST REST client.

The port's own copy of ``xspect2_tpu/handlers/pubmlst.py``: list seqdef
organisms, list schemes, resolve scheme URLs, download all allele
FASTAs per locus (one ``Allele_ID_<n>.fasta`` per allele, resuming by
skipping existing files), and resolve allele designations to a
strain-type name via POST.

Uses the shared retrying transport
(:class:`~xspect2_tpu_torch.handlers.http.HttpClient`); the API host is
overridable (``XSPECT_PUBMLST_URL``) so tests run against a local mock
server.
"""

import os
from pathlib import Path

from xspect2_tpu_torch.file_io import create_fasta_files
from xspect2_tpu_torch.handlers.http import HttpClient


class PubMLSTHandler:
    """Client for PubMLST scheme/allele data and strain-type lookup."""

    def __init__(self, base_url: str | None = None):
        base_url = base_url or os.environ.get(
            "XSPECT_PUBMLST_URL", "https://rest.pubmlst.org/db"
        )
        self.base_url = base_url
        self.http = HttpClient(base_url, timeout=10)

    def _schemes(self, species: str) -> list[dict]:
        payload = self.http.get_json(f"{self.base_url}/pubmlst_{species}_seqdef/schemes")
        return payload["schemes"]

    def get_available_organisms(self) -> list:
        """Organism names that have a seqdef database."""
        return [
            db["name"].split("_")[1]
            for group in self.http.get_json(self.base_url)
            for db in group["databases"]
            if db["name"].endswith("seqdef")
        ]

    def get_available_schemes(self, species: str) -> list:
        """Scheme descriptions for one organism."""
        return [scheme["description"] for scheme in self._schemes(species)]

    def get_scheme_url(self, species: str, scheme: str) -> str:
        """Resolve a scheme description to its REST URL."""
        for entry in self._schemes(species):
            if entry["description"] == scheme:
                return str(entry["scheme"])
        raise ValueError(f"Scheme '{scheme}' not found for species '{species}'.")

    def download_alleles(self, species: str, scheme: str, scheme_path: Path) -> None:
        """Download every allele FASTA of every locus of a scheme.

        Existing per-allele files are kept (resume semantics live in
        :func:`~xspect2_tpu_torch.file_io.create_fasta_files`).
        """
        scheme_json = self.http.get_json(self.get_scheme_url(species, scheme))
        for locus_url in scheme_json["loci"]:
            locus_path = scheme_path / locus_url.rsplit("/", 1)[-1]
            locus_path.mkdir(exist_ok=True, parents=True)
            create_fasta_files(
                locus_path, self.http.get_text(f"{locus_url}/alleles_fasta")
            )

    def get_strain_type_name(self, highest_results: dict, post_url: str) -> str:
        """POST allele designations; returns the ST fields or an explanation."""
        designations = {
            locus: [{"allele": str(allele)}]
            for locus, allele in highest_results.items()
        }
        response = self.http.post(
            f"{post_url}/designations", json={"designations": designations}
        )
        if response.status_code != 200:
            return "Error:" + str(response.status_code) + response.text
        data = response.json()
        if "fields" in data:
            return data["fields"]
        return (
            "No matching Strain Type found in the database. "
            "Possibly a novel Strain Type."
        )

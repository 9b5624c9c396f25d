"""File helpers: input/output fan-out for the facades, the filtered
FASTA of ``filter_sequences``, the per-allele files of a PubMLST batch,
and the concatenation and NCBI-dataset helpers of training."""

import os
import zipfile
from io import StringIO
from json import loads
from pathlib import Path
from typing import Callable

from xspect2_tpu_torch.definitions import fasta_endings, fastq_endings
from xspect2_tpu_torch.io.fasta import SeqRecord, get_record_iterator, write_fasta


def delete_zip_files(dir_path) -> None:
    """Delete all zip files in the given directory."""
    for file in os.listdir(dir_path):
        file_path = Path(dir_path) / str(file)
        if zipfile.is_zipfile(file_path):
            os.remove(file_path)


def extract_zip(zip_path: Path, unzipped_path: Path) -> None:
    """Extract all files from a zip archive."""
    unzipped_path.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(zip_path) as item:
        item.extractall(unzipped_path)


def _fasta_files(directory: Path) -> list[Path]:
    """The FASTA files of a directory, grouped by ending, each group sorted."""
    return [f for ending in fasta_endings for f in sorted(directory.glob(f"*.{ending}"))]


def concatenate_species_fasta_files(input_folders: list[Path], output_directory: Path) -> None:
    """Concatenate the FASTA files of each species folder into one
    ``<folder name>.fasta`` in ``output_directory``."""
    for species_folder in input_folders:
        fasta_files = _fasta_files(species_folder)
        if len(fasta_files) == 0:
            raise ValueError(f"no fasta files found in {species_folder}")
        concatenated = output_directory / f"{species_folder.name}.fasta"
        with open(concatenated, "w", encoding="utf-8") as out:
            for fasta_file in fasta_files:
                out.write(fasta_file.read_text(encoding="utf-8"))


def concatenate_metagenome(fasta_dir: Path, meta_path: Path) -> None:
    """Concatenate all FASTA files in a directory into one file."""
    with open(meta_path, "w", encoding="utf-8") as meta_file:
        for fasta_file in _fasta_files(fasta_dir):
            meta_file.write(fasta_file.read_text(encoding="utf-8"))


def get_ncbi_dataset_accession_paths(ncbi_dataset_path: Path) -> dict[str, Path]:
    """Accession -> file path mapping from an NCBI dataset directory."""
    data_path = ncbi_dataset_path / "ncbi_dataset" / "data"
    if not data_path.exists():
        raise ValueError(f"Path {data_path} does not exist.")
    catalog = loads((data_path / "dataset_catalog.json").read_text(encoding="utf-8"))
    # the first item of the catalog is the data report
    return {
        assembly["accession"]: data_path / assembly["files"][0]["filePath"]
        for assembly in catalog["assemblies"][1:]
    }


def filter_sequences(input_file: Path, output_file: Path, included_ids: list[str]) -> None:
    """Write the records of input_file whose ids are in included_ids (as FASTA)."""
    if not included_ids:
        print("No IDs provided, no output file will be created.")
        return
    included = set(included_ids)
    records = (rec for rec in get_record_iterator(input_file) if rec.id in included)
    write_fasta(records, output_file)


def prepare_input_output_paths(
    input_path: Path,
) -> tuple[list[Path], Callable[[int, Path], Path]]:
    """File-vs-directory input fan-out plus an output-path generator."""
    input_is_dir = input_path.is_dir()
    ending_wildcards = [f"*.{ending}" for ending in fasta_endings + fastq_endings]

    if input_is_dir:
        input_paths = [p for e in ending_wildcards for p in sorted(input_path.glob(e))]
    elif input_path.is_file():
        input_paths = [input_path]
    else:
        raise ValueError("Invalid input path")

    def get_output_path(idx: int, output_path: Path) -> Path:
        return (
            output_path.parent / f"{output_path.stem}_{idx + 1}{output_path.suffix}"
            if input_is_dir
            else output_path
        )

    return input_paths, get_output_path


def create_fasta_files(locus_path: Path, fasta_batch: str) -> None:
    """One FASTA file per allele record of a PubMLST locus batch string."""
    header = None
    chunks: list[str] = []

    def flush():
        if header is None:
            return
        rec_id = header.split(None, 1)[0]
        number = rec_id.split("_")[-1]  # example id = Oxf_cpn60_263
        out = locus_path / f"Allele_ID_{number}.fasta"
        if not out.exists():
            write_fasta([SeqRecord("".join(chunks), id=rec_id, description=header)], out)

    for line in StringIO(fasta_batch):
        line = line.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith(">"):
            flush()
            header = line[1:]
            chunks = []
        else:
            chunks.append(line)
    flush()

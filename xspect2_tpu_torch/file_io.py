"""File helpers: input/output fan-out for the facades, the filtered
FASTA of ``filter_sequences``, the per-allele files of a PubMLST batch."""

from io import StringIO
from pathlib import Path
from typing import Callable

from xspect2_tpu_torch.definitions import fasta_endings, fastq_endings
from xspect2_tpu_torch.io.fasta import SeqRecord, get_record_iterator, write_fasta


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

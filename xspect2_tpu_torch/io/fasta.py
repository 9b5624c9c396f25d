"""FASTA/FASTQ parsing and writing.

A dependency-free streaming parser.  Record ids are the first
whitespace-delimited token of the header line; iteration order is file
order.
"""

from pathlib import Path
from typing import Iterator

from xspect2_tpu_torch.definitions import fasta_endings, fastq_endings

_COMPLEMENT = str.maketrans(
    "ACGTUacgtuRYKMBVDHrykmbvdhNnSWsw-", "TGCAAtgcaaYRMKVBHDyrmkvbhdNnSWsw-"
)


def reverse_complement(seq: str) -> str:
    """Reverse complement of a DNA string (IUPAC codes complemented)."""
    return seq.translate(_COMPLEMENT)[::-1]


class SeqRecord:
    """Minimal sequence record: id, description, sequence string."""

    __slots__ = ("id", "description", "seq")

    def __init__(self, seq: str, id: str = "<unknown id>", description: str = ""):
        self.seq = seq
        self.id = id
        self.description = description

    def __len__(self) -> int:
        return len(self.seq)

    def reverse_complement(self) -> "SeqRecord":
        return SeqRecord(reverse_complement(self.seq), self.id, self.description)

    def __repr__(self) -> str:
        return f"SeqRecord(id={self.id!r}, len={len(self.seq)})"


def parse_fasta(path: Path) -> Iterator[SeqRecord]:
    """Iterate records of a FASTA file."""
    header = None
    chunks: list[str] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield _make_record(header, "".join(chunks))
                header = line[1:]
                chunks = []
            else:
                if header is None:
                    raise ValueError(f"Invalid FASTA file {path}: no header")
                chunks.append(line)
        if header is not None:
            yield _make_record(header, "".join(chunks))


def parse_fastq(path: Path) -> Iterator[SeqRecord]:
    """Iterate records of a (4-line) FASTQ file."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.rstrip("\n").rstrip("\r")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"Invalid FASTQ file {path}: bad header {header!r}")
            seq = f.readline().rstrip("\n").rstrip("\r")
            f.readline()  # "+" line
            if not f.readline():
                raise ValueError(f"Invalid FASTQ file {path}: truncated record")
            yield _make_record(header[1:], seq)


def _make_record(header: str, seq: str) -> SeqRecord:
    parts = header.split(None, 1)
    rec_id = parts[0] if parts else ""
    return SeqRecord(seq, id=rec_id, description=header)


def get_record_iterator(file_path: Path) -> Iterator[SeqRecord]:
    """Record iterator for a fasta or fastq file (by extension)."""
    if not isinstance(file_path, Path):
        raise ValueError("Path must be a Path object")
    if not file_path.exists():
        raise ValueError("File does not exist")
    if not file_path.is_file():
        raise ValueError("Path must be a file")

    if file_path.suffix[1:] in fasta_endings:
        return parse_fasta(file_path)
    if file_path.suffix[1:] in fastq_endings:
        return parse_fastq(file_path)
    raise ValueError("Invalid file format, must be a fasta or fastq file")


def write_fasta(records, path: Path, line_width: int = 60) -> None:
    """Write records to a FASTA file, sequences wrapped at 60 columns."""
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            desc = rec.description if rec.description else rec.id
            if desc.split(None, 1)[0:1] != [rec.id]:
                desc = f"{rec.id} {desc}".strip()
            f.write(f">{desc}\n")
            seq = rec.seq
            for i in range(0, len(seq), line_width):
                f.write(seq[i : i + line_width] + "\n")

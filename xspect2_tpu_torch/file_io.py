"""Input/output fan-out for the classification facades."""

from pathlib import Path
from typing import Callable

from xspect2_tpu_torch.definitions import fasta_endings, fastq_endings


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

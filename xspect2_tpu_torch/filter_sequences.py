"""Sequence filtering by genus or species score thresholds.

Classify each input file per record, keep the records whose score for
the target label passes the threshold (or wins the per-record argmax
when the threshold is -1), and write them to a new FASTA, as the JAX
package's ``filter_sequences`` does.  Each entry point takes ``device``
(``None`` means CUDA; see :func:`xspect2_tpu_torch.resolve_device`).
"""

from pathlib import Path

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.file_io import filter_sequences, prepare_input_output_paths
from xspect2_tpu_torch.model_cache import load_cached
from xspect2_tpu_torch.model_management import get_genus_model_path, get_species_model_path


def _filter_inputs_with_model(
    model,
    label: str,
    input_path: Path,
    output_path: Path,
    threshold: float,
    classification_output_path: Path | None,
    sparse_sampling_step: int,
    what: str,
) -> None:
    """Classify every input file with ``model`` and write the records
    whose ``label`` score passes ``threshold`` to the output FASTA."""
    input_paths, get_output_path = prepare_input_output_paths(input_path)

    for idx, current_path in enumerate(input_paths):
        result = model.predict(current_path, step=sparse_sampling_step)
        result.input_source = current_path.name

        if classification_output_path:
            cls_out = get_output_path(idx, classification_output_path)
            result.save(cls_out)
            print(f"Saved classification results from {current_path.name} as {cls_out.name}")

        kept_ids = result.get_filtered_subsequence_labels(label, threshold)
        if not kept_ids:
            print(f"No sequences found for the given {what} in {current_path.name}.")
            continue

        filtered_out = get_output_path(idx, output_path)
        filter_sequences(current_path, filtered_out, kept_ids)
        print(f"Saved filtered sequences from {current_path.name} as {filtered_out.name}")


def filter_species(
    model_genus: str,
    model_species: str,
    input_path: Path,
    output_path: Path,
    threshold: float,
    classification_output_path: Path | None = None,
    sparse_sampling_step: int = 1,
    device=None,
):
    """Filter sequences whose species score passes the threshold (or argmax)."""
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    model = load_cached(
        ProbabilisticFilterSVMModel, get_species_model_path(model_genus), resolve_device(device)
    )
    _filter_inputs_with_model(
        model, model_species, input_path, output_path, threshold,
        classification_output_path, sparse_sampling_step, what="species",
    )


def filter_genus(
    model_genus: str,
    input_path: Path,
    output_path: Path,
    threshold: float,
    classification_output_path: Path | None = None,
    sparse_sampling_step: int = 1,
    device=None,
):
    """Filter sequences whose genus score passes the threshold."""
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

    model = load_cached(
        ProbabilisticSingleFilterModel, get_genus_model_path(model_genus), resolve_device(device)
    )
    _filter_inputs_with_model(
        model, model_genus, input_path, output_path, threshold,
        classification_output_path, sparse_sampling_step, what="genus",
    )

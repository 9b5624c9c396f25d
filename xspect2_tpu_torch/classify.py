"""Classification facades: genus and species.

Resolve the model by genus, fan out over the input (a file, or every
sequence file of a directory) and write one result JSON per input, as
the JAX package's ``classify`` does.  Each facade takes ``device``
(``None`` means CUDA; see :func:`xspect2_tpu_torch.resolve_device`).
"""

from pathlib import Path

import xspect2_tpu_torch.model_management as mm
from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.file_io import prepare_input_output_paths
from xspect2_tpu_torch.model_cache import load_cached


def _classify_inputs(model_cls, model_path: Path, input_path: Path,
                     output_path: Path, device, **predict_kwargs):
    """Fan a file-or-directory input through one cached model."""
    model = load_cached(model_cls, model_path, resolve_device(device))
    input_paths, get_output_path = prepare_input_output_paths(input_path)
    for idx, current_path in enumerate(input_paths):
        result = model.predict(current_path, **predict_kwargs)
        result.input_source = current_path.name
        cls_path = get_output_path(idx, output_path)
        result.save(cls_path)
        print(f"Saved result as {cls_path.name}")


def classify_genus(
    model_genus: str, input_path: Path, output_path: Path, step: int = 1, device=None
):
    """Classify input files using the genus (single-filter) model."""
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

    _classify_inputs(
        ProbabilisticSingleFilterModel,
        mm.get_genus_model_path(model_genus),
        input_path,
        output_path,
        device,
        step=step,
    )


def classify_species(
    model_genus: str,
    input_path: Path,
    output_path: Path,
    step: int = 1,
    display_name: bool = False,
    validation: bool = False,
    exclude_ids: list[str] | None = None,
    device=None,
):
    """Classify input files using the species model (SVM or plain)."""
    resolve_device(device)
    if mm.is_svm_model(f"{model_genus}-species"):
        from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel as ModelClass
    else:
        from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel as ModelClass

    _classify_inputs(
        ModelClass,
        mm.get_species_model_path(model_genus),
        input_path,
        output_path,
        device,
        exclude_ids=exclude_ids,
        step=step,
        display_name=display_name,
        validation=validation,
    )

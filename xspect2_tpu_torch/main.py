"""XspecT2 command line on the PyTorch port.

The JAX package's command tree and options (``xspect2_tpu/main.py``):
``web``, ``all``, ``models {download, list, import, train {ncbi,
directory, mlst}}``, ``classify {genus, species, mlst}`` and ``filter
{genus, species}``, with interactive prompts and model choices read from
the local registry at import time.  One option is added at the root:
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain PyTorch
versions), the device every command that runs a model passes on.
Without a card, such a command fails with the message of
:func:`xspect2_tpu_torch.resolve_device` unless ``--device cpu`` is given.

Run as ``python -m xspect2_tpu_torch.main`` or as the ``xspect2-torch``
console script.
"""

from pathlib import Path
from uuid import uuid4

import click

from xspect2_tpu_torch import __version__, resolve_device
from xspect2_tpu_torch.model_management import (
    get_available_mlst_schemes,
    get_model_metadata,
    get_models,
)

# ------------------------------------------------------------------ helpers


def _models_of(model_type: str) -> list[str]:
    try:
        return get_models().get(model_type, [])
    except Exception:  # registry unreadable at import time
        return []


def _genus_option(model_type: str, help_text: str):
    return click.option(
        "-g",
        "--genus",
        "model_genus",
        help=help_text,
        type=click.Choice(_models_of(model_type)),
        prompt=True,
    )


def _input_option():
    return click.option(
        "-i",
        "--input-path",
        help="Path to FASTA or FASTQ file for classification.",
        type=click.Path(exists=True, dir_okay=True, file_okay=True),
        prompt=True,
        default=Path("."),
    )


def _output_option(stem: str, suffix: str, prompt: bool = False):
    return click.option(
        "-o",
        "--output-path",
        help="Path to the output file.",
        type=click.Path(dir_okay=False, file_okay=True),
        prompt=prompt,
        default=Path(".") / f"{stem}_{uuid4()}.{suffix}",
    )


def _step_option():
    return click.option(
        "--sparse-sampling-step",
        type=int,
        help="Sparse sampling step (e.g. only every 500th kmer for 500).",
        default=1,
    )


def _author_options(fn):
    fn = click.option("--author", help="Author of the model.", default=None)(fn)
    return click.option(
        "--author-email", help="Email of the author.", default=None
    )(fn)


def _classification_output_option():
    return click.option(
        "--classification-output-path",
        help="Optional path to the classification output file.",
        type=click.Path(dir_okay=False, file_okay=True),
    )


def _display_names_flag():
    return click.option(
        "-n",
        "--display-names",
        help="Includes the display names next to taxonomy-IDs.",
        is_flag=True,
    )


def _validation_flag():
    return click.option(
        "-v",
        "--validation",
        help="Detects misclassification for small reads or contigs.",
        is_flag=True,
    )


def _threshold_option(help_text: str, bounded: bool = True, prompt: bool = False):
    """-t/--threshold: FloatRange for 0..1 semantics, plain float when -1
    (argmax filtering) is also legal."""
    return click.option(
        "-t",
        "--threshold",
        type=click.FloatRange(0, 1) if bounded else float,
        help=help_text,
        default=0.7,
        prompt=prompt,
    )


_NCBI_QUALITY_OPTIONS = {
    "--min-n50": dict(
        type=int,
        default=10000,
        help="Minimum contig N50 to filter the accessions (default: 10000).",
    ),
    "--include-atypical/--exclude-atypical": dict(
        default=False,
        help="Include or exclude atypical accessions (default: exclude).",
    ),
    "--allow-inconclusive": dict(
        is_flag=True,
        default=False,
        help="Allow accessions with inconclusive taxonomy check status.",
    ),
    "--allow-candidatus": dict(
        is_flag=True, default=False, help="Allow Candidatus species for training."
    ),
    "--allow-sp": dict(
        is_flag=True,
        default=False,
        help="Allow species with 'sp.' in their names for training.",
    ),
}


def _ncbi_quality_options(fn):
    """The NCBI training pipeline's assembly-quality filter options."""
    for decl, kw in reversed(_NCBI_QUALITY_OPTIONS.items()):
        fn = click.option(decl, **kw)(fn)
    return fn


def _require_choice(value, choices, what, context, prompt_text):
    """Return a validated choice, prompting when no value was given."""
    if not choices:
        # prompting against an empty Choice would re-prompt forever
        raise click.BadParameter(f"No {what.lower()}s available{context}.")
    if value is None:
        return click.prompt(prompt_text, type=click.Choice(choices))
    if value not in choices:
        raise click.BadParameter(
            f"{what} '{value}' not found{context}. "
            f"Available {what.lower()}s: {', '.join(choices)}"
        )
    return value


def _opt_path(value) -> Path | None:
    return Path(value) if value else None


def _device():
    """The root ``--device``, resolved: a missing card is a usage error."""
    try:
        return resolve_device(click.get_current_context().obj["device"])
    except RuntimeError as e:
        raise click.ClickException(f"{e} (on the command line: --device cpu)") from e


# --------------------------------------------------------------------- root


@click.group()
@click.version_option(version=__version__)
@click.option(
    "--device",
    default="cuda",
    show_default=True,
    help="Device that runs the models: cuda, or cpu for the plain PyTorch versions.",
)
@click.pass_context
def cli(ctx, device):
    """XspecT2 CLI on PyTorch (CUDA)."""
    ctx.obj = {"device": device}


@cli.command()
@click.option("--host", default="0.0.0.0", help="Bind address.")
@click.option("--port", default=8000, type=int, help="Port.")
def web(host, port):
    """Serve the XspecT web application and REST API."""
    from xspect2_tpu_torch.web import serve

    serve(host=host, port=port, device=click.get_current_context().obj["device"])


# ------------------------------------------------------------- full pipeline


class _PipelineRun:
    """Output-path bookkeeping for one `xspect2 all` invocation."""

    def __init__(self, output_dir: str | None):
        self.run_id = uuid4()
        self.out = (
            Path(output_dir) if output_dir else Path(f"xspect_results_{self.run_id}")
        )
        self.filtered_dir = self.out / "filtered_sequences"
        self.filtered_dir.mkdir(exist_ok=True, parents=True)

    def path(self, stem: str, suffix: str = "json", filtered: bool = False) -> Path:
        base = self.filtered_dir if filtered else self.out
        return base / f"{stem}_{self.run_id}.{suffix}"

    def filtered_inputs(self) -> list[Path]:
        from xspect2_tpu_torch.definitions import fasta_endings, fastq_endings

        return [
            p
            for ending in fasta_endings + fastq_endings
            for p in self.filtered_dir.glob(f"*.{ending}")
        ]

    def species_predictions(self) -> dict[str, str]:
        """{result filename: predicted label} over this run's species JSONs."""
        import json

        out = {}
        for p in self.out.glob(f"species_classification_{self.run_id}*.json"):
            prediction = json.loads(p.read_text()).get("prediction")
            if prediction is not None:
                out[p.name] = prediction
        return out


@cli.command(
    name="all",
    help=(
        "Run full classification pipeline: genus filtering, species "
        "classification, and MLST (if applicable)."
    ),
)
@_genus_option("Species", "Genus of the model to use.")
@_input_option()
@click.option(
    "-o",
    "--output-dir",
    help="Directory for output files (default: auto-generated).",
    type=click.Path(dir_okay=True, file_okay=False),
    default=None,
)
@_threshold_option("Threshold for genus filtering (default: 0.7).")
@_step_option()
@_display_names_flag()
@_validation_flag()
def all_pipeline(
    model_genus, input_path, output_dir, threshold,
    sparse_sampling_step, display_names, validation,
):
    """Run the full genus -> species -> (conditional) MLST pipeline."""
    from xspect2_tpu_torch import classify, filter_sequences

    # A. baumannii (tax id 470) triggers the MLST step, as in the JAX CLI
    mlst_organism, mlst_trigger = "abaumannii", "470"

    device = _device()
    run = _PipelineRun(output_dir)

    click.echo(f"Step 1/3: Filtering for genus {model_genus}...")
    filter_sequences.filter_genus(
        model_genus,
        Path(input_path),
        run.path("genus_filtered", "fasta", filtered=True),
        threshold,
        run.path("genus_classification"),
        sparse_sampling_step=sparse_sampling_step,
        device=device,
    )
    survivors = run.filtered_inputs()
    if not survivors:
        click.echo("No sequences passed the genus filter. Pipeline aborted.")
        return

    click.echo(
        f"Step 2/3: Classifying species for {len(survivors)} filtered file(s)..."
    )
    classify.classify_species(
        model_genus,
        run.filtered_dir,
        run.path("species_classification"),
        step=sparse_sampling_step,
        display_name=display_names,
        validation=validation,
        device=device,
    )

    triggering = [
        name
        for name, prediction in run.species_predictions().items()
        if prediction == mlst_trigger
    ]
    for name in triggering:
        click.echo(f"Species prediction is {mlst_trigger} ({mlst_organism}) in {name}.")

    if not triggering:
        click.echo(
            "Step 3/3: Not running MLST classification "
            "(organism is not Acinetobacter baumannii)."
        )
    else:
        click.echo(f"Step 3/3: Running MLST classification for {mlst_organism}...")
        schemes = get_available_mlst_schemes().get(mlst_organism, [])
        if not schemes:
            click.echo(
                f"Warning: No MLST schemes available for {mlst_organism}. "
                "Skipping MLST classification."
            )
        else:
            mlst_out = run.path("mlst_classification")
            classify.classify_mlst(
                run.filtered_dir, mlst_organism, schemes[0], mlst_out, False, device=device
            )
            click.echo(f"MLST classification completed: {mlst_out.name}")

    click.echo("\nPipeline completed successfully!")
    click.echo(f"Results saved in: {run.out}")


# ------------------------------------------------------------------- models


@cli.group()
def models():
    """Model management commands."""


@models.command(help="Download models from the internet.")
@click.option("--url", default=None, help="Override the bundle URL.")
def download(url):
    """Download pre-trained models (native or reference bundles)."""
    device = _device()
    click.echo("Downloading models, this may take a while...")
    from xspect2_tpu_torch.download_models import download_test_models

    for slug, status in download_test_models(url=url, device=device).items():
        click.echo(f"  {slug}: {status}")


@models.command(
    name="import",
    help="Import a reference-XspecT model bundle (zip or directory): "
    "metadata and scores carry over, indices rebuild from their recorded "
    "training provenance (NCBI/PubMLST).",
)
@click.option(
    "-p",
    "--path",
    "bundle_path",
    prompt=True,
    type=click.Path(exists=True, path_type=Path),
)
@click.option(
    "--no-rebuild",
    is_flag=True,
    help="Import metadata/scores only; skip index rebuilds.",
)
def import_models(bundle_path, no_rebuild):
    """Import reference models with provenance-based index rebuild."""
    from xspect2_tpu_torch.reference_import import import_reference_models

    for slug, status in import_reference_models(
        bundle_path, rebuild=not no_rebuild, device=_device()
    ).items():
        click.echo(f"  {slug}: {status}")


@models.command(name="list", help="List all models in the model directory.")
def list_models():
    """List models."""
    available = {t: names for t, names in get_models().items() if names}
    if not available:
        click.echo("No models found.")
        return
    click.echo("Models found:")
    click.echo("--------------")
    for model_type, names in available.items():
        click.echo(f"  {model_type}:")
        for name in names:
            click.echo(f"    - {name}")


@models.group()
def train():
    """Train models."""


@train.command(name="ncbi", help="Train a species and a genus model based on NCBI data.")
@click.option("-g", "--genus", "model_genus", prompt=True)
@click.option("--svm_steps", type=int, default=1)
@_author_options
@_ncbi_quality_options
def train_ncbi(
    model_genus, svm_steps, author, author_email,
    min_n50, include_atypical, allow_inconclusive, allow_candidatus, allow_sp,
):
    """Train a species and a genus model based on NCBI data."""
    from xspect2_tpu_torch.train import train_from_ncbi

    device = _device()
    click.echo(f"Training {model_genus} species and genus metagenome model.")
    try:
        train_from_ncbi(
            model_genus,
            svm_steps,
            author,
            author_email,
            min_n50=min_n50,
            exclude_atypical=not include_atypical,
            allow_inconclusive=allow_inconclusive,
            allow_candidatus=allow_candidatus,
            allow_sp=allow_sp,
            device=device,
        )
    except ValueError as e:
        click.echo(f"Error: {e}")
        return
    click.echo(f"Training of {model_genus} model finished.")


@train.command(
    name="directory",
    help="Train a species (and possibly a genus) model based on local data.",
)
@click.option("-g", "--genus", "model_genus", prompt=True)
@click.option(
    "-i",
    "--input-path",
    type=click.Path(exists=True, dir_okay=True, file_okay=True),
    prompt=True,
)
@click.option(
    "--meta",
    is_flag=True,
    flag_value=True,  # click < 8.2 would set "not default" when it is given
    help="Train a metagenome model for the genus.",
    default=True,
)
@click.option(
    "--svm-steps",
    type=int,
    help="SVM sparse sampling step size.",
    default=1,
)
@_author_options
def train_directory(model_genus, input_path, svm_steps, meta, author, author_email):
    """Train a model based on data from a directory for a given genus."""
    from xspect2_tpu_torch.train import train_from_directory

    device = _device()
    click.echo(f"Training {model_genus} model with {svm_steps} SVM steps.")
    train_from_directory(
        model_genus,
        Path(input_path),
        svm_step=svm_steps,
        meta=meta,
        author=author,
        author_email=author_email,
        device=device,
    )


@train.command(name="mlst", help="Train a MLST model based on PubMLST data.")
@click.option(
    "--organism", "organism", help="Underlying organism for the MLST model.", type=str
)
@click.option("--mlst-scheme", "scheme", help="MLST scheme to use.", type=str)
@_author_options
def train_mlst(organism, scheme, author, author_email):
    """Download alleles and train MLST models."""
    from xspect2_tpu_torch.handlers.pubmlst import PubMLSTHandler
    from xspect2_tpu_torch.train import train_mlst as train_mlst_model

    device = _device()
    handler = PubMLSTHandler()
    organism = _require_choice(
        organism,
        handler.get_available_organisms(),
        "Organism",
        "",
        "Please enter the organism you want to train the MLST model for:",
    )
    scheme = _require_choice(
        scheme,
        handler.get_available_schemes(organism),
        "Scheme",
        f" for organism '{organism}'",
        "Please enter the scheme you want to train the MLST model for:",
    )
    train_mlst_model(organism, scheme, author, author_email, device=device)


# ----------------------------------------------------------- classification


@cli.group(name="classify", help="Classify sequences using XspecT models.")
def classify_seqs():
    """Classification commands."""


@classify_seqs.command(name="genus", help="Classify samples using a genus model.")
@_genus_option("Genus", "Genus of the model to classify.")
@_input_option()
@_output_option("result", "json")
@_step_option()
def classify_genus(model_genus, input_path, output_path, sparse_sampling_step):
    """Classify samples using a genus model."""
    from xspect2_tpu_torch import classify

    device = _device()
    click.echo("Classifying...")
    classify.classify_genus(
        model_genus, Path(input_path), Path(output_path), sparse_sampling_step, device=device
    )


@classify_seqs.command(name="species", help="Classify samples using a species model.")
@_genus_option("Species", "Genus of the model to classify.")
@_input_option()
@_output_option("result", "json")
@_step_option()
@_display_names_flag()
@_validation_flag()
@click.option(
    "--exclude-species",
    help="Comma-separated list of species IDs to exclude from classification.",
    type=str,
    default=None,
)
def classify_species(
    model_genus, input_path, output_path,
    sparse_sampling_step, display_names, validation, exclude_species,
):
    """Classify samples using a species model."""
    from xspect2_tpu_torch import classify

    device = _device()
    click.echo("Classifying...")
    exclude_ids = (
        [s.strip() for s in exclude_species.split(",")] if exclude_species else None
    )
    classify.classify_species(
        model_genus,
        Path(input_path),
        Path(output_path),
        step=sparse_sampling_step,
        display_name=display_names,
        validation=validation,
        exclude_ids=exclude_ids,
        device=device,
    )


@classify_seqs.command(name="mlst", help="Classify samples using a MLST model.")
@_input_option()
@click.option(
    "--organism",
    "organism",
    help="Underlying organism for the MLST model.",
    type=click.Choice(list(get_available_mlst_schemes().keys())),
    prompt=True,
)
@click.option("--mlst-scheme", "mlst_scheme", help="MLST scheme to use.", type=str)
@_output_option("MLST_result", "json")
@click.option(
    "-l", "--limit", is_flag=True, help="Limit the output to 5 results for each locus."
)
def classify_mlst(input_path, organism, mlst_scheme, output_path, limit):
    """MLST classify a sample."""
    from xspect2_tpu_torch import classify

    mlst_scheme = _require_choice(
        mlst_scheme,
        get_available_mlst_schemes().get(organism, []),
        "Scheme",
        f" for organism '{organism}'",
        "Please enter the MLST scheme you want to use:",
    )
    device = _device()
    click.echo("Classifying...")
    classify.classify_mlst(
        Path(input_path), organism, mlst_scheme, Path(output_path), limit, device=device
    )


# ---------------------------------------------------------------- filtering


@cli.group(name="filter", help="Filter sequences using XspecT models.")
def filter_seqs():
    """Filter commands."""


@filter_seqs.command(name="genus", help="Filter sequences using a genus model.")
@_genus_option("Species", "Genus of the model to use for filtering.")
@_input_option()
@_output_option("genus_filtered", "fasta", prompt=True)
@_classification_output_option()
@_threshold_option("Threshold for filtering (default: 0.7).", prompt=True)
@_step_option()
def filter_genus(
    model_genus, input_path, output_path,
    classification_output_path, threshold, sparse_sampling_step,
):
    """Filter samples using a genus model."""
    from xspect2_tpu_torch import filter_sequences

    device = _device()
    click.echo("Filtering...")
    filter_sequences.filter_genus(
        model_genus,
        Path(input_path),
        Path(output_path),
        threshold,
        _opt_path(classification_output_path),
        sparse_sampling_step=sparse_sampling_step,
        device=device,
    )


def _resolve_species_id(model_genus: str, species_name: str | None) -> str:
    """Map a user-facing species name to its label id, prompting if absent.

    Display names are shown without the genus prefix, matched
    case-insensitively.
    """
    metadata = get_model_metadata(f"{model_genus}-species")
    short_names = {
        label: name.replace(f"{model_genus} ", "")
        for label, name in metadata["display_names"].items()
    }
    if not species_name:
        species_name = click.prompt(
            f"Please enter the species name: {model_genus}",
            type=click.Choice(sorted(short_names.values()), case_sensitive=False),
        )
    matches = [
        label
        for label, name in short_names.items()
        if name.lower() == species_name.lower()
    ]
    if not matches:
        raise click.BadParameter(
            f"Species '{species_name}' not found in the {model_genus} species model."
        )
    return matches[0]


@filter_seqs.command(name="species", help="Filter sequences using a species model.")
@_genus_option("Species", "Genus of the model to use for filtering.")
@click.option(
    "-s",
    "--species",
    "model_species",
    help="Species of the model to filter for.",
)
@_input_option()
@_output_option("species_filtered", "fasta", prompt=True)
@_classification_output_option()
@_threshold_option(
    "Threshold for filtering (default: 0.7). Use -1 to filter for the "
    "highest scoring species.",
    bounded=False,
    prompt=True,
)
@_step_option()
def filter_species(
    model_genus, model_species, input_path, output_path,
    threshold, classification_output_path, sparse_sampling_step,
):
    """Filter a sample using the species model."""
    from xspect2_tpu_torch import filter_sequences

    if threshold != -1 and not 0 <= threshold <= 1:
        raise click.BadParameter(
            "Threshold must be between 0 and 1, or -1 for filtering by the "
            "highest scoring species."
        )
    label = _resolve_species_id(model_genus, model_species)

    device = _device()
    click.echo("Filtering...")
    filter_sequences.filter_species(
        model_genus,
        label,
        Path(input_path),
        Path(output_path),
        threshold,
        _opt_path(classification_output_path),
        sparse_sampling_step=sparse_sampling_step,
        device=device,
    )


if __name__ == "__main__":
    cli()

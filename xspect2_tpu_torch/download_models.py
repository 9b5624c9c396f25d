"""Pre-trained model downloader.

The port's own copy of ``xspect2_tpu/download_models.py``: downloads the
public pre-trained bundle (Acinetobacter + Salmonella species/genus
models + the Oxford MLST scheme) and makes it usable.  Two bundle kinds
are recognized:

- **framework-native bundles** (zip containing ``.bbsi`` index
  artifacts) unpack directly into the model registry;
- **reference bundles** (COBS/rbloom binaries + metadata JSON) go
  through :mod:`xspect2_tpu_torch.reference_import`: metadata and scores.csv
  carry over as-is and each index is rebuilt from its recorded training
  provenance (NCBI accessions / PubMLST alleles) — see that module for
  why bit-level conversion of the binaries is not meaningful here.

``XSPECT_MODEL_BUNDLE_URL`` overrides the bundle URL.  ``requests`` is
imported inside :func:`download_test_models`.
"""

import os
import zipfile
from pathlib import Path
from tempfile import TemporaryDirectory

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.definitions import get_xspect_model_path
from xspect2_tpu_torch.file_io import extract_zip

#: the reference project's public pre-trained bundle
DEFAULT_BUNDLE_URL = (
    "https://assets.adrianromberg.com/science/xspect-models-10-27-2025.zip"
)


def _is_native_bundle(zip_path: Path) -> bool:
    """A bundle is framework-native iff it ships .bbsi index artifacts."""
    with zipfile.ZipFile(zip_path) as zf:
        return any(".bbsi/" in n or n.endswith(".bbsi") for n in zf.namelist())


def download_test_models(
    url: str | None = None, ncbi_api_key: str | None = None, device=None
) -> dict[str, str]:
    """Download the pre-trained model bundle and install/import it.

    Returns {model_slug: status} for reference bundles ("rebuilt" or
    "metadata-only (...)"), or {"bundle": "native"} for native bundles.
    ``device`` (``None`` means CUDA) is where rebuilt models are fitted.
    """
    device = resolve_device(device)
    url = url or os.environ.get("XSPECT_MODEL_BUNDLE_URL") or DEFAULT_BUNDLE_URL

    import requests

    with TemporaryDirectory() as tmp:
        zip_path = Path(tmp) / "models.zip"
        response = requests.get(url, stream=True, timeout=30)
        response.raise_for_status()
        with open(zip_path, "wb") as f:
            for chunk in response.iter_content(chunk_size=1 << 20):
                f.write(chunk)

        if _is_native_bundle(zip_path):
            extract_zip(zip_path, get_xspect_model_path())
            return {"bundle": "native"}

        from xspect2_tpu_torch.reference_import import import_reference_models

        return import_reference_models(zip_path, ncbi_api_key=ncbi_api_key, device=device)

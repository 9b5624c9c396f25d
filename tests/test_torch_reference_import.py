"""Reference-bundle import and the bundle download of the port.

Mirrors ``tests/test_reference_import.py`` (its CLI test waits for the
port's CLI): a fake reference bundle whose recorded training accessions
point at the mock NCBI and PubMLST servers is imported by both
packages, each under its own ``XSPECT_DATA_ROOT``; the rebuilt model
trees and the degraded metadata-only imports must be byte-identical.
"""

import json
import shutil
import zipfile

import numpy as np
import pytest

from tests.mock_services import MLST_ORGANISM, MLST_SCHEME, MockServices, genome_for
from tests.test_reference_import import _make_reference_bundle
from tests.test_torch_train import _assert_same_tree
from xspect2_tpu import reference_import as jax_reference_import
from xspect2_tpu_torch import download_models
from xspect2_tpu_torch import model_management as mm
from xspect2_tpu_torch.definitions import get_xspect_model_path
from xspect2_tpu_torch.reference_import import _safe_slug, find_reference_models, import_reference_models


@pytest.fixture(scope="module")
def services():
    with MockServices() as svc:
        yield svc


def _import_both(tmp_path, monkeypatch, source, **kwargs):
    """Import ``source`` with both packages; returns both status dicts."""
    statuses = {}
    for name, fn, extra in (("jax", jax_reference_import.import_reference_models, {}),
                            ("port", import_reference_models, {"device": "cpu"})):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / f"{name}-data"))
        statuses[name] = fn(source, **kwargs, **extra)
    _assert_same_tree(tmp_path / "port-data" / "models", tmp_path / "jax-data" / "models")
    return statuses


def test_import_rebuilds_from_provenance(services, tmp_path, monkeypatch):
    monkeypatch.setenv("XSPECT_NCBI_URL", services.url)
    monkeypatch.setenv("XSPECT_PUBMLST_URL", f"{services.url}/db")
    for module in ("xspect2_tpu", "xspect2_tpu_torch"):
        monkeypatch.setattr(f"{module}.handlers.http.HttpClient._wait_turn", lambda self: None)
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    bundle = _make_reference_bundle(tmp_path)
    statuses = _import_both(tmp_path, monkeypatch, bundle)
    assert statuses["port"] == statuses["jax"] == {
        "testus-species": "rebuilt", "testus-genus": "rebuilt", "testorg-mlst-oxford-mlst": "rebuilt",
    }
    meta = mm.get_model_metadata(mm.get_species_model_path("Testus"))
    assert meta["author"] == "Ref Author" and meta["display_names"]["102"] == "Testus secundus"
    model = ProbabilisticFilterSVMModel.load(mm.get_species_model_path("Testus"), device="cpu")
    hits = model.calculate_hits(genome_for("GCF_101.1")[50:350])
    assert max(hits, key=hits.get) == "101"
    assert mm.get_model_metadata(mm.get_genus_model_path("Testus"))["training_accessions"] == ["GCF_101.1", "GCF_102.1"]
    assert MLST_SCHEME in mm.get_available_mlst_schemes()[MLST_ORGANISM]


def test_import_zip_and_metadata_only_fallback(tmp_path, monkeypatch):
    """Without a rebuild the import degrades to metadata-only, from a zip."""
    monkeypatch.setenv("XSPECT_NCBI_URL", "http://127.0.0.1:1")  # unreachable
    monkeypatch.setenv("XSPECT_PUBMLST_URL", "http://127.0.0.1:1")
    bundle = _make_reference_bundle(tmp_path)
    zip_path = tmp_path / "models.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for p in bundle.rglob("*"):
            zf.write(p, p.relative_to(bundle))
    shutil.rmtree(bundle)
    statuses = _import_both(tmp_path, monkeypatch, zip_path, rebuild=False)
    assert statuses["port"] == statuses["jax"]
    assert all(s.startswith("metadata-only") for s in statuses["port"].values())
    meta = json.loads((get_xspect_model_path() / "testus-species.json").read_text())
    assert meta["needs_rebuild"] is True
    assert (get_xspect_model_path() / "testus-species" / "scores.csv").exists()


def test_import_sanitizes_hostile_slugs(tmp_path, monkeypatch):
    """Bundle metadata is untrusted: traversal slugs stay inside the registry."""
    monkeypatch.setenv("XSPECT_NCBI_URL", "http://127.0.0.1:1")  # unreachable
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    (bundle / "evil.json").write_text(json.dumps({
        "model_slug": "../../escape", "model_display_name": "../../escape",
        "model_class": "ProbabilisticFilterModel", "model_type": "Species", "k": 21,
    }))
    (bundle / "not-a-model.json").write_text(json.dumps({"model_class": "Other", "k": 3}))
    (bundle / "broken.json").write_text("{")
    statuses = _import_both(tmp_path, monkeypatch, bundle, rebuild=False)
    assert len(statuses["port"]) == 1 and statuses["port"] == statuses["jax"]
    assert not (tmp_path / "escape.json").exists()
    written = list(get_xspect_model_path().glob("*.json"))
    assert any("escape" in p.name and ".." not in p.name for p in written)
    assert [m["_path"].name for m in find_reference_models(bundle)] == ["evil.json"]


@pytest.mark.parametrize("name", ["../../escape", "a b/c", "..", "", None, "Ok.name-1"])
def test_safe_slug_matches_jax(name):
    assert _safe_slug(name) == jax_reference_import._safe_slug(name)


def test_import_refuses_a_bundle_without_models(tmp_path, monkeypatch):
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "data"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no reference model metadata"):
        import_reference_models(tmp_path / "empty", device="cpu")


def test_download_detects_native_bundle(tmp_path, monkeypatch):
    """A zip with .bbsi artifacts unpacks directly (no import layer)."""
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "data"))
    native_dir = tmp_path / "native"
    (native_dir / "m" / "index.bbsi").mkdir(parents=True)
    (native_dir / "m" / "index.bbsi" / "index_meta.json").write_text("{}")
    np.save(native_dir / "m" / "index.bbsi" / "table.npy", np.zeros(4, np.uint32))
    (native_dir / "m.json").write_text(json.dumps({"model_slug": "m"}))
    zip_path = tmp_path / "native.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for p in native_dir.rglob("*"):
            if p.is_file():
                zf.write(p, p.relative_to(native_dir))
    assert download_models._is_native_bundle(zip_path)

    class _Resp:
        status_code = 200

        def raise_for_status(self):
            pass

        def iter_content(self, chunk_size):
            yield zip_path.read_bytes()

    monkeypatch.setattr("requests.get", lambda url, stream=True, timeout=30: _Resp())
    statuses = download_models.download_test_models(url="http://x/native.zip", device="cpu")
    assert statuses == {"bundle": "native"}
    assert (get_xspect_model_path() / "m" / "index.bbsi" / "table.npy").exists()


def test_download_imports_a_reference_bundle(tmp_path, monkeypatch):
    """A bundle without .bbsi artifacts goes through the import layer."""
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("XSPECT_MODEL_BUNDLE_URL", "http://x/ref.zip")
    monkeypatch.setenv("XSPECT_NCBI_URL", "http://127.0.0.1:1")  # unreachable: no rebuild can run
    bundle = _make_reference_bundle(tmp_path)
    zip_path = tmp_path / "ref.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for p in bundle.rglob("*"):
            zf.write(p, p.relative_to(bundle))
    assert not download_models._is_native_bundle(zip_path)
    calls = []

    class _Resp:
        def raise_for_status(self):
            pass

        def iter_content(self, chunk_size):
            yield zip_path.read_bytes()

    monkeypatch.setattr("requests.get", lambda url, stream=True, timeout=30: calls.append(url) or _Resp())
    seen = []
    monkeypatch.setattr("xspect2_tpu_torch.reference_import.import_reference_models",
                        lambda path, ncbi_api_key=None, device=None: seen.append((path.name, ncbi_api_key, device.type))
                        or {"testus-species": "rebuilt"})
    assert download_models.download_test_models(ncbi_api_key="key", device="cpu") == {"testus-species": "rebuilt"}
    assert calls == ["http://x/ref.zip"] and seen == [("models.zip", "key", "cpu")]

"""The port's web app (``xspect2_tpu_torch.web``) answers as the JAX one.

Mirrors ``tests/test_web.py`` and ``tests/test_webui_js.py``: the page is
byte-identical and its script passes the JS scanner; the same requests
go to ``xspect2_tpu.web.XspectWebApp()`` and to the port's
``XspectWebApp(device="cpu")`` through werkzeug's test client, each
under its own ``XSPECT_DATA_ROOT`` (the registries of
``tests/test_torch_cli.py``), and every response (status, body, the
result JSON of a finished task, the filtered FASTA) must be equal.
Background tasks are joined instead of polled by the clock.
"""


import numpy as np
import pytest
from werkzeug.test import Client

from tests.test_torch_cli import registries  # noqa: F401 - module fixture
from tests.test_webui_js import extract_script, scan_js
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu import web as jax_web
from xspect2_tpu import webui as jax_webui
from xspect2_tpu.io.fasta import SeqRecord, write_fasta
from xspect2_tpu_torch import model_cache, web, webui


@pytest.fixture(autouse=True)
def _fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


@pytest.fixture()
def apps(registries, monkeypatch):  # noqa: F811
    """``call(name, method, url, **kw)``: one request to package ``name``'s
    app under its own data root, its tasks joined before it returns; the
    response's ``norm`` is its body with the data root replaced."""
    roots, genomes = registries
    instances = {"jax": jax_web.XspectWebApp(), "port": web.XspectWebApp(device="cpu")}

    def call(name, method, url, **kw):
        monkeypatch.setenv("XSPECT_DATA_ROOT", str(roots[name]))
        app = instances[name]
        resp = getattr(Client(app), method)(url, **kw)
        app.tasks.join_all(120)
        resp.norm = resp.data.replace(str(roots[name]).encode(), b"<root>")
        return resp

    return call, genomes


def both(call, method, url, **kw):
    """The same request to both apps: (port response, jax response)."""
    files = kw.pop("upload", None)
    out = {}
    for name in ("jax", "port"):
        if files is not None:
            with open(files, "rb") as f:
                kw["data"] = {"file": (f, files.name)}
                out[name] = call(name, method, url, **kw)
        else:
            out[name] = call(name, method, url, **kw)
    return out["port"], out["jax"]


def test_index_page_is_the_jax_page():
    assert webui.INDEX_HTML == jax_webui.INDEX_HTML
    assert web._INDEX_HTML is webui.INDEX_HTML
    start = webui.INDEX_HTML.index("<script>") + len("<script>")
    script = webui.INDEX_HTML[start : webui.INDEX_HTML.index("</script>")]
    assert script == extract_script() and len(script) > 1000
    scan_js(script)
    resp = Client(web.XspectWebApp(device="cpu")).get("/")
    assert resp.status_code == 200 and resp.data == webui.INDEX_HTML.encode()
    assert resp.mimetype == "text/html"


def test_list_models_and_metadata_roundtrip(apps):
    call, _ = apps
    for url in ("/api/list-models", "/api/model-metadata?model_slug=synthetic-species",
                "/api/model-metadata?model_slug=nonexistent"):
        port, jax = both(call, "get", url)
        assert (port.status_code, port.norm) == (jax.status_code, jax.norm), url
    assert port.status_code == 404
    for url in ("/api/model-metadata?model_slug=synthetic-species&author=bob&author_email=b@c.d",
                "/api/model-display-name?model_slug=synthetic-species&filter_id=470&display_name=Syn%20b",
                "/api/model-metadata?model_slug=nonexistent&author=x&author_email=y"):
        port, jax = both(call, "post", url)
        assert (port.status_code, port.norm) == (jax.status_code, jax.norm), url
    port, jax = both(call, "get", "/api/model-metadata?model_slug=synthetic-species")
    assert port.norm == jax.norm and port.get_json()["author"] == "bob"
    port, jax = both(call, "get", "/api/list-models")
    assert port.get_json() == jax.get_json() and "Synthetic" in port.get_json()["Species"]


@pytest.mark.parametrize("kind", ["Species", "Genus"])
def test_upload_classify_poll(apps, tmp_path, kind):
    call, genomes = apps
    sample = tmp_path / "websample.fasta"
    write_fasta([SeqRecord(genomes["470"], id="c1"), SeqRecord(genomes["471"][:3000], id="c2")], sample)
    port, jax = both(call, "post", "/api/upload-file", upload=sample)
    assert port.status_code == 200 and port.norm == jax.norm == b'{"filename": "websample.fasta"}'
    port, jax = both(call, "post", f"/api/classify?classification_type={kind}&model=Synthetic&file=websample.fasta")
    assert port.status_code == jax.status_code == 200
    uuids = {"port": port.get_json()["uuid"], "jax": jax.get_json()["uuid"]}
    assert port.get_json()["message"] == jax.get_json()["message"] == "Classification started."
    results = {name: call(name, "get", f"/api/classification-result?uuid={uuid}") for name, uuid in uuids.items()}
    assert results["port"].status_code == results["jax"].status_code == 200
    assert results["port"].norm == results["jax"].norm
    if kind == "Species":
        assert results["port"].get_json()["prediction"] == "470"


@pytest.mark.parametrize("kind", ["Genus", "Species"])
def test_filter_flow_and_download(apps, tmp_path, kind):
    call, genomes = apps
    mixed = tmp_path / "webmixed.fasta"
    records = [SeqRecord(genomes["470"][i * 700 : i * 700 + 400], id=f"a{i}") for i in range(5)]
    rng = np.random.default_rng(9)
    records += [SeqRecord("".join(rng.choice(list("ACGT"), size=400)), id=f"junk{i}") for i in range(5)]
    write_fasta(records, mixed)
    both(call, "post", "/api/upload-file", upload=mixed)
    url = f"/api/filter?filter_type={kind}&genus=Synthetic&input_file=webmixed.fasta&threshold=0.7"
    if kind == "Species":
        url += "&filter_species=470"
    port, jax = both(call, "post", url)
    assert port.status_code == jax.status_code == 200
    assert port.get_json()["message"] == jax.get_json()["message"]
    uuids = {"port": port.get_json()["uuid"], "jax": jax.get_json()["uuid"]}
    out = {}
    for name, uuid in uuids.items():
        done = call(name, "get", f"/api/filtering-result?uuid={uuid}")
        assert done.status_code == 200 and done.get_json() == {
            "message": "Filtering completed successfully.", "uuid": uuid}
        result = call(name, "get", f"/api/classification-result?uuid={uuid}")
        download = call(name, "get", f"/api/download-filtered?uuid={uuid}")
        assert download.status_code == 200
        assert download.headers["Content-Disposition"].endswith(f'filtered_{uuid}.fasta"')
        out[name] = (result.norm, download.data)
    assert out["port"] == out["jax"]
    body = out["port"][1].decode()
    assert ">a0" in body and "junk" not in body


@pytest.mark.parametrize("method,url,status", [
    ("post", "/api/classify?classification_type=Species&model=Synthetic&file=nope.fasta", 404),
    ("post", "/api/filter?filter_type=Genus&genus=Synthetic&input_file=nope.fasta", 404),
    ("get", "/api/classification-result?uuid=no-such-uuid", 404),
    ("get", "/api/filtering-result?uuid=no-such-uuid", 404),
    ("get", "/api/download-filtered?uuid=no-such-uuid", 404),
    ("get", "/no/such/route", 404),
    ("post", "/api/upload-file", 400),
])
def test_errors_answer_as_in_jax(apps, method, url, status):
    call, _ = apps
    port, jax = both(call, method, url)
    assert port.status_code == jax.status_code == status
    assert port.norm == jax.norm


@pytest.mark.parametrize("url,status", [
    ("/api/classify?classification_type=Wat&model=Synthetic&file=u.fasta", 501),
    ("/api/filter?filter_type=Wat&genus=Synthetic&input_file=u.fasta", 501),
    ("/api/filter?filter_type=Species&genus=Synthetic&input_file=u.fasta", 400),
])
def test_unknown_types_and_missing_species(apps, tmp_path, url, status):
    call, genomes = apps
    sample = tmp_path / "u.fasta"
    write_fasta([SeqRecord(genomes["470"][:2000], id="c")], sample)
    both(call, "post", "/api/upload-file", upload=sample)
    port, jax = both(call, "post", url)
    assert port.status_code == jax.status_code == status
    assert port.norm == jax.norm


def test_importing_web_builds_an_app_that_resolves_no_device():
    """The module's WSGI app is built at import without resolving a
    device: it answers the page and the registry on any machine."""
    assert web.app.device is None
    assert web.XspectWebApp().device is None
    assert Client(web.app).get("/").status_code == 200

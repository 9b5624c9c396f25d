"""Web application: REST API and the built-in web UI.

The JAX package's web surface (``xspect2_tpu/web.py``) on the port:
Werkzeug routes served by cheroot, the same routes, query parameters,
response shapes and background-task model (jobs keyed by UUID writing
result JSON into the runs directory):

- GET  /api/classification-result?uuid=
- GET  /api/filtering-result?uuid=
- GET  /api/download-filtered?uuid=
- GET  /api/download-filters
- GET  /api/list-models
- GET  /api/model-metadata?model_slug=
- POST /api/classify?classification_type=&model=&file=&step=
- POST /api/filter?filter_type=&genus=&input_file=&threshold=&filter_species=&step=
- POST /api/train?genus=&svm_steps=
- POST /api/model-metadata?model_slug=&author=&author_email=
- POST /api/model-display-name?model_slug=&filter_id=&display_name=
- POST /api/upload-file   (multipart file)

The page of :mod:`xspect2_tpu_torch.webui` is served at ``/``.

:class:`XspectWebApp` takes ``device`` (``None`` means CUDA) and resolves
it when a request starts a classify, filter, train or download task, not
when the app is built: the app imports and lists models without a card,
and a task asked of it without one answers 500 with the
:func:`~xspect2_tpu_torch.resolve_device` message.
"""

import json
import threading
import traceback
from pathlib import Path
from uuid import uuid4

from werkzeug.exceptions import HTTPException, NotFound
from werkzeug.routing import Map, Rule
from werkzeug.utils import secure_filename
from werkzeug.wrappers import Request, Response

import xspect2_tpu_torch.model_management as mm
from xspect2_tpu_torch import classify, filter_sequences, resolve_device
from xspect2_tpu_torch.definitions import get_xspect_runs_path, get_xspect_upload_path
from xspect2_tpu_torch.webui import INDEX_HTML as _INDEX_HTML


class BackgroundTasks:
    """One daemon thread per submitted job; results are polled by UUID."""

    def __init__(self):
        self._threads: list[threading.Thread] = []

    def add_task(self, fn, *args, **kwargs):
        def run():
            try:
                fn(*args, **kwargs)
            except Exception:  # noqa: BLE001 - job errors surface via logs
                traceback.print_exc()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def join_all(self, timeout: float | None = None):
        for t in self._threads:
            t.join(timeout)


class XspectWebApp:
    """WSGI application implementing the XspecT REST API."""

    def __init__(self, device=None):
        self.device = device
        self.tasks = BackgroundTasks()
        self.url_map = Map(
            [
                Rule("/", endpoint="index", methods=["GET"]),
                Rule("/api/download-filters", endpoint="download_filters", methods=["GET"]),
                Rule("/api/classification-result", endpoint="classification_result", methods=["GET"]),
                Rule("/api/classify", endpoint="classify", methods=["POST"]),
                Rule("/api/filter", endpoint="filter", methods=["POST"]),
                Rule("/api/filtering-result", endpoint="filtering_result", methods=["GET"]),
                Rule("/api/download-filtered", endpoint="download_filtered", methods=["GET"]),
                Rule("/api/train", endpoint="train", methods=["POST"]),
                Rule("/api/list-models", endpoint="list_models", methods=["GET"]),
                Rule("/api/model-metadata", endpoint="get_model_metadata", methods=["GET"]),
                Rule("/api/model-metadata", endpoint="post_model_metadata", methods=["POST"]),
                Rule("/api/model-display-name", endpoint="post_model_display_name", methods=["POST"]),
                Rule("/api/upload-file", endpoint="upload_file", methods=["POST"]),
            ]
        )

    def _task_device(self):
        """The device of a task, resolved when the request starts it."""
        return resolve_device(self.device)

    # ------------------------------------------------------------------ handlers

    def on_index(self, request):
        return Response(_INDEX_HTML, mimetype="text/html")

    def on_download_filters(self, request):
        from xspect2_tpu_torch.download_models import download_test_models

        download_test_models(device=self._task_device())
        return self._json({"message": "Models downloaded."})

    def on_classification_result(self, request):
        uuid = request.args.get("uuid", "")
        result_path = get_xspect_runs_path() / f"result_{secure_filename(uuid)}.json"
        if not result_path.exists():
            return self._json(
                {"detail": "No result found for the specified uuid."}, status=404
            )
        return self._json(json.loads(result_path.read_text()))

    def on_classify(self, request):
        classification_type = request.args.get("classification_type", "")
        model = request.args.get("model", "")
        file = request.args.get("file", "")
        step = int(request.args.get("step", 1))

        input_path = get_xspect_upload_path() / file
        if not input_path.exists():
            return self._json(
                {"detail": f"File {input_path} does not exist."}, status=404
            )

        uuid = str(uuid4())
        result_path = get_xspect_runs_path() / f"result_{uuid}.json"

        if classification_type == "Genus":
            self.tasks.add_task(
                classify.classify_genus, model, input_path, result_path, step=step,
                device=self._task_device(),
            )
            return self._json({"message": "Classification started.", "uuid": uuid})
        if classification_type == "Species":
            self.tasks.add_task(
                classify.classify_species, model, input_path, result_path, step=step,
                device=self._task_device(),
            )
            return self._json({"message": "Classification started.", "uuid": uuid})
        return self._json(
            {"detail": f"Classification type {classification_type} is not implemented."},
            status=501,
        )

    def on_filter(self, request):
        filter_type = request.args.get("filter_type", "")
        genus = request.args.get("genus", "")
        input_file = request.args.get("input_file", "")
        threshold = float(request.args.get("threshold", 0.7))
        species = request.args.get("filter_species")
        step = int(request.args.get("step", 1))

        input_path = get_xspect_upload_path() / input_file
        if not input_path.exists():
            return self._json(
                {"detail": f"File {input_path} does not exist."}, status=404
            )

        uuid = str(uuid4())
        filter_output_path = get_xspect_runs_path() / f"filtered_{uuid}.fasta"
        classification_output_path = get_xspect_runs_path() / f"result_{uuid}.json"

        if filter_type == "Genus":
            self.tasks.add_task(
                filter_sequences.filter_genus,
                genus,
                input_path,
                filter_output_path,
                threshold,
                classification_output_path,
                step,
                device=self._task_device(),
            )
            return self._json({"message": "Genus filtering started.", "uuid": uuid})
        if filter_type == "Species":
            if not species:
                return self._json(
                    {"detail": "filter_species must be provided for species filtering."},
                    status=400,
                )
            self.tasks.add_task(
                filter_sequences.filter_species,
                genus,
                species,
                input_path,
                filter_output_path,
                threshold,
                classification_output_path,
                step,
                device=self._task_device(),
            )
            return self._json({"message": "Species filtering started.", "uuid": uuid})
        return self._json(
            {"detail": f"Filter type {filter_type} is not implemented."}, status=501
        )

    def on_filtering_result(self, request):
        uuid = secure_filename(request.args.get("uuid", ""))
        result_path = get_xspect_runs_path() / f"result_{uuid}.json"
        filtered_path = get_xspect_runs_path() / f"filtered_{uuid}.fasta"
        if not result_path.exists():
            return self._json(
                {"detail": "No result found for the specified uuid."}, status=404
            )
        if not filtered_path.exists():
            return self._json(
                {
                    "message": "Filtering completed, but no sequences met the criteria.",
                    "uuid": uuid,
                }
            )
        return self._json({"message": "Filtering completed successfully.", "uuid": uuid})

    def on_download_filtered(self, request):
        uuid = secure_filename(request.args.get("uuid", ""))
        filtered_path = get_xspect_runs_path() / f"filtered_{uuid}.fasta"
        if not filtered_path.exists():
            return self._json(
                {"detail": "No filtered sequences found for the specified uuid."},
                status=404,
            )
        data = filtered_path.read_bytes()
        return Response(
            data,
            mimetype="application/octet-stream",
            headers={
                "Content-Disposition": f'attachment; filename="{filtered_path.name}"'
            },
        )

    def on_train(self, request):
        genus = request.args.get("genus", "")
        svm_steps = int(request.args.get("svm_steps", 1))
        from xspect2_tpu_torch.train import train_from_ncbi

        self.tasks.add_task(train_from_ncbi, genus, svm_steps, device=self._task_device())
        return self._json({"message": "Training started."})

    def on_list_models(self, request):
        return self._json(mm.get_models())

    def on_get_model_metadata(self, request):
        model_slug = request.args.get("model_slug", "")
        try:
            return self._json(mm.get_model_metadata(model_slug))
        except ValueError as e:
            return self._json({"detail": str(e)}, status=404)

    def on_post_model_metadata(self, request):
        try:
            mm.update_model_metadata(
                request.args.get("model_slug", ""),
                request.args.get("author", ""),
                request.args.get("author_email", ""),
            )
        except ValueError as e:
            return self._json({"error": str(e)})
        return self._json({"message": "Metadata updated."})

    def on_post_model_display_name(self, request):
        try:
            mm.update_model_display_name(
                request.args.get("model_slug", ""),
                request.args.get("filter_id", ""),
                request.args.get("display_name", ""),
            )
        except ValueError as e:
            return self._json({"error": str(e)})
        return self._json({"message": "Display name updated."})

    def on_upload_file(self, request):
        file = request.files.get("file")
        if file is None:
            return self._json({"detail": "No file provided."}, status=400)
        filename = secure_filename(file.filename)
        upload_path = get_xspect_upload_path() / filename
        if not upload_path.exists():
            file.save(str(upload_path))
        return self._json({"filename": filename})

    # ------------------------------------------------------------------ wsgi plumbing

    @staticmethod
    def _json(data, status: int = 200) -> Response:
        return Response(json.dumps(data), status=status, mimetype="application/json")

    def dispatch(self, request):
        adapter = self.url_map.bind_to_environ(request.environ)
        try:
            endpoint, values = adapter.match()
            return getattr(self, f"on_{endpoint}")(request, **values)
        except NotFound:
            return self._json({"detail": "Not Found"}, status=404)
        except HTTPException as e:
            return e
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            return self._json({"detail": str(e)}, status=500)

    def __call__(self, environ, start_response):
        request = Request(environ)
        response = self.dispatch(request)
        return response(environ, start_response)


# the WSGI app on the default device (CUDA), for a WSGI server given "module:app"
app = XspectWebApp()


def serve(host: str = "0.0.0.0", port: int = 8000, device=None):
    """Serve an :class:`XspectWebApp` on ``device`` with cheroot (a
    threaded WSGI server)."""
    from cheroot.wsgi import Server

    server = Server((host, port), XspectWebApp(device))
    print(f"XspecT2-TPU web serving on http://{host}:{port}")
    try:
        server.start()
    except KeyboardInterrupt:
        server.stop()

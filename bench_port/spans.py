"""Host spans around the calls into each layer of the port.

The benchmark records them from its own files, by wrapping the port's
functions and methods for the length of a traced run
(:meth:`Spans.wrap`, a copy of ``chip_smoke.py``'s ``stopwatch`` that
also annotates the profiler's trace); nothing in the program changes.
Each wrapper adds its host-clock seconds and a call to its span's
totals.  A coarse span also opens a
``torch.profiler.record_function`` of its name while the profiler
runs, so that an idle gap of the device can be named by the span the
host was in; fine spans (one call a record, such as each record's
encoding) only add up, since an event each would swamp the trace.
"""

import time
from collections import defaultdict
from contextlib import ExitStack, contextmanager, nullcontext


class Spans:
    """Totals of named host spans: seconds and calls."""

    def __init__(self, profile: bool = False):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.profile = profile

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()

    def _region(self, name: str, coarse: bool):
        if coarse and self.profile:
            from torch.profiler import record_function

            return record_function(name)
        return nullcontext()

    @contextmanager
    def span(self, name: str, coarse: bool = True):
        t0 = time.perf_counter()
        try:
            with self._region(name, coarse):
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    @contextmanager
    def wrap(self, owner, attr: str, name: str, coarse: bool = True):
        """While active, every call of ``owner.attr`` is span ``name``."""
        inner = getattr(owner, attr)
        spans = self

        def timed_call(*args, **kwargs):
            with spans.span(name, coarse):
                return inner(*args, **kwargs)

        setattr(owner, attr, timed_call)
        try:
            yield
        finally:
            setattr(owner, attr, inner)

    @contextmanager
    def wrap_generator(self, owner, attr: str, name: str):
        """While active, each step of the generator ``owner.attr`` returns
        is span ``name`` (fine: the steps may be many)."""
        inner = getattr(owner, attr)
        spans = self

        def timed_generator(*args, **kwargs):
            it = inner(*args, **kwargs)
            while True:
                with spans.span(name, coarse=False):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item

        setattr(owner, attr, timed_generator)
        try:
            yield
        finally:
            setattr(owner, attr, inner)


# the spans that nest inside ``model`` (ProbabilisticFilterModel.predict)
MODEL_CHILDREN = ("parse", "parse_records", "encode", "prepare", "engine_reads", "engine")


@contextmanager
def port_spans(spans: Spans):
    """The benchmark's spans over the port's layers, for the classify
    facades' paths (reads and records routes, the SVM head, the result):

    - ``model``: ``ProbabilisticFilterModel.predict`` (route choice, the
      ranked hit dictionaries, the result object, and the layers below;
      its self time, less the spans below, is the model layer's: a span
      around each record's dictionary would cost more than it measures
      on the reads route);
    - ``parse``: ``native.parse_file`` (the reads route's parse, and the
      records route's check of the route);
    - ``parse_records``: each batch of records the records route reads;
    - ``encode``: ``dna.encode`` of each record (fine);
    - ``prepare``: ``prepare_batch`` of the records route;
    - ``engine_reads``: ``_count_reads`` (the reads route's pack, upload,
      K1 + K2 and fetch);
    - ``engine``: ``DeviceQueryEngine.count_hits`` (the records route's
      upload, K4 + K3 and fetch);
    - ``svm_head``: ``SVMHead.predict`` (K11 and its fetch);
    - ``result_json``: ``ModelResult.save``.
    """
    from xspect2_tpu_torch import native
    from xspect2_tpu_torch.core import dna
    from xspect2_tpu_torch.models import filter_model
    from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
    from xspect2_tpu_torch.models.result import ModelResult
    from xspect2_tpu_torch.models.svm_head import SVMHead
    from xspect2_tpu_torch.ops.query import DeviceQueryEngine

    with ExitStack() as stack:
        for owner, attr, name, coarse in (
            (ProbabilisticFilterModel, "predict", "model", True),
            (native, "parse_file", "parse", True),
            (dna, "encode", "encode", False),
            (filter_model, "prepare_batch", "prepare", True),
            (ProbabilisticFilterModel, "_count_reads", "engine_reads", True),
            (DeviceQueryEngine, "count_hits", "engine", True),
            (SVMHead, "predict", "svm_head", True),
            (ModelResult, "save", "result_json", True),
        ):
            stack.enter_context(spans.wrap(owner, attr, name, coarse))
        stack.enter_context(
            spans.wrap_generator(ProbabilisticFilterModel, "_iter_record_batches", "parse_records"))
        yield spans

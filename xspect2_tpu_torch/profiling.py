"""Profiling: per-phase wall timers and a device trace.

Named phases accumulate wall time and call counts; :func:`trace` records
a ``torch.profiler`` trace of the host and, when the process has a CUDA
card, of its kernels.  While a ``torch.profiler`` profile records (this
module's :func:`trace` or any other), each phase is also a
``record_function`` of its name: a ``user_annotation`` event on the
timeline of the kernels and copies.

The classify path's phases are named ``<layer>.<step>`` and nest
strictly on one thread, so a phase's self time is its seconds less its
children's:

- ``classify.request`` (a facade call), holding ``classify.load``
  (``load_cached``; ``model.load`` under it on a miss),
  ``classify.predict`` (a model's ``predict``) and ``result.save``;
- under ``classify.predict``: ``wire.parse`` (``native.parse_file``: a
  file's one parse, which the reads route and a FASTA file's records
  route build on), the records route's ``wire.read`` (a batch pulled
  from the line reader or cut from the parse, and the scan of the
  file's bytes that lets the parse serve), ``wire.encode`` (a batch's
  flat codes) and ``wire.prepare`` (the rest of its batch), the
  reads route's ``engine.reads`` (pack, upload, launches and fetch, with
  ``query.pack`` and ``engine.reads.fetch`` under it), ``model.hits``
  (the ranked hit dictionaries, once a batch or file), and the SVM
  model's ``svm.scores`` and ``svm.head``;
- under ``classify.predict`` for an MLST model: ``mlst.read``,
  ``mlst.split`` (each record's one ``dna.encode`` and each length
  group's piece layout), ``mlst.prepare``, ``mlst.query`` (``query.pack``
  under it), ``mlst.fetch``, ``mlst.rank`` and ``mlst.lookup``
  (``models/mlst_model.py``);
- under ``result.save``: ``result.scores`` (not for an MLST result),
  ``result.encode`` (the JSON encoder) and ``result.write`` (the
  directory, then the file);
- the engine's ``query.pack``, ``query.dispatch`` and ``query.sync``
  (as the JAX package's engine records them);
- ``model.load`` (a model read from disk: a cache miss, or no cache) and
  ``kernels.build`` (a round of kernel libraries compiled), which a warm
  process no longer records;
- the counters ``wire.records_from_parse`` and
  ``wire.records_from_reader`` (:func:`add` with 0.0 seconds): a file
  whose records route took its batches from the parse or from the line
  reader; ``mlst.length_group`` (a K5 dispatch), ``mlst.genome_group``
  (a group of genomes an MLST ``predict`` flushed) and
  ``mlst.genome_encode`` (a record the MLST model encoded).

Usage::

    from xspect2_tpu_torch.profiling import phase, report, trace
    with phase("parse"):
        ...
    with trace("traces/run"):   # TensorBoard / Chrome trace (*.pt.trace.json)
        ...
    print(report())

A phase measures the host's wall clock only: it adds no synchronization,
so the time of work the card runs asynchronously lands in the phase
that waits for it (``query.sync`` for a query's hit counts).
"""

import contextlib
import json
import time
from collections import defaultdict

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


_NO_REGION = contextlib.nullcontext()


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall time under a named phase.  While a profile
    records, the phase is also a ``record_function`` of its name, whose
    own cost stays out of the phase's seconds."""
    with record_function(name) if _profiler_enabled() else _NO_REGION:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _totals[name] += time.perf_counter() - t0
            _counts[name] += 1


def add(name: str, seconds: float) -> None:
    """Record an externally measured duration, or with 0.0 count an
    event.  While a profile records, a call is also an empty
    ``record_function`` of its name."""
    if _profiler_enabled():
        with record_function(name):
            pass
    _totals[name] += seconds
    _counts[name] += 1


def reset() -> None:
    _totals.clear()
    _counts.clear()


def report() -> dict:
    """Phase totals: {phase: {seconds, calls}}."""
    return {
        name: {"seconds": round(_totals[name], 6), "calls": _counts[name]}
        for name in sorted(_totals)
    }


def report_json() -> str:
    return json.dumps(report(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed work, written into
    ``log_dir`` as a TensorBoard trace (``<worker>.<ns>.pt.trace.json``,
    Chrome trace format): host activity, and the CUDA kernels when the
    process has a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield

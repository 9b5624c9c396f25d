"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the model's settings and sizes) and a traffic
mix (``traffic/<name>.json``: the files one client sends).  The
configuration's ``facade`` names its kind of model: the module
``kinds/<facade>.py`` (interface: ``kinds/species.py``), which gives
every step that depends on the kind.  A run:

1. set-up: makes the genomes from the seed, writes the training files,
   trains the cell's model through the port's own ``fit`` (as
   ``train_from_directory`` does) under an ``XSPECT_DATA_ROOT`` in the
   run's temporary directory, writes a pool of distinct input files, and
   warms the facade up on one full pass of the pool, so that every
   file's shapes have run once before the window;
2. the window: one client sends pool files in turn to the kind's
   classify facade, back to back, while less than ``seconds`` have
   passed; the window ends when the last file started has its result
   JSON written;
3. the check: the program's state freed, the kind's plain reference
   works the model out again from the genomes and judges a sample of
   the window's result JSON files, drawn from the seed, the one with the
   most records in it, and, where the reference gives decisions (an SVM
   head), the decisions the kind captured from the loaded model after
   the window on the rows the timed path handed it;
4. the result: the cell's metrics, each read by ``metrics/<name>.py``.

A traced run (``trace``) wraps the port's layers in host spans
(:mod:`bench_port.spans`) and holds the window in one ``torch.profiler``
trace (:mod:`bench_port.tracing`) for the per-layer metrics.
"""

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback
from contextlib import ExitStack, nullcontext, redirect_stdout
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from bench_port import roofline, synthetic
from bench_port.measure import Request, Run

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
KINDS = BENCH / "kinds"
FORBIDDEN = ("jax", "jaxlib", "flax", "xspect2_tpu")
# the widest gap of a sampled file's head decision from the reference's
# float64 one: sound runs read ~1e-15, the float32 control ~1e-7 (PERF.md)
HEAD_GAP_LIMIT = 1e-10


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


# ------------------------------------------------------------------ the plan


def load_plan(workload: str, spec: dict | None = None, overrides: dict | None = None) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration
    and traffic files; ``overrides`` (tests) replaces keys of either."""
    if spec is None:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text(encoding="utf-8"))
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text(encoding="utf-8"))
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    kind = load_kind(config["facade"])
    config["class_names"] = kind.class_names(config)
    return dict(spec=spec, cell=cell, config=config, traffic=traffic, kind=kind)


def load_kind(name: str):
    """The kind of model ``kinds/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"bench_port_kind_{name}", KINDS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_entries(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` the per-layer metrics that list it (or, listing no
    cells, move one of its end-to-end metrics)."""
    mine = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return mine
    moved = {m["name"] for m in mine}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metric(name: str, run: Run):
    """``metrics/<name>.py``'s ``read(run)``."""
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


# ------------------------------------------------------------------ set-up


@dataclass
class PoolFile:
    """One input file of the pool, and what the reference needs of it."""

    path: Path
    ids: list
    lengths: list
    counted: int
    records: list  # code arrays: a read or a contig each

    @property
    def n_records(self) -> int:
        return len(self.ids)


def make_pool(traffic: dict, genomes: np.ndarray, rng: np.random.Generator, pool_dir: Path, k: int) -> list:
    """The traffic's pool of distinct input files.  Every seed gets the
    same sizes (contig counts spread evenly over the range) in another
    order, so a seed changes which work is done, not how much."""
    pool_dir.mkdir(parents=True)
    step = traffic["step"]
    n_files = traffic["pool_files"]
    pool = []
    if traffic["kind"] == "reads":
        n, length = traffic["reads_per_file"], traffic["read_len"]
        foreign = synthetic.make_genomes(rng, 1, traffic["foreign_genome_bp"])
        n_foreign = int(round(n * traffic["foreign_share"]))
        # an isolate's run: one genome a file (classes in turn, order from
        # the seed); otherwise reads of every genome in each file
        classes = rng.permutation(np.arange(n_files) % len(genomes))
        for f in range(n_files):
            source = genomes[classes[f] : classes[f] + 1] if traffic["isolate"] else genomes
            reads = synthetic.sequencing_run(source, foreign, n, n_foreign, rng, length,
                                             traffic["n_rate"], traffic["subst_rate"])
            path = pool_dir / f"reads{f:02d}.fastq"
            ids = synthetic.write_fastq(path, reads, f"f{f:02d}r")
            pool.append(PoolFile(path, ids, [length] * n, roofline.counted_read_kmers(reads, k, step), list(reads)))
    elif traffic["kind"] == "assemblies":
        lo, hi = traffic["contigs"]
        sizes = np.round(np.linspace(lo, hi, n_files)).astype(int)[rng.permutation(n_files)]
        classes = rng.permutation(np.arange(n_files) % len(genomes))
        for f in range(n_files):
            contigs = synthetic.simulate_assembly(genomes[classes[f]], rng, f"a{f:02d}", int(sizes[f]),
                                                  traffic["subst"], traffic["gaps"])
            path = pool_dir / f"asm{f:02d}.fasta"
            synthetic.write_fasta(path, contigs)
            records = [c for _, c in contigs]
            pool.append(PoolFile(path, [i for i, _ in contigs], [len(c) for c in records],
                                 roofline.counted_kmers(records, k, step), records))
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return pool


def run_requests(call, pool: list, out_dir: Path, device, seconds: float | None, count: int | None = None,
                 capture=None):
    """Send pool files in turn to ``call``, back to back: ``count`` of them,
    or while less than ``seconds`` have passed.  Returns the requests;
    the window ends with the last one's result written.  ``capture``
    (the kind's) is told which request is running."""
    out_dir.mkdir(parents=True, exist_ok=True)
    requests = []
    start = time.perf_counter()
    i = 0
    while (i < count) if count is not None else (time.perf_counter() - start < seconds):
        pf = pool[i % len(pool)]
        if capture is not None:
            capture.request = i
        t0 = time.perf_counter()
        ok, error = True, ""
        try:
            call(pf.path, out_dir / f"{i:05d}.json", device)
        except Exception:  # a failed request is counted, and the window goes on
            ok, error = False, traceback.format_exc()
            log(f"request {i} ({pf.path.name}) failed:\n{error}")
        requests.append(Request(i, i % len(pool), pf.n_records, t0, time.perf_counter(), ok, error))
        i += 1
    return requests


# ------------------------------------------------------------------ the check


def head_gap(got, want) -> float:
    """The widest gap of one file's head decisions from the reference's."""
    return float(np.max(np.abs(np.asarray(got, dtype=np.float64) - want)))


def sample_requests(requests: list, size: int, seed: int) -> list:
    """``size`` completed requests drawn from the seed, the one with the
    most records first."""
    done = [r for r in requests if r.ok]
    if not done:
        return []
    order = [done[i] for i in np.random.default_rng([seed, 2]).permutation(len(done))]
    longest = max(order, key=lambda r: r.records)
    return [longest] + [r for r in order if r is not longest][: size - 1]


def judge(plan: dict, ref, pool: list, sample: list, out_dir: Path, decisions: dict | None = None) -> dict:
    """Wrong answers in the sampled result files against the kind's
    reference ``ref``, and, where it gives decisions, the widest gap of
    ``decisions`` (by request index) from its float64 ones; a sampled file
    whose decisions are missing is one wrong answer more."""
    step = plan["traffic"]["step"]
    wrong = checked = tied = 0
    gap = None
    for r in sample:
        pf = pool[r.pool_index]
        path = out_dir / f"{r.index:05d}.json"
        got = json.loads(path.read_text(encoding="utf-8")) if path.exists() else {}
        want, want_dec = ref.answers(pf, step)
        if want_dec is not None:
            gap = 0.0 if gap is None else gap
            if decisions is None or r.index not in decisions:
                log(f"{path.name} ({pf.path.name}): no head decisions")
                wrong += 1
            else:
                gap = max(gap, head_gap(decisions[r.index], want_dec))
        diff = ref.differences(got, want)
        if diff:
            log(f"{path.name} ({pf.path.name}): {len(diff)} wrong answers, first {diff[:3]}")
        wrong += len(diff)
        checked += pf.n_records + 1
        tied += len(want.get("_prediction_any", ())) > 1
    if tied:
        log(f"{tied} sampled files' head decisions are tied: any label a tie could make win is right")
    return dict(wrong=wrong, checked=checked, files=len(sample), tied=tied, head_gap=gap)


def checks_of(verdict: dict, failed: int) -> dict:
    """The numbers compared, each beside its limit: ``wrong_answers`` (an
    answer that never came is a wrong one: a failed request's, or the
    sample's when no request completed) and, where the reference gave
    decisions, ``head_gap``."""
    wrong = verdict["wrong"] + failed + (verdict["files"] == 0)
    checks = {"wrong_answers": {"value": wrong, "limit": 0}}
    if verdict["head_gap"] is not None:
        checks["head_gap"] = {"value": verdict["head_gap"], "limit": HEAD_GAP_LIMIT}
    return checks


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# ------------------------------------------------------------------ one run


def set_up(plan: dict, seed: int, device, work_dir: Path) -> dict:
    """Everything before the window but the warm-up: ``{training, pool}``
    (``training``: the kind's inputs for its reference); the model
    trained and saved."""
    config, traffic = plan["config"], plan["traffic"]
    rng = np.random.default_rng(seed)
    t0 = time.time()
    genomes, training, train_fn = plan["kind"].make_training(config, rng, work_dir / "train")
    t1 = time.time()
    trained = train_fn(device)
    gc.collect()
    t2 = time.time()
    pool = make_pool(traffic, genomes, rng, work_dir / "pool", config["k"])
    t3 = time.time()
    log(f"set-up: data {t1 - t0:.2f} s, training {t2 - t1:.2f} s ({trained}), "
        f"pool of {len(pool)} files {t3 - t2:.2f} s")
    return dict(training=training, pool=pool)


def free_program_state(device) -> None:
    """Drop the facade's cached models and their device tables."""
    import torch
    from xspect2_tpu_torch import model_cache

    model_cache.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def device_record(device, trace_summary=None) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        rec = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))
    else:
        rec = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    if trace_summary is not None:
        rec.update(busy_s=trace_summary.busy_s, window_s=trace_summary.window_s)
    return rec


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             work_root: Path | None = None) -> dict:
    """One run of the cell: the result line's object.  ``t_start`` is the
    process's start on the host clock (``time.time()``)."""
    import torch

    from bench_port import spans as spans_mod
    from bench_port import tracing

    config, traffic, cell, kind = plan["config"], plan["traffic"], plan["cell"], plan["kind"]
    with tempfile.TemporaryDirectory(prefix="bench_port-", dir=work_root) as tmp:
        work_dir = Path(tmp)
        os.environ["XSPECT_DATA_ROOT"] = str(work_dir / "xspect-data")
        with redirect_stdout(sys.stderr):
            state = set_up(plan, seed, device, work_dir)
            pool = state["pool"]
            call = kind.facade(config)
            spans = spans_mod.Spans(profile=trace)
            capture = kind.capture(config)
            with ExitStack() as stack:
                if capture is not None:
                    stack.enter_context(capture)
                if trace:
                    stack.enter_context(spans_mod.port_spans(spans))
                run_requests(call, pool, work_dir / "warmup", device, None, len(pool))
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
                from xspect2_tpu_torch import profiling

                spans.reset()
                profiling.reset()
                summary = None
                trace_path = work_dir / "trace.json"
                if trace:
                    from torch.profiler import ProfilerActivity, profile, record_function

                    activities = [ProfilerActivity.CPU]
                    if torch.device(device).type == "cuda":
                        activities.append(ProfilerActivity.CUDA)
                    prof = stack.enter_context(profile(activities=activities))
                # set-up's writes flushed and its objects out of the collector's
                # way, so that neither lands in the window
                os.sync()
                gc.collect()
                gc.freeze()
                w0 = time.time()
                cpu0 = time.process_time()
                with record_function(tracing.WINDOW) if trace else nullcontext():
                    requests = run_requests(call, pool, work_dir / "out", device, seconds, capture=capture)
                window_s = requests[-1].t1 - requests[0].t0
                # a slow window that used as much CPU as a fast one was slowed by the host
                log(f"cpu: this process {time.process_time() - cpu0:.2f} s in the {window_s:.2f} s window")
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
                phases = profiling.report()
            if trace:
                prof.export_chrome_trace(str(trace_path))
                summary = tracing.summarize(trace_path)
            gc.unfreeze()
            dev = device_record(device, summary)
            # the sample's decisions from the loaded model, then the
            # program's state freed
            sample = sample_requests(requests, traffic["sample_files"], seed)
            decisions = capture.decisions(sample) if capture is not None else None
            free_program_state(device)

            # the check, after the window, the peak read and the program's state freed
            t_ref = time.time()
            ref = kind.reference(plan, state["training"], device)
            t_judge = time.time()
            verdict = judge(plan, ref, pool, sample, work_dir / "out", decisions)
            del ref
            log(f"check: {verdict['files']} sampled files, {verdict['checked']} answers; reference "
                f"{t_judge - t_ref:.2f} s to build, {time.time() - t_judge:.2f} s to judge")

        failed = sum(not r.ok for r in requests)
        done = [r for r in requests if r.ok]
        work = {traffic["work"]: sum(r.records if traffic["kind"] == "reads" else 1 for r in done)}
        run = Run(setup_s=w0 - t_start, window_s=window_s, requests=requests, work=work,
                  spans=dict(spans.seconds), span_calls=dict(spans.calls), phases=phases, trace=summary)
        if trace:
            run.bounds.update(kind.bounds(plan, state, done))
        metrics = {}
        for m in metric_entries(plan["spec"], cell["name"], trace):
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        each = sorted(r.t1 - r.t0 for r in requests)
        log(f"window: {len(requests)} requests ({failed} failed), {work}, {window_s:.3f} s; a request "
            f"{each[0]:.3f} s at least, {each[len(each) // 2]:.3f} median, {each[-1]:.3f} at most; "
            f"by tenths of the window: "
            + " ".join(f"{np.median([r.t1 - r.t0 for r in part]):.3f}"
                       for part in np.array_split(np.array(requests, dtype=object), 10) if len(part)))
        if trace and run.request_p95_ms() is not None:
            log(f"request_p95_ms: p95 of {len(done)} requests")
        log(f"check: {verdict['checked']} answers in {verdict['files']} sampled result files "
            f"of {len(done)} completed, {failed} requests failed")
        checks = checks_of(verdict, failed)
        correct = is_correct(checks)
        result = {"correct": correct, "attempted": len(requests), "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace:
            ops = sorted(summary.device_ops.items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                                   "idle_gaps": [[n, s] for n, s in summary.idle_gaps[:10]]}
        for name, c in checks.items():
            log(f"check {name}: {c['value']} (limit {c['limit']})")
        result["checks"] = checks
        return result

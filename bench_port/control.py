"""The check's control readings, on the card, at a cell's own size.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds 10 [--device cuda]

For each seed, in one process: the cell's set-up, a short window of the
program at the cell's load, and then, on the same sampled result files,
the check's numbers (``wrong_answers`` and, where the kind's reference
gives decisions, ``head_gap``) three times over: for the program (the
lower readings); for the control, the kind's reference put in the
program's place with one probe fewer a k-mer (``num_hashes - 1``: the
cheaper lookup a later change might take, which breaks the stated
false-positive rate), an SVM head fitted on its own scores; and, where
it gives decisions, for the head's control, the reference put in the
program's place with its head evaluated in float32, the precision below
the head's stated float64.  Each side's answers are written as result
files and judged by the harness's own ``judge``.  The benchmark's own
runs do not run this.  Prints one JSON line a seed.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from contextlib import nullcontext, redirect_stdout
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import harness  # noqa: E402


def in_programs_place(ref, plan: dict, pool: list, sample: list, out_dir: Path, dtype=np.float64) -> dict:
    """Write what ``ref`` answers for the sampled files, in ``dtype``, as
    the program's result files; returns its decisions by request."""
    out_dir.mkdir(parents=True)
    decisions = {}
    for r in sample:
        res, dec = ref.answers(pool[r.pool_index], plan["traffic"]["step"], dtype)
        (out_dir / f"{r.index:05d}.json").write_text(json.dumps(res), encoding="utf-8")
        if dec is not None:
            decisions[r.index] = dec
    return decisions


def side(plan, ref, pool, sample, out_dir, decisions, failed=0) -> dict:
    verdict = harness.judge(plan, ref, pool, sample, out_dir, decisions)
    checks = harness.checks_of(verdict, failed)
    return {"correct": harness.is_correct(checks), **{k: c["value"] for k, c in checks.items()}}


def readings(plan: dict, seed: int, seconds: float, device, work_root=None) -> dict:
    """``{"program", "control", "head_float32", ...}`` for one seed, each
    ``{"correct", "wrong_answers"[, "head_gap"]}``."""
    config, traffic, kind = plan["config"], plan["traffic"], plan["kind"]
    with tempfile.TemporaryDirectory(prefix="bench_port-control-", dir=work_root) as tmp:
        work_dir = Path(tmp)
        os.environ["XSPECT_DATA_ROOT"] = str(work_dir / "xspect-data")
        with redirect_stdout(sys.stderr):
            state = harness.set_up(plan, seed, device, work_dir)
            pool, call = state["pool"], kind.facade(config)
            capture = kind.capture(config)
            with capture if capture is not None else nullcontext():
                harness.run_requests(call, pool, work_dir / "warmup", device, None, len(pool))
                requests = harness.run_requests(call, pool, work_dir / "out", device, seconds, capture=capture)
            sample = harness.sample_requests(requests, traffic["sample_files"], seed)
            decisions = capture.decisions(sample) if capture is not None else None
            harness.free_program_state(device)
            ref = kind.reference(plan, state["training"], device)
            ctrl = kind.reference(plan, state["training"], device, probes=config["num_hashes"] - 1)
            failed = sum(not r.ok for r in requests)
            out = dict(seed=seed, requests=len(requests), files=len(sample),
                       program=side(plan, ref, pool, sample, work_dir / "out", decisions, failed))
            ctrl_dec = in_programs_place(ctrl, plan, pool, sample, work_dir / "control")
            out["control"] = side(plan, ref, pool, sample, work_dir / "control", ctrl_dec)
            if ctrl_dec:
                dec32 = in_programs_place(ref, plan, pool, sample, work_dir / "head32", np.float32)
                out["head_float32"] = side(plan, ref, pool, sample, work_dir / "head32", dec32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = harness.load_plan(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = readings(plan, seed, args.seconds, args.device)
        out["seconds"] = time.time() - t0
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once on this machine's card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic
mixes and metrics are in ``BENCHMARK.json``; ``bench_port/harness.py``
says what a run does.  The last line of standard output is the result:
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}``.  Everything else goes to standard error, and the numbers
the check compared, each beside its limit, are its last lines.  Exits
non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), or when JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or a library could keep sits at a fixed path
# inside the checkout (build/ is ignored by git), so a second run finds it
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench_port" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench_port" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import xspect2_tpu_torch  # noqa: F401  the system under test: without it there is no run
    from bench_port import harness

    plan = harness.load_plan(args.workload)
    chips = plan["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"this cell needs {chips} CUDA card(s); found {found}: no result")
        return 3
    result = harness.run_cell(plan, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"JAX or the JAX package was loaded: {loaded}: no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


def with_fixed_hash_seed() -> float:
    """Start this command once more under one fixed string-hash seed, so
    that every run lays its dictionaries out alike (the port's host path
    is dictionaries and JSON); returns the first start's time."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = {**os.environ, "PYTHONHASHSEED": "0", "BENCH_PORT_STARTED": repr(T_START)}
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    return float(os.environ.pop("BENCH_PORT_STARTED", repr(T_START)))


if __name__ == "__main__":
    T_START = with_fixed_hash_seed()
    sys.exit(main())

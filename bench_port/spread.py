"""The spread of a cell's runs, as the bounds in ``BENCHMARK.json`` are set.

    python3 bench_port/spread.py RESULTS [RESULTS ...]

Each ``RESULTS`` file holds one set of runs: result lines (the last line
of each run's standard output), one a line.  For each metric and set it
prints the median, the spread (the distance between the first and the
third quartile, as ``statistics.quantiles(values, n=4)`` gives them, over
the median) and the values; then the wider spread of the sets, the bound
five times it would give (at least 1%), the mean of the sets' spreads
each without its run farthest from the median, and the median of the
second set against the first's.
"""

import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> list:
    """``values`` without the one farthest from their median."""
    mid = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - mid))
    return [v for i, v in enumerate(values) if i != far]


def main(paths) -> int:
    sets = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            sets.append([json.loads(line) for line in f if line.strip().startswith("{")])
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        rows = []
        for runs in sets:
            values = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if len(values) >= 2:
                rows.append((statistics.median(values), spread(values), values))
        for i, (med, sp, values) in enumerate(rows):
            print(f"{name} set {i + 1}: median {med!r}, spread {sp:.4%}, values {values}")
        if rows:
            widest = max(sp for _, sp, _ in rows)
            drift = rows[-1][0] / rows[0][0] - 1
            # a bound under twice this mean is too tight for these runs
            kept = statistics.mean(spread(trimmed(values)) for _, _, values in rows if len(values) >= 3)
            print(f"{name}: widest spread {widest:.4%}, five times it {max(0.01, 5 * widest):.4f}, "
                  f"mean of the sets' spreads each without its farthest run {kept:.4%}, "
                  f"last set's median against the first's {drift:+.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

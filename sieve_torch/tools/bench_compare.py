"""Diff the two newest benchmark result files and gate on regressions.

The port of the reference's tools/bench_compare.py, with the same rules,
the same output and the same exit codes; only the ``--dir`` default is
found from this file's own path (the repository root).

A round writes one ``BENCH_r<NN>.json`` (and one ``MULTICHIP_r<NN>.json``)
into the directory. Each BENCH file carries the benchmark process's
``rc``, the ``tail`` of its output (one JSON metric line per benchmark:
``{"metric": ..., "value": ..., "unit": "values/s/chip", ...}``, as
``python -m sieve_torch.bench`` prints them), and the last metric
re-parsed under ``parsed``. This tool pairs the two newest rounds by
metric name and prints the delta for each; it exits nonzero when:

- a throughput metric (``unit == "values/s/chip"``, ``"qps"`` for request
  throughput, or ``"cold_throughput"`` for the mesh cold-drain values/s)
  dropped by more than ``--threshold`` (default 10%);
- a latency metric (``unit == "ms_p95"``) *increased* by more than the
  same threshold (lower is better);
- an ``overhead_ratio`` metric exceeds its ABSOLUTE ceiling (1.05; 1.10
  for the lock sanitizer), applied even to a metric's first round, since
  a ceiling needs no baseline;
- a ``bytes_per_member`` metric exceeds its absolute wire-cost ceiling
  (48 B) or grows past the threshold round-over-round;
- a ``scaling_ratio`` metric falls below the ABSOLUTE 0.7 floor, but only
  when the record's ``cpus`` covers its ``procs_max``: with fewer cores
  the extra processes time-slice and the ratio measures the scheduler;
- a metric of the older round is gone from the newest;
- the newest round itself failed (``rc != 0``), or the newest MULTICHIP
  round is neither ``ok`` nor ``skipped``.

Round order comes from the ``_r<NN>`` filename suffix, NOT mtime — a
re-checkout or ``touch`` must not reorder history.

Usage: python -m sieve_torch.tools.bench_compare [--dir DIR] [--threshold 0.10]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ROUND_RE = re.compile(r"_r(\d+)\.json$")
# absolute overhead budgets (gates, not round-over-round diffs): every
# ``overhead_ratio`` metric must stay under its ceiling. Default 1.05 (the
# trace plane and the flight recorder); the lock sanitizer gets 1.10 — it
# wraps every lock in the plane and is a debug mode, not an always-on tax.
_DEFAULT_OVERHEAD_CEILING = 1.05
_OVERHEAD_CEILINGS = {
    "service_lock_debug_overhead_ratio": 1.10,
}
# absolute wire-cost budgets: a ``bytes_per_member`` metric must stay
# under its ceiling regardless of history — the binary batch encoding
# costs ~27 B/member (17 sent + 9 received) against ~70 for JSON, so 48
# flags any drift back toward text-sized frames.
_DEFAULT_BYTES_CEILING = 48.0
_BYTES_CEILINGS: dict[str, float] = {}
# absolute scaling floor: a ``scaling_ratio`` metric (q4 / (4 * q1) for
# 4-process serving) must keep >= 0.7x of the single-process qps per added
# process — enforced only when the record says the host has at least
# ``procs_max`` CPUs; with fewer cores the processes time-slice and the
# ratio is reported but not gated.
_DEFAULT_SCALING_FLOOR = 0.7
_SCALING_FLOORS: dict[str, float] = {}


def find_rounds(bench_dir: str, prefix: str) -> list[tuple[int, str]]:
    """(round, path) pairs for ``<prefix>_r<NN>.json``, round ascending."""
    rounds = []
    for path in glob.glob(os.path.join(bench_dir, f"{prefix}_r*.json")):
        m = _ROUND_RE.search(os.path.basename(path))
        if m:
            rounds.append((int(m.group(1)), path))
    rounds.sort()
    return rounds


def extract_metrics(doc: dict) -> dict[str, dict]:
    """Metric-name -> record from a BENCH round document.

    Metrics live as JSON lines inside the ``tail`` (one per benchmark);
    ``parsed`` duplicates the last one and covers old rounds whose tail
    was truncated past the metric lines.
    """
    metrics: dict[str, dict] = {}
    for line in doc.get("tail", "").splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "metric" in rec and "value" in rec:
            metrics[rec["metric"]] = rec
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed:
        metrics.setdefault(parsed["metric"], parsed)
    return metrics


def compare(
    old: dict[str, dict], new: dict[str, dict], threshold: float
) -> tuple[list[str], list[str]]:
    """(report lines, regression descriptions) for old -> new."""
    lines: list[str] = []
    regressions: list[str] = []
    new_names: list[str] = []
    for name in sorted(old.keys() | new.keys()):
        o, n = old.get(name), new.get(name)
        # absolute ceilings apply regardless of history — including a
        # metric's very first round, where there is no old value to diff
        ceiling = _OVERHEAD_CEILINGS.get(name, _DEFAULT_OVERHEAD_CEILING)
        if n is not None and n.get("unit") == "overhead_ratio" \
                and float(n["value"]) > ceiling:
            regressions.append(
                f"{name}: {float(n['value']):.4g} exceeds the absolute "
                f"{ceiling} overhead ceiling"
            )
            lines.append(
                f"  {name}: {float(n['value']):.4g} overhead_ratio  "
                f"REGRESSION (> {ceiling} absolute ceiling)"
            )
            continue
        bceiling = _BYTES_CEILINGS.get(name, _DEFAULT_BYTES_CEILING)
        if n is not None and n.get("unit") == "bytes_per_member" \
                and float(n["value"]) > bceiling:
            regressions.append(
                f"{name}: {float(n['value']):.4g} exceeds the absolute "
                f"{bceiling} bytes/member ceiling"
            )
            lines.append(
                f"  {name}: {float(n['value']):.4g} bytes_per_member  "
                f"REGRESSION (> {bceiling} absolute ceiling)"
            )
            continue
        if n is not None and n.get("unit") == "scaling_ratio":
            # absolute per-process scaling floor — only meaningful when the
            # host has a core per process; otherwise the extra processes
            # time-slice one core and the ratio measures the scheduler, so
            # report without gating
            floor = _SCALING_FLOORS.get(name, _DEFAULT_SCALING_FLOOR)
            cpus = int(n.get("cpus") or 0)
            procs_max = int(n.get("procs_max") or 0)
            gated = procs_max > 0 and cpus >= procs_max
            if gated and float(n["value"]) < floor:
                regressions.append(
                    f"{name}: {float(n['value']):.4g} below the absolute "
                    f"{floor} per-process scaling floor "
                    f"(cpus={cpus} >= procs_max={procs_max})"
                )
                lines.append(
                    f"  {name}: {float(n['value']):.4g} scaling_ratio  "
                    f"REGRESSION (< {floor} absolute floor)"
                )
                continue
            if not gated:
                lines.append(
                    f"  {name}: {float(n['value']):.4g} scaling_ratio  "
                    f"(ungated: cpus={cpus} < procs_max={procs_max})"
                )
                continue
        if o is None:
            # a metric present only in the newest round is reported
            # explicitly (it becomes next round's baseline), never
            # silently ignored
            new_names.append(name)
            lines.append(
                f"  {name}: NEW metric (no previous round) "
                f"{n['value']:.4g} {n.get('unit', '')}"
            )
            continue
        if n is None:
            lines.append(f"  {name}: GONE (was {o['value']:.4g})")
            regressions.append(f"{name} disappeared from the newest round")
            continue
        ov, nv = float(o["value"]), float(n["value"])
        delta = (nv - ov) / ov if ov else 0.0
        unit = n.get("unit", "")
        verdict = ""
        if unit == "values/s/chip" and delta < -threshold:
            # throughput: higher is better, gate on drops
            verdict = f"  REGRESSION (> {threshold:.0%} drop)"
            regressions.append(
                f"{name}: {ov:.4g} -> {nv:.4g} ({delta:+.1%})"
            )
        elif unit == "qps" and delta < -threshold:
            # request throughput: higher is better, gate on drops
            verdict = f"  REGRESSION (> {threshold:.0%} throughput drop)"
            regressions.append(
                f"{name}: {ov:.4g} qps -> {nv:.4g} qps ({delta:+.1%})"
            )
        elif unit == "cold_throughput" and delta < -threshold:
            # mesh cold-drain throughput: values/s through one drain
            # slice — higher is better, gate on drops
            verdict = f"  REGRESSION (> {threshold:.0%} cold-drain drop)"
            regressions.append(
                f"{name}: {ov:.4g} -> {nv:.4g} values/s ({delta:+.1%})"
            )
        elif unit == "ms_p95" and delta > threshold:
            # latency: lower is better, gate on increases
            verdict = f"  REGRESSION (> {threshold:.0%} p95 increase)"
            regressions.append(
                f"{name}: p95 {ov:.4g} ms -> {nv:.4g} ms ({delta:+.1%})"
            )
        elif unit == "bytes_per_member" and delta > threshold:
            # wire cost: lower is better, gate on increases (on top of
            # the absolute ceiling above)
            verdict = f"  REGRESSION (> {threshold:.0%} wire-cost increase)"
            regressions.append(
                f"{name}: {ov:.4g} -> {nv:.4g} bytes/member ({delta:+.1%})"
            )
        lines.append(
            f"  {name}: {ov:.4g} -> {nv:.4g} {unit} "
            f"({delta:+.1%}){verdict}"
        )
    if new_names:
        lines.append(
            f"  {len(new_names)} new metric(s) this round "
            f"(baseline from next round): {', '.join(new_names)}"
        )
    return lines, regressions


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="diff the two newest BENCH_r*.json rounds by metric "
        "name; exit nonzero on a >threshold throughput regression"
    )
    p.add_argument("--dir", default=REPO,
                   help="directory holding BENCH_r*.json (default: repo root)")
    p.add_argument("--threshold", type=float, default=0.10,
                   help="relative drop in a values/s/chip metric that "
                        "fails the gate (default 0.10)")
    args = p.parse_args(argv)

    failures: list[str] = []

    rounds = find_rounds(args.dir, "BENCH")
    if len(rounds) < 2:
        print(f"bench_compare: {len(rounds)} BENCH round(s) in "
              f"{args.dir} — need 2 to compare; nothing to gate")
        return 0

    (old_r, old_path), (new_r, new_path) = rounds[-2], rounds[-1]
    with open(old_path) as f:
        old_doc = json.load(f)
    with open(new_path) as f:
        new_doc = json.load(f)
    print(f"bench_compare: round r{old_r:02d} -> r{new_r:02d}")
    if new_doc.get("rc", 0) != 0:
        failures.append(
            f"newest BENCH round r{new_r:02d} failed (rc={new_doc['rc']})"
        )
    lines, regressions = compare(
        extract_metrics(old_doc), extract_metrics(new_doc), args.threshold
    )
    print("\n".join(lines) if lines else "  (no metrics parsed)")
    failures.extend(regressions)

    mc = find_rounds(args.dir, "MULTICHIP")
    if len(mc) >= 2:
        with open(mc[-1][1]) as f:
            mc_new = json.load(f)
        status = ("skipped" if mc_new.get("skipped")
                  else "ok" if mc_new.get("ok") else "FAILED")
        print(f"multichip r{mc[-1][0]:02d}: {status} "
              f"(n_devices={mc_new.get('n_devices')})")
        if not mc_new.get("ok") and not mc_new.get("skipped"):
            failures.append(
                f"newest MULTICHIP round r{mc[-1][0]:02d} failed "
                f"(rc={mc_new.get('rc')})"
            )

    if failures:
        for f_ in failures:
            print(f"bench_compare: FAIL: {f_}", file=sys.stderr)
        return 1
    print("bench_compare: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

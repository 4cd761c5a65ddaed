"""``python -m repro_torch.analysis`` -- the port's analysis gate.

    --check            run the registry, the policy and entry checks and
                       the kernel sources' float64 scan, and diff against
                       the committed baseline (the repository's
                       results/analysis_contracts_torch.json); exit 1 and
                       name the entry and the rule on any problem
                       [default]
    --update           re-run and rewrite the baseline (declare an
                       intentional contract change)
    --lint             run the port's AST lint over --lint-path as well
    --lint-only        run only the lint
    --only a,b,c       restrict the run to the named registry entries
    --baseline PATH    baseline file location
    --lint-path PATH   what the lint walks (default: the port's package)
    --device DEV       where the entries run (default cuda; without a
                       card that raises -- pass cpu to run them here)

``--check`` on a clean tree prints one line per contract and exits 0.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

PORT = Path(__file__).resolve().parents[1]
# the repository's results/, wherever the gate is run from
DEFAULT_BASELINE = str(PORT.parents[1] / "results"
                       / "analysis_contracts_torch.json")
BASELINE_VERSION = 1


def load_baseline(path) -> dict | None:
    p = Path(path)
    if not p.exists():
        return None
    doc = json.loads(p.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: baseline version "
                         f"{doc.get('version')!r} != {BASELINE_VERSION} "
                         f"-- re-run --update")
    return doc["contracts"]


def save_baseline(path, current: dict) -> None:
    doc = {"version": BASELINE_VERSION,
           "contracts": {n: c.to_dict() for n, c in sorted(current.items())}}
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


def main(argv=None, entries=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's program-contract checker and lint gate")
    ap.add_argument("--check", action="store_true",
                    help="check contracts against the baseline (default)")
    ap.add_argument("--update", action="store_true",
                    help="re-baseline the contracts")
    ap.add_argument("--lint", action="store_true",
                    help="also run the AST lint over --lint-path")
    ap.add_argument("--lint-only", action="store_true",
                    help="run only the lint (skip the contracts)")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated registry entry names")
    ap.add_argument("--baseline", type=str, default=DEFAULT_BASELINE)
    ap.add_argument("--lint-path", type=str, default=str(PORT))
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the entries run (default cuda)")
    args = ap.parse_args(argv)

    problems = []
    if args.lint or args.lint_only:
        from repro_torch.analysis.lint import lint_paths
        findings = lint_paths([args.lint_path])
        for f in findings:
            print(f.format())
        problems.extend(f.format() for f in findings)
        print(f"lint: {len(findings)} finding(s) over {args.lint_path}")
        if args.lint_only:
            return 1 if problems else 0

    # the registry imports the whole port -- deferred so --lint-only
    # stays fast
    from repro_torch.analysis import registry as reg
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    entries = reg.ENTRIES if entries is None else entries
    only = args.only.split(",") if args.only else None
    current = reg.trace_all(only, entries, device=device)
    for name in sorted(current):
        c = current[name]
        print(f"  {name}: collectives={c.collectives or '-'} "
              f"lanes={c.host_lanes or '-'} syncs={sum(c.syncs.values())} "
              f"f64={c.float64_sites or '-'} ops={c.n_ops} "
              f"stable={c.op_sequence_stable}")

    if args.update:
        if only:
            print("--update ignores --only (the baseline is always "
                  "complete); re-run without --only", file=sys.stderr)
            return 2
        # policy problems block an --update too: a float64 op or a host
        # copy outside the lanes cannot be baselined into legitimacy
        problems.extend(reg.run_check(current, None, entries))
        if problems:
            for m in problems:
                print(f"FAIL {m}", file=sys.stderr)
            return 1
        save_baseline(args.baseline, current)
        print(f"baseline updated: {args.baseline} "
              f"({len(current)} contracts)")
        return 0

    baseline = load_baseline(args.baseline)
    if baseline is None:
        problems.append(f"no committed baseline at {args.baseline} -- "
                        f"run --update and commit the file")
    else:
        problems.extend(reg.run_check(current, baseline, entries,
                                      partial=only is not None))
    if problems:
        for m in problems:
            print(f"FAIL {m}", file=sys.stderr)
        print(f"analysis gate: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print(f"analysis gate OK: {len(current)} contract(s) match "
          f"{args.baseline}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

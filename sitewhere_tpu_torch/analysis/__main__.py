"""swxlint CLI: `python -m sitewhere_tpu_torch.analysis` (== `swx lint`).

Exit codes: 0 clean (baselined/suppressed findings do not fail),
1 new findings (or a lint-engine crash), 2 usage error.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="swx lint",
        description="AST-based invariant checker for the platform's "
                    "concurrency, flow-control, and fault-site contracts "
                    "(docs/ANALYSIS.md)")
    p.add_argument("--root",
                   help="package directory to lint (default: the installed "
                        "sitewhere_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (json is the CI artifact)")
    p.add_argument("--baseline",
                   help="baseline JSON path (default: analysis/"
                        "baseline.json inside the package)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current NEW findings to the baseline file "
                        "(with empty reasons you must fill in) and exit 0")
    p.add_argument("--dump-registry", action="store_true",
                   help="print the literal fault-site / metric-name "
                        "inventory discovered in the tree (regeneration "
                        "aid for analysis/registry.py)")
    return p


def _dump_registry(root: Path) -> int:
    """Scan the tree for fault-site and metric literals — the inventory
    analysis/registry.py is regenerated from. Uses the SAME receiver
    filters as the FLT01/MET01 checkers, so the aid never proposes a
    name the checkers would not actually vouch for (e.g. an unrelated
    `validator.check("...")`)."""
    from sitewhere_tpu_torch.analysis.checkers_registry import (
        _receiver_last,
        is_fault_receiver,
        is_metrics_receiver,
    )

    sites: set[str] = set()
    metrics: dict[str, set[str]] = {}
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute) \
                    or not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            recv = _receiver_last(node.func)
            if node.func.attr in ("check", "acheck", "arm") \
                    and is_fault_receiver(recv):
                sites.add(arg.value)
            elif node.func.attr in ("counter", "gauge", "meter",
                                    "histogram") \
                    and is_metrics_receiver(recv):
                metrics.setdefault(arg.value.split(":", 1)[0],
                                   set()).add(node.func.attr)
    print(json.dumps({
        "fault_sites": sorted(sites),
        "metrics": {k: sorted(v) for k, v in sorted(metrics.items())},
    }, indent=2))
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


def run(args) -> int:
    """Entry shared with `swx lint` (cli.py passes its parsed namespace)."""
    from sitewhere_tpu_torch.analysis.engine import (
        Baseline,
        default_baseline_path,
        lint_package,
        package_root,
    )

    root = Path(args.root) if getattr(args, "root", None) else package_root()
    if not root.is_dir():
        print(f"swx lint: not a directory: {root}", file=sys.stderr)
        return 2
    if getattr(args, "dump_registry", False):
        return _dump_registry(root)
    baseline_path = (Path(args.baseline)
                     if getattr(args, "baseline", None)
                     else default_baseline_path(root))
    if getattr(args, "write_baseline", False):
        # baseline nothing: capture EVERY current finding as grandfathered
        report = lint_package(root, baseline_path=Path("/nonexistent"))
        Baseline.dump(report.findings, baseline_path)
        print(f"swx lint: wrote {len(report.findings)} entries to "
              f"{baseline_path} — fill in each `reason` (entries without "
              f"one are ignored)")
        return 0
    report = lint_package(root, baseline_path=baseline_path)
    if args.format == "json":
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.render_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())

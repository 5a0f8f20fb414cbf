"""ctlint — codebase-aware static analysis for cilium-tpu.

Zero-dependency (stdlib ``ast``) rule framework plus a rule set
tailored to this codebase's unwritten contracts: jit purity, lock
order, and the string registries (metric families, fault points,
stream frame kinds). ``make lint`` runs it as part of ``make check``;
``cilium-tpu lint`` and ``python -m cilium_tpu_torch.analysis`` are the CLI
faces. Rule catalog and allowlisting: docs/ANALYSIS.md.
"""

from cilium_tpu_torch.analysis.core import (
    DEFAULT_TARGET,
    Finding,
    ProjectIndex,
    RULES,
    render_json,
    render_text,
    run,
)

__all__ = ["Finding", "ProjectIndex", "RULES", "render_json",
           "render_text", "run", "run_cli"]


def run_cli(argv=None) -> int:
    """The `cilium-tpu lint` / `python -m cilium_tpu_torch.analysis` driver.
    Exit 1 on any non-allowlisted finding."""
    import argparse
    import os
    import sys

    ap = argparse.ArgumentParser(
        prog="cilium-tpu lint",
        description="codebase-aware static analysis "
                    "(docs/ANALYSIS.md)")
    ap.add_argument("targets", nargs="*", default=(),
                    help="repo-relative files/dirs "
                         f"(default: {DEFAULT_TARGET})")
    ap.add_argument("--root", default=None,
                    help="repo root (default: the package's parent)")
    ap.add_argument("--format", choices=["text", "json"],
                    default="text")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(default: all)")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="ID",
                    help="run one rule id (repeatable; combines "
                         "with --rules)")
    ap.add_argument("--changed-only", action="store_true",
                    help="report findings only for files git sees "
                         "as changed/untracked (the whole tree is "
                         "still indexed — rules are cross-file); "
                         "the pre-commit face")
    ap.add_argument("--out", default=None,
                    help="also write a JSON report here (the CI "
                         "artifact)")
    ap.add_argument("--wall-budget-ms", type=int, default=None,
                    metavar="MS",
                    help="fail (exit 1) if the whole lint run takes "
                         "longer than this many wall-clock ms — the "
                         "`make lint` latency gate (the committed "
                         "budget lives in CTLINT.json as "
                         "wall_budget_ms)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULES.items()):
            print(f"{rule}: {doc}")
        return 0
    root = args.root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    rules = [r.strip() for r in (args.rules or "").split(",")
             if r.strip()]
    rules.extend(args.rule or ())
    if rules:
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"error: unknown rule(s) {unknown} "
                  f"(--list-rules)", file=sys.stderr)
            return 2
    only_paths = None
    if args.changed_only:
        only_paths = _git_changed_paths(root)
        if only_paths is None:
            print("error: --changed-only needs a git checkout",
                  file=sys.stderr)
            return 2
        if not only_paths:
            print("ctlint: no changed files")
            return 0
    findings, suppressed = run(
        root, targets=tuple(args.targets) or (DEFAULT_TARGET,),
        rules=rules or None, only_paths=only_paths)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(render_json(findings, suppressed))
    if args.format == "json":
        print(render_json(findings, suppressed))
    else:
        print(render_text(findings, suppressed))
    if args.wall_budget_ms is not None:
        from cilium_tpu_torch.analysis.core import LAST_TIMINGS

        wall = LAST_TIMINGS.get("wall", 0.0)
        if wall > args.wall_budget_ms:
            print(f"ctlint: wall time {wall:.0f}ms exceeds budget "
                  f"{args.wall_budget_ms}ms", file=sys.stderr)
            return 1
    return 1 if findings else 0


def _git_changed_paths(root):
    """Repo-relative .py paths git reports as modified/added/
    untracked (the ``--changed-only`` filter); None when git is
    unavailable."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    paths = []
    for line in out.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:].strip()
        if " -> " in path:  # rename: take the new side
            path = path.split(" -> ", 1)[1]
        path = path.strip('"')
        if path.endswith(".py"):
            paths.append(path)
    return paths

"""ASY02: await-atomicity for ownership/placement/epoch decisions.

The stale-`mine` dual-ownership race, as build-time policy: an
async method snapshots shared mutable state into a local
(`mine = self.assigned_to_me()`), awaits (engine start, a produce, a
sleep), and then ACTS on the snapshot — but the control loop ran during
the suspension and reassigned the tenant, so two workers both believe
they own it. The decision state this codebase guards that way is a
small, named set of self-attribute roots (`assignment`, `owned`,
`epoch`, ...): the checker flags a local captured from a guarded root
(directly, or through a one-level `self.method()` call that reads one)
when it is used in a later await-segment AND the function never
re-reads or re-writes that root after ANY suspension point.

The known-fixed shape passes by construction: `FleetWorker.apply`
captures `mine` up front but re-reads `self.assignment.get(tid)` after
every await before acting — those post-await root touches are exactly
what the checker looks for. The check is function-level (any post-await
re-read of the root counts), which keeps it honest on real code at the
cost of missing interleavings a full CFG would catch — the same
precision/recall trade every checker in this suite makes.
"""

from __future__ import annotations

import ast
from typing import Iterable

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project

# the ownership/placement/epoch decision state (self-attribute roots) —
# keep in sync with docs/ANALYSIS.md when new shared decision state
# lands in the fleet layer
GUARD_ROOTS = frozenset({
    "assignment",      # fleet placement: tenant -> worker
    "owned",           # tenants this worker runs
    "prev",            # previous owners (handoff adoption gate)
    "epoch",           # placement epoch (staleness fencing)
    "placement",       # controller-side placement view
    "workers_live",    # live-worker roster
    "releases",        # (tenant, epoch) release acknowledgements
    "leases",          # lease-based ownership variants
})


def check_await_atomicity(module: Module, project: Project) -> Iterable[Finding]:
    mf = project.flow(module)
    for flow in mf.functions.values():
        if not flow.is_async or not flow.await_points:
            continue
        for name, (pos, roots, calls) in flow.captures.items():
            guarded = set(roots) & GUARD_ROOTS
            # one-level call resolution: `mine = self.assigned_to_me()`
            # captures whatever guarded roots the callee reads
            for call in calls:
                callee = project.resolve_call(module, call, flow.class_name)
                if callee is None:
                    continue
                guarded |= {r for _, r in callee.self_reads} & GUARD_ROOTS
            if not guarded:
                continue
            seg = flow.segment_of(pos)
            stale_use = next(
                (p for p in flow.loads_after(name, pos)
                 if flow.segment_of(p) > seg), None)
            if stale_use is None:
                continue  # never used across a suspension
            if all(flow.touched_after_await(root) for root in guarded):
                continue  # the decision is re-checked after awaiting
            root_desc = "/".join(f"self.{r}" for r in sorted(guarded))
            yield Finding(
                path=module.relpath, line=stale_use[0], code="ASY02",
                message=f"`{name}` snapshots {root_desc} before an await "
                        f"and is used after the suspension without the "
                        f"root being re-read — the stale-snapshot "
                        f"dual-ownership race",
                hint=f"re-read {root_desc} (or recompute the predicate) "
                     f"after each await before acting on it",
                qualname=module.qualname_at(stale_use[0]))

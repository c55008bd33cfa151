"""CAN01: cancellation-safety for committing consumer loops.

A cancellation incident class, as build-time policy. A consumer loop that
publishes per-record output AND commits offsets has two cancellation
windows, each of which this checker closes:

(a) **commit-through**: a cancellation (tenant release, engine stop)
    landing mid-batch leaves records handled-but-uncommitted — unless
    the loop commits its handled-through frontier in a `finally` (or
    hands the frontier to the stop path, FastLane style), a clean
    handoff replays them through the adopter: stored AND scored twice.
    Gate: an async function with a bus-poll record loop and a commit
    effect (a direct `.commit(...)` or a same-module callee containing
    one, e.g. `checkpoint_commit`) must wrap the loop in a `try` whose
    `finally` either calls `.commit(...)` or references a frontier
    variable (a local assigned from `.delivered_positions()`, or one
    subscript-stored with a `.offset`-derived value per record).

(b) **settled produce**: a per-record `produce`/`produce_nowait` inside
    that cancellable loop, followed by the loop's commit covering it,
    makes "was it published?" unknowable when the cancel lands inside
    the produce await — commit and a never-sent publish is lost; don't
    and the adopter re-publishes it. Such a produce must route through
    `fastlane.produce_settled` (the SENT-probe shield), an explicit
    `asyncio.shield(...)`, or carry a `_sent=` probe itself. The check
    follows ONE level of same-module calls from the loop body (the
    `self._handle(record, ...)` shape), so the finding lands on the
    produce line where a same-line disable can carry the reason.
    Produces inside `except` handlers are exempt (DLQ quarantine and
    fence-loss reporting are not part of the happy per-record path).
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from sitewhere_tpu_torch.analysis.engine import (
    Finding,
    FuncFlow,
    Module,
    Project,
    own_body,
)

_POLL_ATTRS = {"poll", "poll_nowait"}
_PRODUCE_ATTRS = {"produce", "produce_nowait"}
_SETTLED_NAMES = {"produce_settled"}


def _poll_names(fn: ast.AST) -> set[str]:
    """Variables assigned (in this function) from a bus poll call."""
    names: set[str] = set()
    for node in own_body(fn):
        if isinstance(node, ast.Assign):
            value = node.value
            if isinstance(value, ast.Await):
                value = value.value
            if isinstance(value, ast.Call) \
                    and isinstance(value.func, ast.Attribute) \
                    and value.func.attr in _POLL_ATTRS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
    return names


def _iterates_poll(loop: ast.For, poll_names: set[str]) -> bool:
    it = loop.iter
    if isinstance(it, ast.Name):
        return it.id in poll_names
    for sub in ast.walk(it):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _POLL_ATTRS:
            return True
    return False


def _commits(fn: ast.AST) -> bool:
    """Does `fn`'s own body call `.commit(...)` directly?"""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "commit" for n in own_body(fn))


def _commit_effect(flow: FuncFlow, module: Module,
                   project: Project) -> bool:
    """Direct commit, or a one-level same-module callee that commits."""
    if _commits(flow.node):
        return True
    mf = project.flow(module)
    for call in flow.calls:
        callee = project.resolve_call(module, call, flow.class_name)
        if callee is not None \
                and mf.functions.get(callee.qualname) is callee \
                and _commits(callee.node):
            return True
    return False


def _frontier_names(fn: ast.AST) -> set[str]:
    """Locals tracking a handled-through frontier: assigned from
    `.delivered_positions()`, or subscript-stored with an
    `.offset`-derived value (`handled[(t, p)] = record.offset + 1`)."""
    names: set[str] = set()
    for node in own_body(fn):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if isinstance(value, ast.Await):
            value = value.value
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Attribute) \
                and value.func.attr == "delivered_positions":
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
            continue
        uses_offset = any(isinstance(sub, ast.Attribute)
                          and sub.attr == "offset"
                          for sub in ast.walk(node.value))
        if uses_offset:
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) \
                        and isinstance(tgt.value, ast.Name):
                    names.add(tgt.value.id)
    return names


def _finally_commits_through(fn: ast.AST, frontier: set[str],
                             loop: ast.For) -> bool:
    """Is the record loop inside a `try` whose `finally` commits (or
    hands off) the handled-through frontier?"""
    loop_line = loop.lineno
    for node in own_body(fn):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        if not (node.lineno <= loop_line <= (node.end_lineno or node.lineno)):
            continue
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "commit":
                    return True
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load) \
                        and sub.id in frontier:
                    return True
    return False


def _except_spans(fn: ast.AST) -> list[tuple[int, int]]:
    """(start, end) line spans of every except handler in `fn`."""
    spans = []
    for node in own_body(fn):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                spans.append((h.lineno, h.end_lineno or h.lineno))
    return spans


def _in_spans(line: int, spans: list[tuple[int, int]]) -> bool:
    return any(a <= line <= b for a, b in spans)


def _shielded_lines(fn: ast.AST) -> set[int]:
    """Lines covered by an `asyncio.shield(...)` (or bare `shield(...)`)
    call — a produce inside one settles independently of the caller."""
    lines: set[int] = set()
    for node in own_body(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            (f.id if isinstance(f, ast.Name) else "")
        if name == "shield":
            lines.update(range(node.lineno, (node.end_lineno or node.lineno)
                               + 1))
    return lines


def _unsettled_produces(fn: ast.AST,
                        within: Optional[tuple[int, int]] = None
                        ) -> Iterable[ast.Call]:
    """Raw `.produce(...)`/`.produce_nowait(...)` calls in `fn`'s own
    body (optionally restricted to a line span) that are not settled:
    not inside a shield, no `_sent=` probe, not in an except handler."""
    spans = _except_spans(fn)
    shielded = _shielded_lines(fn)
    for node in own_body(fn):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _PRODUCE_ATTRS:
            continue
        if within is not None \
                and not (within[0] <= node.lineno <= within[1]):
            continue
        if _in_spans(node.lineno, spans) or node.lineno in shielded:
            continue
        if any(kw.arg == "_sent" for kw in node.keywords):
            continue
        yield node


def _loop_calls(loop: ast.For) -> Iterable[ast.Call]:
    """Calls lexically in the loop body (nested defs excluded)."""
    for stmt in loop.body:
        stack: list[ast.AST] = [stmt]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))


def check_cancel_safety(module: Module, project: Project) -> Iterable[Finding]:
    mf = project.flow(module)
    for flow in mf.functions.values():
        if not flow.is_async:
            continue
        fn = flow.node
        poll_names = _poll_names(fn)
        loops = [n for n in own_body(fn)
                 if isinstance(n, ast.For) and _iterates_poll(n, poll_names)]
        if not loops or not _commit_effect(flow, module, project):
            continue
        frontier = _frontier_names(fn)
        for loop in loops:
            # (a) commit-through: the frontier must survive cancellation
            if not _finally_commits_through(fn, frontier, loop):
                yield Finding(
                    path=module.relpath, line=fn.lineno, code="CAN01",
                    message=f"committing consumer loop `{flow.name}` has "
                            f"no finally committing its handled-through "
                            f"frontier — a cancellation mid-batch makes a "
                            f"clean handoff replay handled records through "
                            f"the adopter",
                    hint="track `handled[(r.topic, r.partition)] = "
                         "r.offset + 1` per record and commit "
                         "`dict(handled)` in a finally (or hand the "
                         "frontier to the stop path)",
                    qualname=module.qualname_at(fn.lineno))
            # (b) settled produce: direct per-record produces, plus one
            # level into same-module callees invoked from the loop body
            span = (loop.lineno, loop.end_lineno or loop.lineno)
            produces = list(_unsettled_produces(fn, within=span))
            seen_callees: set[str] = set()
            for call in _loop_calls(loop):
                callee = project.resolve_call(module, call, flow.class_name)
                if callee is None \
                        or mf.functions.get(callee.qualname) is not callee \
                        or callee.qualname in seen_callees:
                    continue
                seen_callees.add(callee.qualname)
                produces.extend(_unsettled_produces(callee.node))
            for node in produces:
                kind = node.func.attr  # type: ignore[union-attr]
                yield Finding(
                    path=module.relpath, line=node.lineno, code="CAN01",
                    message=f"per-record `.{kind}(...)` in a cancellable "
                            f"committing loop — a cancel landing inside "
                            f"the produce await makes 'was it published?' "
                            f"unknowable for the commit",
                    hint="route through `fastlane.produce_settled` (SENT "
                         "probe + shield) or wrap in `asyncio.shield`",
                    qualname=module.qualname_at(node.lineno))

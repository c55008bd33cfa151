"""ASY01: blocking calls inside `async def`.

The whole platform is one event loop; a single blocking call at ingress
rate stalls every tenant's pipeline at once (the async-dataflow
blocking-call hazard — PAPERS.md, Cloudflow). The checker resolves each
call in an async body through the module's import table and flags the
known blocking families:

- `time.sleep`                         → `await asyncio.sleep(...)`
- `requests.*` / `urllib.request.*`    → async client / asyncio.to_thread
- `socket.create_connection` & friends → asyncio streams
- `subprocess.run/call/...`, `os.system`→ asyncio.create_subprocess_*
- builtin `open(...)`                  → asyncio.to_thread / worker thread
- `<...>.faults.check(site)`           → `await ...acheck(site)` — the
  sync consult `time.sleep`s the loop on delay-mode faults

Nested `def`/`lambda` bodies are separate scopes and are skipped (a sync
closure may legitimately run in a worker thread); nested `async def`s
are visited on their own.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator, Optional

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project

_SUBPROCESS = {"run", "call", "check_call", "check_output", "getoutput",
               "getstatusoutput"}
_SOCKET = {"create_connection", "getaddrinfo", "gethostbyname",
           "gethostbyaddr", "getfqdn"}
_OS = {"system", "popen"}


def _import_table(tree: ast.AST) -> dict[str, str]:
    """Local name -> dotted origin ("t" -> "time", "sleep" -> "time.sleep")."""
    table: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                table[local] = alias.name if alias.asname else local
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                table[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return table


def _dotted(node: ast.expr, imports: dict[str, str]) -> Optional[str]:
    """Dotted text of a Name/Attribute chain with the root resolved
    through the import table; None for unresolvable receivers."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(imports.get(cur.id, cur.id))
    elif isinstance(cur, ast.Call):
        parts.append("()")
    else:
        return None
    return ".".join(reversed(parts))


def _classify(dotted: str) -> Optional[tuple[str, str]]:
    """(description, fix hint) when `dotted` is a known blocking call."""
    head, _, tail = dotted.partition(".")
    if dotted == "time.sleep":
        return ("time.sleep blocks the event loop",
                "use `await asyncio.sleep(...)`")
    if head == "requests":
        return (f"`{dotted}` does synchronous HTTP",
                "use the async client (utils/http.py) or asyncio.to_thread")
    if dotted.startswith("urllib.request."):
        return (f"`{dotted}` does synchronous HTTP",
                "use the async client (utils/http.py) or asyncio.to_thread")
    if head == "socket" and tail in _SOCKET:
        return (f"`{dotted}` does blocking network I/O",
                "use asyncio.open_connection / loop.getaddrinfo")
    if head == "subprocess" and tail in _SUBPROCESS:
        return (f"`{dotted}` blocks on a child process",
                "use asyncio.create_subprocess_exec")
    if head == "os" and tail in _OS:
        return (f"`{dotted}` blocks on a child process",
                "use asyncio.create_subprocess_exec")
    if dotted == "open":
        return ("builtin open() does blocking file I/O",
                "wrap in asyncio.to_thread or hand to a worker thread")
    parts = dotted.split(".")
    if parts[-1] == "check" and len(parts) >= 2 \
            and "faults" in parts[-2].lower():
        return ("sync FaultInjector.check() time.sleeps the event loop "
                "on delay-mode faults",
                "use `await ...acheck(site)`")
    return None


def _async_body_calls(fn: ast.AsyncFunctionDef) -> Iterator[ast.Call]:
    """Calls lexically in `fn`'s own async body (nested defs skipped)."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue  # separate scope; async ones are visited on their own
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def check_async_blocking(module: Module, project: Project) -> Iterable[Finding]:
    imports = _import_table(module.tree)
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for call in _async_body_calls(node):
            dotted = _dotted(call.func, imports)
            if dotted is None:
                continue
            hit = _classify(dotted)
            if hit is None:
                continue
            desc, hint = hit
            yield Finding(
                path=module.relpath, line=call.lineno, code="ASY01",
                message=f"{desc} (inside `async def {node.name}`)",
                hint=hint, qualname=module.qualname_at(call.lineno))

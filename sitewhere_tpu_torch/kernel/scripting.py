"""Script manager: per-tenant python hook scripts with hot reload.

Capability parity with the reference's Groovy script manager
(`ScriptManager`, `ScriptSynchronizer`, script bindings — [SURVEY.md §2.1
"Script manager", §1 L5]): operators upload named scripts per tenant;
scripts are versioned, compiled, and bound into the rule-processing
engine's hook slots; updating a script hot-reloads it in place.

A script is python source defining `async def process(event, api)` —
the same contract as a manually registered hook (`RuleApi` bindings:
emit_alert, device_state). Scripts run in-process with the platform's
privileges, exactly like the reference's Groovy scripts — they are an
OPERATOR extension surface (deploy-time trusted), not tenant-user input;
the REST layer gates uploads behind the ADMINISTER_SCRIPTS authority.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger(__name__)


@dataclass
class Script:
    name: str
    source: str
    version: int = 1
    updated_at: float = field(default_factory=time.time)


class ScriptManager:
    """Per-tenant script store + compiler (reference: ScriptManager).

    `entrypoint`/`require_async` parameterize the contract per extension
    surface: rule hooks are `async def process(event, api)` (the
    default); event-source decoder scripts are `def decode(payload,
    ctx)` (reference: GroovyEventDecoder beside the Groovy rule
    scripts)."""

    ENTRYPOINT = "process"

    def __init__(self, tenant_id: str, entrypoint: str = ENTRYPOINT,
                 require_async: bool = True):
        self.tenant_id = tenant_id
        self.entrypoint = entrypoint
        self.require_async = require_async
        self.scripts: dict[str, Script] = {}
        self._compiled: dict[str, Callable] = {}

    def put(self, name: str, source: str) -> Script:
        """Create or update (hot-reload) a script; compiles eagerly so a
        syntax error is surfaced at upload, not at first event."""
        fn = self._compile(name, source)
        existing = self.scripts.get(name)
        script = Script(name=name, source=source,
                        version=(existing.version + 1) if existing else 1)
        self.scripts[name] = script
        self._compiled[name] = fn
        logger.info("script %s/%s v%d loaded", self.tenant_id, name,
                    script.version)
        return script

    def get(self, name: str) -> Optional[Script]:
        return self.scripts.get(name)

    def delete(self, name: str) -> Optional[Script]:
        self._compiled.pop(name, None)
        return self.scripts.pop(name, None)

    def list(self) -> list[Script]:
        return sorted(self.scripts.values(), key=lambda s: s.name)

    def hook(self, name: str) -> Callable:
        return self._compiled[name]

    def _compile(self, name: str, source: str) -> Callable:
        namespace: dict = {}
        code = compile(source, f"<script:{self.tenant_id}/{name}>", "exec")
        exec(code, namespace)  # noqa: S102 - operator-trusted extension surface
        fn = namespace.get(self.entrypoint)
        kind = "async def" if self.require_async else "def"
        if fn is None or not callable(fn):
            raise ValueError(
                f"script {name!r} must define `{kind} {self.entrypoint}(...)`")
        import inspect

        if self.require_async and not inspect.iscoroutinefunction(fn):
            raise ValueError(f"script {name!r}: `{self.entrypoint}` must be "
                             f"`async def`")
        if not self.require_async and inspect.iscoroutinefunction(fn):
            # contract errors surface at upload, not at first event: a
            # sync surface calling an async fn would get a coroutine back
            raise ValueError(f"script {name!r}: `{self.entrypoint}` must be "
                             f"a plain `def`, not `async def`")
        return fn

"""The REST facade on both packages: the same scripted HTTP conversation
goes to a JAX runtime and to a port runtime (`device="cpu"`), each
hosting all fourteen services with REST on port 0, and every answer is
compared: status codes equal, bodies equal.

Fields that differ between two runs of one package by construction are
held by shape, and named here:
- uuids (entity ids and every reference to one): replaced by the order
  in which they first appear in the conversation, so references must
  still point at the same entity on both sides;
- clocks: `*_date`, `*_at`, `updatedAt`, `iat`, `exp`, `uptime_s`
  (their type is compared);
- tokens: the JWT of `POST /api/jwt` and a tenant's `auth_token`
  (held to the JWT shape: three base64url parts; the JWT verifies on the
  other package, `tests/test_torch_security.py`);
- ports: a receiver's bound `port`;
- live runtime state whose numbers move with time (`/api/instance/
  metrics`, `/observe`, `/traces`, `/health`'s children): keys and value
  types, not values; the Prometheus text: its metric names.

Two bodies carry numbers the packages compute: the training report
(`POST /api/batch/train`), whose losses start from each package's own
random weights (ROADMAP C), held to the same keys, loss-curve length and
a falling, finite loss; and forecasts, computed after the same weights
are swapped into both tenants' sessions, held to the forecast within
0.05 plus 1e-2 relative in original units (bf16 compute on both sides,
the port's products rounded as the reference casts) and the attention
within 1e-2.
"""

import asyncio
import base64
import contextlib
import json
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.kernel import faults as jfaults
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu.models.registry import build_model as jax_build
from sitewhere_tpu.sim import simulator as jsim
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.analysis.registry import HOST_STAGES
from sitewhere_tpu_torch.cli import ALL_SERVICES
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.kernel import faults as tfaults
from sitewhere_tpu_torch.kernel import service as tservice
from sitewhere_tpu_torch.sim import simulator as tsim

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(name="jax", config=jconfig, services=jservices,
                      service=jservice, model=jmodel, sim=jsim,
                      faults=jfaults, settings={},
                      place=lambda p: p)
PORT = SimpleNamespace(name="port", config=tconfig, services=tservices,
                       service=tservice, model=tmodel, sim=tsim,
                       faults=tfaults,
                       settings={"device": "cpu"},
                       place=lambda p: params_from_numpy(p, "cpu"))
STEP = 120.0    # limit on any one request (s): a first forecast query
                # compiles the JAX model under a loaded host

_UUID = re.compile(r"[0-9a-f]{32}")
_JWT = re.compile(r"^[A-Za-z0-9_-]+\.[A-Za-z0-9_-]+\.[A-Za-z0-9_-]+$")
CLOCK_KEYS = re.compile(r"(_date|_at|At|^iat|^exp|^uptime_s|^ts)$")
TOKEN_KEYS = {"auth_token"}
PORT_KEYS = {"port"}
# the port's instrumentation beyond the reference's: the process's
# garbage collections (`runtime.gc_*`, kernel/tracing.py watch_gc)
PORT_ONLY_METRICS = re.compile(r"(^|_)runtime[._]gc_")


def shape(doc):
    """Keys and value types, recursively; lists by their items' shapes."""
    if isinstance(doc, dict):
        return {k: shape(v) for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return ["list", sorted({json.dumps(shape(v), sort_keys=True)
                                for v in doc})]
    if isinstance(doc, bool) or doc is None:
        return type(doc).__name__
    if isinstance(doc, (int, float)):
        return "number"
    return type(doc).__name__


class Client:
    """One side of the conversation: requests to one runtime's REST
    port, and the log of what it answered (normalized)."""

    def __init__(self, pkg, rt):
        self.pkg, self.rt = pkg, rt
        self.port = rt.services["instance-management"].rest.port
        self.token = None
        self.log: list = []
        self.uuids: dict[str, int] = {}

    def _norm(self, doc, key=None):
        if isinstance(doc, dict):
            return {k: self._norm(v, k) for k, v in doc.items()}
        if isinstance(doc, list):
            return [self._norm(v) for v in doc]
        if key is not None and CLOCK_KEYS.search(key) and isinstance(
                doc, (int, float)) and not isinstance(doc, bool):
            return "<clock>"
        if key in PORT_KEYS and isinstance(doc, int):
            return "<port>"
        if isinstance(doc, str):
            if key in TOKEN_KEYS or key == "token" and _JWT.match(doc):
                return "<jwt>" if _JWT.match(doc) else "<token>"
            return _UUID.sub(
                lambda m: f"<uuid {self.uuids.setdefault(m.group(), len(self.uuids))}>",
                doc)
        return doc

    async def http(self, method, path, body=None, *, auth=True, basic=None,
                   tenant=None, raw=False):
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection("127.0.0.1", self.port), STEP)
        payload = json.dumps(body).encode() if body is not None else b""
        lines = [f"{method} {path} HTTP/1.1", "Host: localhost",
                 f"Content-Length: {len(payload)}"]
        if auth is True and self.token:
            lines.append(f"Authorization: Bearer {self.token}")
        elif isinstance(auth, str):
            lines.append(f"Authorization: Bearer {auth}")
        if basic:
            lines.append("Authorization: Basic "
                         + base64.b64encode(basic.encode()).decode())
        if tenant:
            lines.append(f"X-SiteWhere-Tenant: {tenant}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + payload)
        await writer.drain()
        status = int((await asyncio.wait_for(reader.readline(), STEP))
                     .split()[1])
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0))
        data = await asyncio.wait_for(reader.readexactly(n), STEP) if n \
            else b""
        writer.close()
        if raw:
            return status, headers, data
        return status, (json.loads(data) if data else None)

    async def req(self, label, method, path, body=None, *, mode="equal",
                  drop=None, **kw):
        """Send, log `(label, status, body as compared)`, return the raw
        answer. `mode`: "equal" (normalized body), "shape", "bytes"
        (content type and bytes), "prometheus" (metric names). `drop`:
        a pattern of top-level keys (metric names) left out of the log."""
        if mode in ("bytes", "prometheus"):
            status, headers, data = await self.http(method, path, body,
                                                    raw=True, **kw)
            if mode == "prometheus":
                names = sorted({re.split(r"[{ ]", ln)[0]
                                for ln in data.decode().splitlines()
                                if ln and not ln.startswith("#")})
                if drop is not None:
                    names = [n for n in names if not drop.search(n)]
                self.log.append((label, status, headers["content-type"],
                                 names))
            else:
                self.log.append((label, status, headers["content-type"],
                                 data))
            return status, data
        status, doc = await self.http(method, path, body, **kw)
        if drop is not None and isinstance(doc, dict):
            doc = {k: v for k, v in doc.items() if not drop.search(k)}
        seen = shape(doc) if mode == "shape" else self._norm(doc)
        self.log.append((label, status, seen))
        return status, doc

    def note(self, label, value):
        """Log a value read in-process (not over REST)."""
        self.log.append((label, self._norm(value)))


@contextlib.asynccontextmanager
async def platform(pkg, faults=False):
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="rest", rest_port=0, flow_degrade_at=10.0,
        flow_defer_at=10.0, **pkg.settings))
    for name in ALL_SERVICES:
        rt.add_service(getattr(pkg.services, name)(rt))
    if faults:
        rt.install_faults(pkg.faults.FaultInjector(seed=42))
    await rt.start()
    try:
        yield Client(pkg, rt)
    finally:
        await rt.stop()


async def wait_for(c, label, method, path, done, tries=200, **kw):
    """Poll a GET until `done(status, body)`, then log that answer."""
    for _ in range(tries):
        status, doc = await c.http(method, path, **kw)
        if done(status, doc):
            return await c.req(label, method, path, **kw)
        await asyncio.sleep(0.05)
    raise AssertionError(f"{label}: never ready")


async def settle(c, timeout=20.0):
    """Every consumer group committed through its topics' heads."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while any(c.rt.bus.group_lags().values()):
        assert loop.time() < deadline, c.rt.bus.group_lags()
        await asyncio.sleep(0.02)


async def beats(c, n=2, timeout=30.0):
    """Wait for `n` more telemetry-beat samples: the beat registers a
    consumer-lag gauge per group when it samples, so the metrics and
    observe documents have the same keys on both sides only once a beat
    has run after the last group appeared."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    counter = c.rt.metrics.counter("observe.beats")
    target = counter.value + n
    while counter.value < target:
        assert loop.time() < deadline, "the telemetry beat did not run"
        await asyncio.sleep(0.02)


async def login(c):
    status, doc = await c.req("jwt", "POST", "/api/jwt",
                              basic="admin:password", auth=False)
    assert status == 200 and _JWT.match(doc["token"])
    c.token = doc["token"]


async def tenant(c, token, sections=None, **extra):
    body = {"token": token, "sections": sections if sections is not None
            else {"rule-processing": {"model": None}}, **extra}
    return await c.req(f"tenant {token}", "POST", "/api/tenants", body)


# -- the conversation, in segments ---------------------------------------------

async def seg_auth(c):
    await c.req("no token", "GET", "/api/tenants")
    await c.req("bad basic", "POST", "/api/jwt", basic="admin:wrong",
                auth=False)
    await c.req("no basic", "POST", "/api/jwt", auth=False)
    await login(c)
    await c.req("tenants", "GET", "/api/tenants")
    await c.req("health", "GET", "/api/instance/health", auth=False,
                mode="shape")
    await c.req("tampered", "GET", "/api/tenants",
                auth=c.token[:-4] + ("AAAA" if not c.token.endswith("AAAA")
                                     else "BBBB"))
    await c.req("users", "GET", "/api/users")
    await c.req("create user", "POST", "/api/users",
                {"username": "op", "password": "pw", "firstName": "O"})
    await c.req("dup user", "POST", "/api/users",
                {"username": "op", "password": "pw"})
    status, doc = await c.http("POST", "/api/jwt", basic="op:pw", auth=False)
    assert status == 200
    op = doc["token"]
    await c.req("op tenants", "GET", "/api/tenants", auth=op)
    await c.req("op users 403", "GET", "/api/users", auth=op)
    await c.req("op create tenant 403", "POST", "/api/tenants",
                {"token": "x"}, auth=op)
    await c.req("op scripts 403", "GET", "/api/scripts", auth=op,
                tenant="x")
    await c.req("openapi", "GET", "/api/openapi.json", auth=False)
    await c.req("no route", "GET", "/api/nope")
    await c.req("bad json", "POST", "/api/users", auth=True)


async def seg_lifecycle(c):
    await login(c)
    await tenant(c, "acme", name="Acme")
    await c.req("dup tenant", "POST", "/api/tenants", {"token": "acme"})
    await c.req("tenant no token", "POST", "/api/tenants", {"name": "x"})
    await c.req("get tenant", "GET", "/api/tenants/acme")
    await c.req("get ghost tenant", "GET", "/api/tenants/ghost")
    await c.req("update tenant", "PUT", "/api/tenants/acme",
                {"name": "Acme Corp"})
    await c.req("quota", "GET", "/api/tenants/acme/quota", mode="shape")
    await c.req("put quota", "PUT", "/api/tenants/acme/quota",
                {"rate": 1000, "burst": 500})
    await c.req("put quota empty", "PUT", "/api/tenants/acme/quota", {})
    await c.req("put quota bad", "PUT", "/api/tenants/acme/quota",
                {"rate": "fast"})
    await c.req("put quota mode", "PUT", "/api/tenants/acme/quota",
                {"mode": "nope"})
    t = {"tenant": "acme"}
    await c.req("devicetype", "POST", "/api/devicetypes",
                {"token": "thermo", "name": "Thermometer"}, **t)
    await c.req("get devicetype", "GET", "/api/devicetypes/thermo", **t)
    await c.req("ghost devicetype", "GET", "/api/devicetypes/ghost", **t)
    await c.req("devicetypes", "GET", "/api/devicetypes", **t)
    await c.req("command", "POST", "/api/devicetypes/thermo/commands",
                {"token": "reboot", "name": "reboot",
                 "parameters": [{"name": "delay", "type": "int64"}]}, **t)
    await c.req("commands", "GET", "/api/devicetypes/thermo/commands", **t)
    for i in range(3):
        await c.req(f"device {i}", "POST", "/api/devices",
                    {"token": f"dev-{i}", "deviceType": "thermo",
                     "metadata": {"floor": i}}, **t)
    await c.req("dup device", "POST", "/api/devices",
                {"token": "dev-0", "deviceType": "thermo"}, **t)
    await c.req("device bad type", "POST", "/api/devices",
                {"token": "dev-x", "deviceType": "ghost"}, **t)
    await c.req("devices", "GET", "/api/devices?page=1&pageSize=2", **t)
    await c.req("get device", "GET", "/api/devices/dev-1", **t)
    await c.req("assignments", "GET", "/api/assignments", **t)
    await c.req("get assignment", "GET", "/api/assignments/dev-1-a", **t)
    await c.req("assignment", "POST", "/api/assignments",
                {"token": "dev-2-b", "deviceToken": "dev-2"}, **t)
    await c.req("end assignment", "POST", "/api/assignments/dev-2-b/end",
                **t)
    await c.req("measurement", "POST",
                "/api/assignments/dev-1-a/measurements",
                {"value": 21.5, "eventDate": 1000.0}, **t)
    await c.req("measurement bad", "POST",
                "/api/assignments/dev-1-a/measurements",
                {"value": "warm"}, **t)
    await wait_for(c, "measurements", "GET",
                   "/api/assignments/dev-1-a/measurements",
                   lambda s, d: s == 200 and len(d) == 1, **t)
    await settle(c)
    await c.req("state", "GET", "/api/devices/dev-1/state", **t)
    await c.req("invoke", "POST", "/api/assignments/dev-1-a/invocations",
                {"commandToken": "reboot", "parameterValues": {"delay": 1}},
                **t)
    await c.req("invoke bad", "POST", "/api/assignments/dev-1-a/invocations",
                {"commandToken": "ghost"}, **t)
    delivery = c.rt.api("command-delivery").delivery("acme")
    for _ in range(200):
        if delivery.providers["queue"].inbox("dev-1"):
            break
        await asyncio.sleep(0.05)
    c.note("delivered", [json.loads(p) for p in
                         delivery.providers["queue"].inbox("dev-1")])
    await c.req("label", "GET", "/api/labels/devices/dev-1", mode="bytes",
                **t)
    await c.req("label qr", "GET", "/api/labels/devices/dev-2?generator=qr",
                mode="bytes", **t)
    await c.req("label ghost", "GET", "/api/labels/devices/ghost", **t)
    await c.req("ghost tenant", "GET", "/api/devices", tenant="ghost")
    await c.req("no tenant header", "GET", "/api/devices")
    await c.req("delete device", "DELETE", "/api/devices/dev-0", **t)
    await c.req("ghost device", "GET", "/api/devices/dev-0", **t)
    await c.req("tenants", "GET", "/api/tenants")
    await c.req("delete tenant", "DELETE", "/api/tenants/acme")
    await c.req("delete ghost tenant", "DELETE", "/api/tenants/acme")
    await c.req("tenants after", "GET", "/api/tenants")


async def seg_groups(c):
    await login(c)
    await tenant(c, "acme")
    c.rt.api("device-management").management("acme").bootstrap_fleet(
        c.pkg.model.DeviceType(token="thermo", name="T"), 5)
    t = {"tenant": "acme"}
    await c.req("group", "POST", "/api/devicegroups",
                {"token": "floor-1", "name": "Floor 1",
                 "roles": ["monitoring"]}, **t)
    await c.req("group no token", "POST", "/api/devicegroups", {}, **t)
    await c.req("nested", "POST", "/api/devicegroups", {"token": "rack-a"},
                **t)
    await c.req("dup group", "POST", "/api/devicegroups", {"token": "rack-a"},
                **t)
    await c.req("rack elements", "POST", "/api/devicegroups/rack-a/elements",
                {"elements": [{"device": "dev-0"}, {"device": "dev-1"}]},
                **t)
    await c.req("floor elements", "POST",
                "/api/devicegroups/floor-1/elements",
                {"elements": [{"device": "dev-4"}, {"group": "rack-a"}]},
                **t)
    await c.req("bad element", "POST", "/api/devicegroups/floor-1/elements",
                {"elements": [{"device": "nope"}]}, **t)
    await c.req("empty element", "POST",
                "/api/devicegroups/floor-1/elements",
                {"elements": [{}]}, **t)
    await c.req("list elements", "GET", "/api/devicegroups/floor-1/elements",
                **t)
    await c.req("expand", "GET", "/api/devicegroups/floor-1/devices", **t)
    await c.req("groups", "GET", "/api/devicegroups", **t)
    await c.req("get group", "GET", "/api/devicegroups/floor-1", **t)
    await c.req("delete group", "DELETE", "/api/devicegroups/rack-a", **t)
    await c.req("ghost group", "GET", "/api/devicegroups/rack-a", **t)
    await c.req("batch by group", "POST", "/api/batch/command",
                {"groupToken": "floor-1"}, **t)


async def seg_events(c):
    await login(c)
    await tenant(c, "acme")
    t = {"tenant": "acme"}
    await c.req("devicetype", "POST", "/api/devicetypes",
                {"token": "thermo", "name": "T"}, **t)
    await c.req("device", "POST", "/api/devices",
                {"token": "dev-1", "deviceType": "thermo"}, **t)
    await c.req("location", "POST", "/api/assignments/dev-1-a/locations",
                {"latitude": 47.3, "longitude": 8.5, "elevation": 410.0,
                 "eventDate": 2000.0}, **t)
    await wait_for(c, "locations", "GET",
                   "/api/assignments/dev-1-a/locations",
                   lambda s, d: s == 200 and len(d) == 1, **t)
    await c.req("location bad", "POST", "/api/assignments/dev-1-a/locations",
                {"latitude": "north"}, **t)
    await c.req("alert bad level", "POST", "/api/assignments/dev-1-a/alerts",
                {"level": 2}, **t)
    await c.req("alert", "POST", "/api/assignments/dev-1-a/alerts",
                {"type": "overheat", "message": "too hot",
                 "level": "warning", "eventDate": 2100.0}, **t)
    await c.req("alert unknown level", "POST",
                "/api/assignments/dev-1-a/alerts", {"level": "nope"}, **t)
    await c.req("alerts", "GET", "/api/assignments/dev-1-a/alerts", **t)
    await c.req("tenant alerts", "GET", "/api/alerts", **t)
    await c.req("command", "POST", "/api/devicetypes/thermo/commands",
                {"token": "reboot", "name": "reboot"}, **t)
    _, inv = await c.req("invoke", "POST",
                         "/api/assignments/dev-1-a/invocations",
                         {"commandToken": "reboot"}, **t)
    await c.req("invocations", "GET",
                "/api/assignments/dev-1-a/invocations", **t)
    await c.req("response", "POST", "/api/assignments/dev-1-a/responses",
                {"originatingEventId": inv["id"], "response": "ok"}, **t)
    await c.req("responses", "GET", f"/api/invocations/{inv['id']}/responses",
                **t)
    await c.req("responses none", "GET", "/api/invocations/nope/responses",
                **t)
    await c.req("state change", "POST",
                "/api/assignments/dev-1-a/statechanges",
                {"attribute": "firmware", "previousState": "1.0",
                 "newState": "1.1"}, **t)
    await c.req("state changes", "GET",
                "/api/assignments/dev-1-a/statechanges", **t)
    await settle(c)
    await c.req("missing", "GET",
                "/api/devicestates/missing?olderThan=1000&now=5000", **t)
    await c.req("missing none", "GET",
                "/api/devicestates/missing?olderThan=9000&now=5000", **t)
    await c.req("missing bad", "GET",
                "/api/devicestates/missing?olderThan=x", **t)
    await c.req("ghost assignment", "GET",
                "/api/assignments/ghost/measurements", **t)


async def seg_model(c):
    """Areas, customers, zones, asset types, assets."""
    await login(c)
    await tenant(c, "acme")
    t = {"tenant": "acme"}
    _, area = await c.req("area", "POST", "/api/areas",
                          {"token": "site", "name": "Site",
                           "bounds": [[0, 0], [0, 1], [1, 1]]}, **t)
    await c.req("areas", "GET", "/api/areas", **t)
    await c.req("customer", "POST", "/api/customers",
                {"token": "c1", "name": "Customer 1"}, **t)
    await c.req("customers", "GET", "/api/customers", **t)
    await c.req("zone", "POST", "/api/zones",
                {"token": "dock", "name": "Dock", "areaId": area["id"],
                 "bounds": [[0.0, 0.0], [0.0, 10.0], [10.0, 10.0],
                            [10.0, 0.0]]}, **t)
    await c.req("zones", "GET", "/api/zones", **t)
    await c.req("asset type", "POST", "/api/assettypes",
                {"token": "hvac", "name": "HVAC", "assetCategory": "device"},
                **t)
    await c.req("asset types", "GET", "/api/assettypes", **t)
    await c.req("asset", "POST", "/api/assets",
                {"token": "hvac-1", "name": "HVAC 1", "assetType": "hvac"},
                **t)
    await c.req("asset no type", "POST", "/api/assets",
                {"token": "a2", "name": "A2"}, **t)
    await c.req("assets", "GET", "/api/assets", **t)


async def seg_scripts(c):
    """Rule scripts, decoder scripts, connector and encoder scripts,
    receivers and connectors."""
    await login(c)
    await tenant(c, "acme")
    t = {"tenant": "acme"}
    await c.req("bad script", "PUT", "/api/scripts/bad",
                {"source": "def process(:"}, **t)
    await c.req("sync script", "PUT", "/api/scripts/sync",
                {"source": "def process(event, api):\n    pass"}, **t)
    await c.req("no source", "PUT", "/api/scripts/x", {}, **t)
    src = ("counted = []\n"
           "async def process(event, api):\n"
           "    counted.append(type(event).__name__)\n")
    await c.req("script", "PUT", "/api/scripts/counter", {"source": src},
                **t)
    await c.req("script v2", "PUT", "/api/scripts/counter",
                {"source": src + "# v2\n"}, **t)
    await c.req("scripts", "GET", "/api/scripts", mode="shape", **t)
    c.note("hooks", sorted(c.rt.api("rule-processing").engine("acme").hooks))
    await c.req("delete script", "DELETE", "/api/scripts/counter", **t)
    dsrc = ("def decode(payload, ctx):\n"
            "    tok, val = payload.decode().split(',')\n"
            "    return [{'type': 'measurement', 'device': tok,\n"
            "             'value': float(val)}]\n")
    await c.req("decoder", "PUT", "/api/decoder-scripts/csv",
                {"source": dsrc}, **t)
    await c.req("async decoder", "PUT", "/api/decoder-scripts/bad",
                {"source": "async def decode(p, c):\n    return []"}, **t)
    await c.req("receiver", "POST", "/api/eventsources/receivers",
                {"kind": "queue", "decoder": "script:csv", "name": "csv"},
                **t)
    await c.req("receivers", "GET", "/api/eventsources/receivers", **t)
    await c.req("dup receiver", "POST", "/api/eventsources/receivers",
                {"kind": "queue", "name": "csv"}, **t)
    await c.req("receiver bad decoder", "POST",
                "/api/eventsources/receivers",
                {"kind": "queue", "decoder": "script:nope", "name": "x"},
                **t)
    blocker = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
    taken = blocker.sockets[0].getsockname()[1]
    try:
        status, doc = await c.http(
            "POST", "/api/eventsources/receivers",
            {"kind": "tcp", "name": "t1", "port": taken}, tenant="acme")
        # the refusal names the taken port; hold it by status and shape
        c.log.append(("receiver port taken", status, sorted(doc)))
    finally:
        blocker.close()
    await c.req("receivers after", "GET", "/api/eventsources/receivers", **t)
    await c.req("decoders", "GET", "/api/decoder-scripts", mode="shape", **t)
    await c.req("delete decoder in use", "DELETE",
                "/api/decoder-scripts/csv", **t)
    await c.req("delete receiver", "DELETE",
                "/api/eventsources/receivers/csv", **t)
    await c.req("delete ghost receiver", "DELETE",
                "/api/eventsources/receivers/csv", **t)
    await c.req("delete decoder", "DELETE", "/api/decoder-scripts/csv", **t)
    await c.req("decoders after", "GET", "/api/decoder-scripts", **t)
    csrc = ("seen = []\n"
            "async def process(value, api):\n"
            "    seen.append(value)\n")
    await c.req("connector script", "PUT", "/api/connector-scripts/tap",
                {"source": csrc}, **t)
    await c.req("connector scripts", "GET", "/api/connector-scripts",
                mode="shape", **t)
    await c.req("connector", "POST", "/api/connectors",
                {"kind": "script", "name": "tap", "script": "tap"}, **t)
    await c.req("connector memory", "POST", "/api/connectors",
                {"kind": "memory", "name": "mem", "kinds": ["scored"]}, **t)
    await c.req("dup connector", "POST", "/api/connectors",
                {"kind": "memory", "name": "mem"}, **t)
    await c.req("bad connector", "POST", "/api/connectors",
                {"kind": "nope", "name": "x"}, **t)
    await c.req("connectors", "GET", "/api/connectors", **t)
    await c.req("delete connector script in use", "DELETE",
                "/api/connector-scripts/tap", **t)
    await c.req("delete connector", "DELETE", "/api/connectors/tap", **t)
    await c.req("delete ghost connector", "DELETE", "/api/connectors/tap",
                **t)
    await c.req("delete connector script", "DELETE",
                "/api/connector-scripts/tap", **t)
    esrc = ("def encode(device, command, invocation):\n"
            "    return b'CMD:' + device.token.encode()\n")
    await c.req("encoder script", "PUT", "/api/encoder-scripts/short",
                {"source": esrc}, **t)
    await c.req("encoder scripts", "GET", "/api/encoder-scripts",
                mode="shape", **t)
    await c.req("delete encoder script", "DELETE",
                "/api/encoder-scripts/short", **t)
    await c.req("encoder scripts after", "GET", "/api/encoder-scripts", **t)


async def seg_batch_train(c, tmp_path):
    await login(c)
    await tenant(c, "acme", {
        "rule-processing": {"model": "lstm",
                            "model_config": {"window": 16, "hidden": 8},
                            "batch_window_ms": 1.0, "buckets": [64]},
        "batch-operations": {"checkpoint_root":
                             str(tmp_path / c.pkg.name / "ckpt")}})
    t = {"tenant": "acme"}
    await c.req("devicetype", "POST", "/api/devicetypes",
                {"token": "t", "name": "T"}, **t)
    await c.req("command", "POST", "/api/devicetypes/t/commands",
                {"token": "ping", "name": "ping"}, **t)
    for i in range(3):
        await c.req(f"device {i}", "POST", "/api/devices",
                    {"token": f"d{i}", "deviceType": "t"}, **t)
    await c.req("batch none", "POST", "/api/batch/command",
                {"deviceTokens": ["ghost"]}, **t)
    await c.req("batch bad command", "POST", "/api/batch/command",
                {"deviceTokens": ["d0"], "commandToken": "ghost"}, **t)
    _, op = await c.req("batch", "POST", "/api/batch/command",
                        {"deviceTokens": ["d0", "d1", "d2"],
                         "commandToken": "ping"}, **t)
    await wait_for(c, "batch done", "GET", f"/api/batch/{op['id']}",
                   lambda s, d: d["processing_status"] == "finished", **t)
    await c.req("batch elements", "GET", f"/api/batch/{op['id']}/elements",
                **t)
    await c.req("ghost batch", "GET", "/api/batch/nope", **t)
    # training data straight into the store, as the JAX tests do
    em = c.rt.api("event-management").management("acme")
    sim = c.pkg.sim.DeviceSimulator(c.pkg.sim.SimConfig(num_devices=3,
                                                        seed=2),
                                    tenant_id="acme")
    for k in range(120):
        em.telemetry.append_measurements(sim.tick(t=60.0 * k)[0])
    engine = c.rt.api("rule-processing").engine("acme")
    v0 = engine.session.version
    _, op = await c.req("train", "POST", "/api/batch/train",
                        {"model": "lstm", "steps": 20, "batchSize": 32},
                        **t)
    for _ in range(600):
        status, doc = await c.http("GET", f"/api/batch/{op['id']}", **t)
        if doc["processing_status"] == "finished":
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError("training never finished")
    result = doc["parameters"]["result"]
    losses = result.pop("losses")
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for key in ("final_loss", "seconds", "train_seconds"):
        assert np.isfinite(result.pop(key))
    c.log.append(("train done", status, c._norm(
        {**doc, "parameters": {**doc["parameters"], "result": result}}),
        len(losses)))
    c.note("session version bump", engine.session.version - v0)


async def seg_schedules(c):
    await login(c)
    await tenant(c, "acme")
    c.rt.api("device-management").management("acme").bootstrap_fleet(
        c.pkg.model.DeviceType(token="thermo", name="T"), 3)
    t = {"tenant": "acme"}
    await c.req("schedule", "POST", "/api/schedules",
                {"token": "nightly", "name": "Nightly",
                 "triggerType": "cron",
                 "triggerConfiguration": {"cron": "0 3 * * *"}}, **t)
    _, s2 = await c.req("schedule simple", "POST", "/api/schedules",
                        {"token": "tick", "name": "Tick",
                         "triggerType": "simple",
                         "triggerConfiguration": {"repeat_interval_s": 3600},
                         "startDate": 4102444800.0}, **t)
    await c.req("schedules", "GET", "/api/schedules", **t)
    await c.req("job", "POST", "/api/jobs",
                {"scheduleToken": "nightly", "jobType": "command-invocation",
                 "configuration": {"command_id": "x"}}, **t)
    await c.req("job by id", "POST", "/api/jobs",
                {"scheduleId": s2["id"]}, **t)
    await c.req("job ghost", "POST", "/api/jobs",
                {"scheduleToken": "ghost"}, **t)


async def seg_dlq(c):
    """A poison record on the decoded topic is quarantined, listed over
    REST and replayed."""
    await login(c)
    await tenant(c, "acme")
    t = {"tenant": "acme"}
    await c.req("dlq empty", "GET", "/api/dlq", **t)
    c.rt.api("device-management").management("acme").bootstrap_fleet(
        c.pkg.model.DeviceType(token="thermo", name="T"), 4)
    sim = c.pkg.sim.DeviceSimulator(c.pkg.sim.SimConfig(num_devices=4),
                                    tenant_id="acme")
    # exactly the first record inbound-processing handles is poison
    c.rt.faults.arm("inbound.handle", rate=1.0, max_faults=1)
    topic = c.rt.naming.tenant_topic("acme", "event-source-decoded-events")
    await c.rt.bus.produce(topic, sim.tick(t=1000.0)[0], key="gw")
    await wait_for(c, "dlq", "GET", "/api/dlq",
                   lambda s, d: s == 200 and len(d) == 1, **t)
    await c.req("dlq replay", "POST", "/api/dlq/replay", {"limit": 10}, **t)
    await c.req("dlq replay again", "POST", "/api/dlq/replay", {}, **t)
    await settle(c)
    em = c.rt.api("event-management").management("acme")
    c.note("persisted after replay", em.telemetry.total_events)


async def seg_templated(c):
    await login(c)
    await c.req("templated", "POST", "/api/tenants",
                {"token": "acme", "template": "demo"})
    await c.req("unknown template", "POST", "/api/tenants",
                {"token": "b", "template": "nope"})
    t = {"tenant": "acme"}
    await c.req("types", "GET", "/api/devicetypes", **t)
    await c.req("devices", "GET", "/api/devices?pageSize=5", **t)
    await c.req("groups", "GET", "/api/devicegroups", **t)
    await c.req("group devices", "GET",
                "/api/devicegroups/demo-floor-1/devices", **t)
    await c.req("assets", "GET", "/api/assets", **t)
    await c.req("scripts", "GET", "/api/scripts", mode="shape", **t)
    c.note("tenant sections", c.rt.tenants["acme"].sections)


async def seg_forecast(c):
    await login(c)
    cfg = {"window": 16, "horizon": 4, "hidden": 8}
    await tenant(c, "acme", {"rule-processing": {
        "model": "tft", "model_config": cfg, "buckets": [32],
        "capacity": 32}})
    await tenant(c, "zs", {"rule-processing": {
        "model": "zscore", "model_config": {"window": 8}, "buckets": [32]}})
    await tenant(c, "pl", {"rule-processing": {
        "model": "lstm-stream", "model_config": {"window": 16},
        "buckets": [32], "shared": True}})
    for tid in ("acme", "zs", "pl"):
        c.rt.api("device-management").management(tid).bootstrap_fleet(
            c.pkg.model.DeviceType(token="thermo", name="T"), 4)
        em = c.rt.api("event-management").management(tid)
        sim = c.pkg.sim.DeviceSimulator(c.pkg.sim.SimConfig(num_devices=4,
                                                            seed=1),
                                        tenant_id=tid)
        for k in range(20):
            em.telemetry.append_measurements(sim.tick(t=60.0 * k)[0])
    # the same weights in both packages' sessions
    for tid, name, mcfg in (("acme", "tft", cfg),
                            ("pl", "lstm-stream", {"window": 16})):
        params = jax.tree.map(np.asarray, jax_build(name, **mcfg).init(
            jax.random.PRNGKey(8)))
        c.rt.api("rule-processing").engine(tid).swap_model_params(
            c.pkg.place(params))
    forecasts = {}
    for label, path, tid in (
            ("tft", "/api/devices/dev-1/forecast", "acme"),
            ("tft attention", "/api/devices/dev-1/forecast?attention=true",
             "acme"),
            ("zscore", "/api/devices/dev-1/forecast", "zs"),
            ("lstm", "/api/devices/dev-2/forecast", "pl"),
            ("lstm attention", "/api/devices/dev-2/forecast?attention=1",
             "pl"),
            ("ghost device", "/api/devices/ghost/forecast", "acme")):
        status, doc = await c.http("GET", path, tenant=tid)
        if status == 200:
            forecasts[label] = {k: doc.pop(k) for k in ("forecast",
                                                         "attention")
                                if k in doc}
        c.log.append((label, status, c._norm(doc)))
    return forecasts


async def seg_instance(c):
    """Instance surfaces: metrics, Prometheus, topics, observe, traces,
    history, replay and the fleet routes (404 with no controller)."""
    await login(c)
    c.rt.tracer.sample = 1
    await tenant(c, "acme")
    c.rt.api("device-management").management("acme").bootstrap_fleet(
        c.pkg.model.DeviceType(token="thermo", name="T"), 10)
    sim = c.pkg.sim.DeviceSimulator(c.pkg.sim.SimConfig(num_devices=10),
                                    tenant_id="acme")
    receiver = c.rt.api("event-sources").engine("acme").receiver("default")
    for k in range(5):
        await receiver.submit(sim.payload(t=60.0 * k)[0])
        await settle(c)
    await beats(c)
    await c.req("metrics", "GET", "/api/instance/metrics", mode="shape",
                drop=PORT_ONLY_METRICS)
    await c.req("prometheus", "GET", "/api/instance/metrics/prometheus",
                mode="prometheus", drop=PORT_ONLY_METRICS)
    await c.req("topics", "GET", "/api/instance/topics")
    await c.req("observe", "GET", "/api/instance/observe", mode="shape")
    _, summary = await c.http("GET", "/api/instance/traces")
    # the port's host stages (its scoring dispatch and settle, its
    # collections) belong to no trace; the reference has none
    c.log.append(("trace stages", sorted(set(summary) - HOST_STAGES)))
    await c.req("trace spans", "GET",
                "/api/instance/traces/spans?stage=inbound.enrich&limit=2",
                mode="shape")
    _, spans = await c.http("GET",
                            "/api/instance/traces/spans?stage=inbound.enrich")
    tid = spans["spans"][0]["trace_id"]
    _, journey = await c.http("GET", f"/api/instance/traces/{tid}")
    c.log.append(("trace journey", [s["stage"] for s in journey["spans"]]))
    await c.req("spans bad limit", "GET",
                "/api/instance/traces/spans?limit=x")
    await c.req("history", "GET", "/api/instance/history")
    await c.req("replay", "GET", "/api/instance/replay")
    await c.req("fleet", "GET", "/api/fleet")
    await c.req("fleet forecast", "GET", "/api/fleet/forecast")
    await c.req("fleet observe", "GET", "/api/fleet/observe")
    await c.req("fleet prometheus", "GET", "/api/fleet/metrics/prometheus")
    await c.req("health", "GET", "/api/instance/health", mode="shape")


SEGMENTS = {
    "auth": seg_auth,
    "lifecycle": seg_lifecycle,
    "groups": seg_groups,
    "events": seg_events,
    "areas-customers-zones-assets": seg_model,
    "scripts-receivers-connectors": seg_scripts,
    "batch-and-train": seg_batch_train,
    "schedules-jobs": seg_schedules,
    "dlq": seg_dlq,
    "templated-tenant": seg_templated,
    "instance-surfaces": seg_instance,
}


async def _converse(pkg, seg, tmp_path):
    async with platform(pkg, faults=seg is seg_dlq) as c:
        if seg is seg_batch_train:
            await seg(c, tmp_path)
        else:
            await seg(c)
        return c.log


def _diff(got, want, path="$"):
    """The first place two logged answers differ, for the message."""
    if isinstance(got, dict) and isinstance(want, dict):
        if set(got) != set(want):
            return (f"{path}: port-only keys {sorted(set(got) - set(want))}"
                    f", jax-only keys {sorted(set(want) - set(got))}")
        for k in want:
            if got[k] != want[k]:
                return _diff(got[k], want[k], f"{path}.{k}")
    if isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)) \
            and len(got) == len(want):
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                return _diff(g, w, f"{path}[{i}]")
    return f"{path}: port {got!r:.300} != jax {want!r:.300}"


def assert_logs_equal(got, want):
    assert len(got) == len(want), ([g[0] for g in got],
                                   [w[0] for w in want])
    for g, w in zip(got, want):
        assert g == w, _diff(g, w)


@pytest.mark.parametrize("segment", list(SEGMENTS))
def test_conversation_matches_the_reference(segment, run, tmp_path):
    seg = SEGMENTS[segment]

    async def main():
        return (await _converse(JAX, seg, tmp_path),
                await _converse(PORT, seg, tmp_path))

    want, got = run(main())
    assert_logs_equal(got, want)


def test_forecast_conversation_matches_the_reference(run):
    async def converse(pkg):
        async with platform(pkg) as c:
            return c.log, await seg_forecast(c)

    async def main():
        return await converse(JAX), await converse(PORT)

    (want_log, want), (got_log, got) = run(main())
    assert_logs_equal(got_log, want_log)
    assert sorted(got) == sorted(want) == ["lstm", "tft", "tft attention"]
    for label in want:
        np.testing.assert_allclose(got[label]["forecast"],
                                   want[label]["forecast"], atol=0.05,
                                   rtol=1e-2, err_msg=label)
    np.testing.assert_allclose(got["tft attention"]["attention"],
                               want["tft attention"]["attention"], atol=1e-2)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_shutdown_with_live_keepalive_connection(pkg, run):
    """A client holding a keep-alive connection must not wedge instance
    shutdown, in either package."""
    async def main():
        rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
            instance_id="ka", rest_port=0, **pkg.settings))
        for name in ALL_SERVICES:
            rt.add_service(getattr(pkg.services, name)(rt))
        await rt.start()
        port = rt.services["instance-management"].rest.port
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /api/instance/health HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        await reader.readuntil(b"\r\n\r\n")
        await asyncio.wait_for(rt.stop(), 10)
        writer.close()

    run(main())

"""Wire RPC: the process-split deployment plane.

The reference runs as ~14 cooperating JVMs: Kafka carries the data plane
between them and per-service gRPC APIs carry the control/query plane
[SURVEY.md §1-L3, §2.1 "gRPC plumbing"]. The in-proc runtime collapses
those hops for the single-node operating point; this module restores the
process boundary when a deployment wants it, with the same two planes:

- **BusServer / RemoteEventBus** — one process hosts the `EventBus`; any
  number of peer processes attach with the full consumer-group surface
  (produce, subscribe, poll, commit, snapshot/positions, rebalance on
  leave). Records cross the socket in the restricted codec
  (kernel/codec.py) — columnar batches stay columnar.
- **ApiServer / ApiChannel** — per-service control RPC: wait-for-engine
  (the reference's `waitForApiAvailable` retry) and method calls on a
  service or tenant engine. `RemoteService` plugs into
  `ServiceRuntime.add_remote_service` so `rt.api("device-management")`
  works unchanged whether the peer is a local object or another host;
  remote method calls return awaitables (callers on potential remote
  paths guard with `inspect.isawaitable`).

Wire fast path (docs/PERFORMANCE.md): three layers turn the broker hop
from a request/response RPC benchmark into a streaming data plane —

1. **Streaming poll prefetch.** Instead of one `poll` RPC per consumer
   round (broker-side long-poll wait + a full client round trip per
   batch), a subscribed consumer grants the broker a CREDIT window of
   records; the broker pushes `deliver` frames (request id 0 = server
   push) as records land, the client `poll()` drains a local prefetch
   buffer, and drained records re-grant credit fire-and-forget. The
   broker-append→consumer-delivery path collapses to one socket write.
   Commit/fence/rebalance semantics are unchanged: the client-side
   delivered-through pin still covers exactly what `poll()` handed the
   app (never the prefetch buffer), fence tokens are validated
   broker-side exactly as before, and a rebalance or seek REVOKES the
   window — the broker emits a `revoke` push, the client drops its
   undrained buffer, and the moved partition's records re-deliver from
   committed offsets to whoever owns them now (no double delivery
   beyond today's in-flight-batch at-least-once window).
2. **Pipelined micro-batched produce.** Fire-and-forget ops
   (produce_nowait / commit / credit / close) coalesce per event-loop
   tick into ONE multi-op `batch` frame with one writev and one drain
   (Kafka linger semantics, linger=0 default: batch only what is
   already queued — nothing ever waits for company), replacing the old
   task-spawn-per-op; acks ride one batched response, and a
   FencedError inside the batch still fires `on_fenced` with the
   rejected token's identity. Awaited calls ride the same per-tick
   write queue (frames keep their enqueue order), so a commit enqueued
   before a release record can never be overtaken by it.
3. **Zero-copy codec path.** Frames are encoded as scatter-gather
   segment lists (`codec.encode_segments`) — ndarray columns ride as
   memoryviews over the live arrays, written via `writelines` — and
   the rx loops decode with `copy_arrays=False`, so delivered batch
   columns are read-only views over the received frame.

Framing: u32 body length | u32 request id | codec body. Requests carry
`{"op": ..., ...}`; responses `{"ok": result}` or `{"err": message}`.
Request ids multiplex concurrent calls; id 0 is reserved for
server-initiated push frames (`deliver`/`revoke`). This plane is
instance-internal — deploy it on the same trust boundary the reference
gives its unauthenticated internal gRPC.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from collections import deque
from typing import Any, Iterable, Optional

from sitewhere_tpu_torch.kernel import codec
from sitewhere_tpu_torch.kernel.bus import EventBus, FencedError, TopicRecord

logger = logging.getLogger(__name__)

_MAX_FRAME = codec.MAX_FRAME

# client-side fast-path defaults (InstanceSettings.wire_* overrides)
DEFAULT_PREFETCH_CREDIT = 256     # records the broker may push ahead
DEFAULT_INFLIGHT_CAP = 256        # un-acked fire-and-forget ops
_PUSH_BATCH_MAX = 256             # records per deliver frame
_DRAIN_WATERMARK = 1 << 19        # spawn a drain task past this buffer

# marker object: a fire-and-forget batch's position in the write queue
# (the frame itself is assembled at flush time, but its ORDER relative
# to awaited frames is fixed at first enqueue — a commit enqueued
# before a release publish must reach the broker first)
_BATCH_MARK = object()


def _frame(req_id: int, msg: Any) -> list:
    """One wire frame as a scatter-gather buffer list."""
    segs, total = codec.encode_segments(msg)
    if total > _MAX_FRAME:
        raise ValueError(f"frame {total} exceeds max")
    return [total.to_bytes(4, "little") + req_id.to_bytes(4, "little"),
            *segs]


class WireServer:
    """Asyncio TCP server dispatching `{"op": ...}` requests to handler
    coroutines. Subclasses populate `self.handlers`.

    `secret` (optional): shared-secret handshake — the FIRST frame of
    every connection must be `{"op": "auth", "token": <secret>}` or the
    connection is closed before any op is served. The wire plane stays
    plaintext (it mirrors the reference's internal gRPC trust model:
    same trusted network), but a listening port no longer accepts
    arbitrary peers. Compare is constant-time."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None):
        self.host, self.port = host, port
        self.secret = secret
        self.handlers: dict[str, Any] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for w in list(self._conns):
            try:
                w.close()
            except RuntimeError:
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                logger.warning("wire: handlers did not drain in 5s")
            self._server = None

    def on_disconnect(self, writer: asyncio.StreamWriter) -> None:
        """Subclass hook: a peer connection dropped."""

    async def _auth_handshake(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> bool:
        import hmac

        header = await asyncio.wait_for(reader.readexactly(8), 10.0)
        length = int.from_bytes(header[:4], "little")
        req_id = int.from_bytes(header[4:], "little")
        ok = False
        if length <= 4096:
            body = await asyncio.wait_for(reader.readexactly(length), 10.0)
            try:
                msg = codec.decode(body)
                ok = (msg.get("op") == "auth"
                      and isinstance(msg.get("token"), str)
                      and hmac.compare_digest(msg["token"], self.secret))
            except Exception:  # noqa: BLE001 - any garbage is a failed auth
                ok = False
        writer.writelines(_frame(
            req_id, {"ok": True} if ok else
            {"err": "PermissionError: wire auth failed"}))
        await writer.drain()
        return ok

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        tasks: set[asyncio.Task] = set()
        try:
            if self.secret is not None:
                if not await asyncio.wait_for(
                        self._auth_handshake(reader, writer), 15.0):
                    return
            while True:
                header = await reader.readexactly(8)
                length = int.from_bytes(header[:4], "little")
                req_id = int.from_bytes(header[4:], "little")
                if length > _MAX_FRAME:
                    raise ValueError(f"frame {length} exceeds max")
                body = await reader.readexactly(length)
                task = asyncio.create_task(
                    self._dispatch(req_id, body, writer))
                tasks.add(task)
                task.add_done_callback(tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError,
                asyncio.TimeoutError):
            pass
        finally:
            for t in tasks:
                t.cancel()
            self._conns.discard(writer)
            self.on_disconnect(writer)
            writer.close()

    async def _dispatch(self, req_id: int, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        try:
            # requests are small control frames; values inside a produce
            # decode zero-copy and the broker log then holds views over
            # this body — the frame buffer lives exactly as long as the
            # arrays referencing it
            msg = codec.decode(body, copy_arrays=False)
            handler = self.handlers[msg["op"]]
            result = await handler(msg, writer)
            payload = _frame(req_id, {"ok": result})
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - errors travel to the caller
            payload = _frame(req_id, {"err": f"{type(exc).__name__}: {exc}"})
        try:
            writer.writelines(payload)
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass  # peer went away mid-response

    async def _op_batch(self, msg, writer=None) -> list:
        """One multi-op frame (the client's per-tick coalesced
        fire-and-forget batch): ops execute IN ORDER, each isolated —
        per-op results/errors ride one batched response."""
        out = []
        for op in msg["ops"]:
            try:
                name = op["op"]
                if name == "batch":
                    raise ValueError("nested batch refused")
                out.append({"ok": await self.handlers[name](op, writer)})
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - per-op isolation
                out.append({"err": f"{type(exc).__name__}: {exc}"})
        return out


class WireClient:
    """Multiplexed request/response client (one connection, many
    outstanding calls — long-polls don't serialize).

    With `pipeline=True` (default) every outgoing frame rides a
    per-event-loop-tick write queue: frames enqueued during one tick go
    out in ONE `writelines` with at most one drain, and fire-and-forget
    ops additionally coalesce into one multi-op `batch` frame (one
    request id, one batched ack). `linger_ms` > 0 widens the window
    Kafka-producer style; 0 (default) batches only what is already
    queued. `inflight_cap` bounds un-acked fire-and-forget ops: past
    it, further ops stay queued client-side and `backlogged` turns on —
    the signal the egress commit barrier surfaces so consumer loops
    pause instead of growing an unbounded op queue against a stalled
    broker (the old task-per-op spawn grew the task set without
    limit)."""

    def __init__(self, host: str, port: int, secret: Optional[str] = None,
                 *, pipeline: bool = True, linger_ms: float = 0.0,
                 inflight_cap: int = DEFAULT_INFLIGHT_CAP):
        self.host, self.port = host, port
        self.secret = secret
        self.pipeline = pipeline
        self.linger_ms = max(float(linger_ms), 0.0)
        self.inflight_cap = max(int(inflight_cap), 1)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._req_ids = itertools.count(1)
        self._rx_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        self._dead = False   # kill(): crash fidelity — no reconnects
        # fire-and-forget RPCs (commit/close/produce_nowait) park here so
        # they are neither GC'd mid-flight nor silently raced by close();
        # `flush_background()` awaits them at orderly shutdown
        self._bg: set[asyncio.Task] = set()
        # fencing notification for fire-and-forget paths: a background
        # commit rejected with FencedError cannot raise into the caller,
        # so the runtime registers a callback(tenant, epoch) here instead
        # (ServiceRuntime wires it to FenceState.mark_fenced)
        self.on_fenced = None
        # pipelined write queue: frames (buffer lists) + batch marks
        self._wq: list = []
        self._mark_queued = False
        self._ff_ops: list[dict] = []   # queued fire-and-forget ops
        self._ff_inflight = 0           # written, awaiting the batch ack
        self._flush_scheduled = False
        self._drain_task: Optional[asyncio.Task] = None
        # server-push routing (prefetch): cid -> handler(msg). Pushes
        # for a cid whose subscribe response hasn't landed yet park in
        # _orphan_pushes until the consumer registers; pushes for a
        # cid the client already closed are dropped (the broker's
        # close_consumer is in flight — parking them would leak a
        # credit window per closed consumer).
        self._push_handlers: dict[int, Any] = {}
        self._orphan_pushes: dict[int, list] = {}
        self._closed_cids: set[int] = set()
        # observability hooks (RemoteEventBus wires the registry)
        self.coalesce_counter = None    # wire.frames_coalesced
        self.coalesce_gauge = None      # wire.linger_batches
        self.frames_coalesced_total = 0

    # -- connection ---------------------------------------------------------

    async def connect(self, timeout: float = 10.0,
                      retry_interval: float = 0.2) -> None:
        """Connect with wait-for-available retry (the peer may still be
        starting — reference: ApiChannel.waitForApiAvailable)."""
        if self._dead:
            raise ConnectionError("wire client killed")
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port)
                break
            except OSError:
                if asyncio.get_event_loop().time() > deadline:
                    raise
                await asyncio.sleep(retry_interval)
        self._rx_task = asyncio.create_task(self._rx_loop(),
                                            name=f"wire-rx-{self.port}")
        if self.secret is not None:
            # must be the connection's first frame: bypass the write
            # queue (a queued fire-and-forget batch must not precede it)
            await self.call("auth", _immediate=True, token=self.secret)

    async def _rx_loop(self) -> None:
        try:
            while True:
                header = await self._reader.readexactly(8)
                length = int.from_bytes(header[:4], "little")
                req_id = int.from_bytes(header[4:], "little")
                body = await self._reader.readexactly(length)
                if req_id == 0:
                    # server push (prefetch deliver/revoke): decode here
                    # — zero-copy, the delivered columns are views over
                    # this body — and route to the consumer's buffer
                    try:
                        self._dispatch_push(
                            codec.decode(body, copy_arrays=False))
                    except Exception:  # noqa: BLE001 - a bad push is logged
                        logger.exception("wire: bad push frame")
                    continue
                fut = self._pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    fut.set_result(body)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("wire peer closed"))
            self._pending.clear()

    def _dispatch_push(self, msg: dict) -> None:
        cid = msg.get("cid")
        handler = self._push_handlers.get(cid)
        if handler is not None:
            handler(msg)
            return
        if cid in self._closed_cids:
            return  # consumer closed; broker-side reap is in flight
        # subscribe response still in flight: park (bounded by the
        # credit window the server enforces)
        self._orphan_pushes.setdefault(cid, []).append(msg)

    def register_push(self, cid: int, handler) -> None:
        """Bind a consumer's push handler; drains any pushes that beat
        the subscribe response across the socket."""
        self._push_handlers[cid] = handler
        for msg in self._orphan_pushes.pop(cid, ()):
            handler(msg)

    def unregister_push(self, cid: int) -> None:
        self._push_handlers.pop(cid, None)
        self._orphan_pushes.pop(cid, None)
        self._closed_cids.add(cid)

    # -- pipelined writes ---------------------------------------------------

    def _schedule_flush(self) -> None:
        if self._flush_scheduled:
            return
        self._flush_scheduled = True
        loop = asyncio.get_running_loop()
        if self.linger_ms > 0:
            loop.call_later(self.linger_ms / 1e3, self._do_flush)
        else:
            # linger=0: the callback runs next loop iteration, so
            # everything enqueued during THIS tick coalesces
            loop.call_soon(self._do_flush)

    def _do_flush(self) -> None:
        self._flush_scheduled = False
        if self._dead:
            self._wq.clear()
            self._ff_ops.clear()
            self._mark_queued = False
            return
        if self._writer is None:
            if self._wq or self._ff_ops:
                self.spawn(self._connect_then_flush())
            return
        out: list = []
        rest: Optional[list] = None
        for i, item in enumerate(self._wq):
            if item is _BATCH_MARK:
                budget = self.inflight_cap - self._ff_inflight
                if budget <= 0:
                    # capped: this batch AND every later frame hold, so
                    # a commit can never be overtaken by a release
                    rest = self._wq[i:]
                    break
                ops = self._ff_ops[:budget]
                del self._ff_ops[:len(ops)]
                bufs, accepted = self._batch_frame(ops)
                self._ff_inflight += accepted
                out.extend(bufs)
                if self._ff_ops:
                    rest = self._wq[i:]  # keep the mark for the rest
                    break
                self._mark_queued = False
            else:
                out.extend(item)
        self._wq = rest if rest is not None else []
        if not out:
            return
        try:
            self._writer.writelines(out)
        except (ConnectionError, RuntimeError):
            return  # rx loop / close() surface the failure to callers
        transport = self._writer.transport
        if (self._drain_task is None and transport is not None
                and transport.get_write_buffer_size() > _DRAIN_WATERMARK):
            self._drain_task = asyncio.get_running_loop().create_task(
                self._drain_once())

    async def _drain_once(self) -> None:
        try:
            if self._writer is not None:
                await self._writer.drain()
        except (ConnectionError, RuntimeError):
            pass
        finally:
            self._drain_task = None

    async def _connect_then_flush(self) -> None:
        try:
            async with self._lock:
                if self._writer is None:
                    await self.connect()
        except (OSError, ConnectionError):
            dropped = len(self._ff_ops)
            self._wq.clear()
            self._ff_ops.clear()
            self._mark_queued = False
            if dropped:
                logger.warning("wire: dropped %d queued fire-and-forget "
                               "op(s) — broker unreachable", dropped)
            return
        self._schedule_flush()

    def _batch_frame(self, ops: list[dict]) -> tuple[list, int]:
        """Assemble the coalesced multi-op frame. Returns (buffers,
        accepted op count) — the accounting future/task registers ONLY
        for ops whose frame actually encoded, so one unencodable value
        (or an oversize combined frame) can never leak in-flight budget
        or orphan an ack waiter: the poison op is dropped loudly and
        the rest ride per-op frames."""
        try:
            bufs = _frame(0, {"op": "batch", "ops": ops})
        except Exception:  # noqa: BLE001 - isolate the poison op(s)
            bufs = []
            good: list[dict] = []
            for op in ops:
                try:
                    bufs.extend(self._register_batch([op]))
                except Exception:  # noqa: BLE001 - dropped, loudly
                    logger.warning(
                        "wire: dropped unencodable fire-and-forget "
                        "%s op", op.get("op"), exc_info=True)
                else:
                    good.append(op)
            return bufs, len(good)
        # common case: one frame, one ack task, encoded before any
        # accounting moved
        return self._register_batch(ops, prebuilt=bufs), len(ops)

    def _register_batch(self, ops: list[dict],
                        prebuilt: Optional[list] = None) -> list:
        bufs = prebuilt if prebuilt is not None \
            else _frame(0, {"op": "batch", "ops": ops})
        req_id = next(self._req_ids)
        # stamp the real request id into the prebuilt header
        bufs[0] = bufs[0][:4] + req_id.to_bytes(4, "little")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        self.spawn(self._finish_batch(fut, ops))
        n = len(ops)
        if n > 1:
            self.frames_coalesced_total += n
            if self.coalesce_counter is not None:
                self.coalesce_counter.inc(n)
        if self.coalesce_gauge is not None:
            self.coalesce_gauge.set(n)
        return bufs

    async def _finish_batch(self, fut: asyncio.Future,
                            ops: list[dict]) -> None:
        """Process one batched ack: per-op errors resolve exactly like
        the old task-per-op done callbacks (FencedError → on_fenced with
        the rejected token's identity). Decrements clamp at zero:
        close() already zeroes the in-flight count while these tasks
        still hold their op batches, and a negative count would disable
        the backpressure cap on a reconnected client."""
        try:
            body = await fut
        except (ConnectionError, asyncio.CancelledError):
            self._ff_inflight = max(self._ff_inflight - len(ops), 0)
            raise
        self._ff_inflight = max(self._ff_inflight - len(ops), 0)
        try:
            msg = codec.decode(body, copy_arrays=False)
            results = msg["ok"] if "ok" in msg else []
            if "err" in msg:
                logger.debug("wire batch failed remotely: %s", msg["err"])
            for op, res in zip(ops, results):
                err = res.get("err") if isinstance(res, dict) else None
                if err is None:
                    continue
                if str(err).startswith("FencedError:") \
                        and self.on_fenced is not None:
                    tok = op.get("fence") or [None, None]
                    self.on_fenced(tok[0],
                                   tok[1] if len(tok) > 1 else None)
                else:
                    logger.debug("wire batched %s failed: %s",
                                 op.get("op"), err)
        finally:
            if self._ff_ops and not self._flush_scheduled:
                # cap headroom just opened: move the queued remainder
                self._schedule_flush()

    # -- calls --------------------------------------------------------------

    @property
    def ff_pending(self) -> int:
        """Fire-and-forget ops not yet acked (queued + in flight)."""
        return len(self._ff_ops) + self._ff_inflight

    @property
    def backlogged(self) -> bool:
        """Fire-and-forget backpressure: the op window is full (stalled
        or slow broker). Producers with a commit barrier pause on this
        instead of queueing without bound."""
        return self.ff_pending >= self.inflight_cap

    async def call(self, op: str, _immediate: bool = False,
                   _sent: Optional[list] = None, **kwargs: Any) -> Any:
        """One awaited RPC. `_sent` (optional, a mutable list) is the
        publish-settlement probe `produce_settled` threads through
        `RemoteEventBus.produce`: it becomes truthy the moment the
        frame is ON THE SOCKET (a written frame on a live connection
        will be processed by the broker even if this caller is
        cancelled while awaiting the ack), and a cancellation that
        lands while the frame is still queued (capped behind a
        fire-and-forget batch) WITHDRAWS it — the op then observably
        never happened. Cancellation is thereby unambiguous: probe set
        → the broker will see the op; probe unset → it never will."""
        await self._connected()
        req_id, frame, fut = self._write_call(op, kwargs, _immediate, _sent)
        if not self.pipeline or _immediate:
            await self._writer.drain()
        try:
            body = await fut
        except asyncio.CancelledError:
            if _sent is not None and not _sent:
                # the frame never reached the socket (capped behind a
                # stalled batch): withdraw it, unless a flush wrote it
                # between the cap check and this cancellation
                for i, f in enumerate(self._wq):
                    if f is frame:
                        del self._wq[i]
                        self._pending.pop(req_id, None)
                        break
                else:
                    _sent.append(True)  # flushed since: it WILL land
            raise
        return self._answer(op, kwargs, body)

    async def call_started(self, op: str, **kwargs: Any) -> asyncio.Future:
        """Write one RPC's frame now, as `call` does at its first step,
        and return the future of its answer (what `call` returns or
        raises). The future outlives a cancelled awaiter (await it under
        `asyncio.shield`), so the caller can still act on what the
        broker did."""
        await self._connected()
        _, _, fut = self._write_call(op, kwargs, False, None)
        answer = asyncio.get_running_loop().create_future()

        def settle(f: asyncio.Future) -> None:
            if answer.done():
                return
            if f.cancelled():
                answer.cancel()
            elif f.exception() is not None:
                answer.set_exception(f.exception())
            else:
                try:
                    answer.set_result(self._answer(op, kwargs, f.result()))
                except Exception as exc:  # noqa: BLE001 - the call's own
                    answer.set_exception(exc)

        fut.add_done_callback(settle)
        return answer

    async def _connected(self) -> None:
        if self._dead:
            raise ConnectionError("wire client killed")
        if self._writer is None:
            async with self._lock:
                if self._writer is None:
                    await self.connect()

    def _write_call(self, op: str, kwargs: dict, immediate: bool,
                    sent: Optional[list]) -> tuple:
        req_id = next(self._req_ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        frame = _frame(req_id, {"op": op, **kwargs})
        if self.pipeline and not immediate:
            # awaited calls flush NOW (an RPC must never wait out a
            # long event-loop tick — measured: deferring these to the
            # tick-end callback serialized the egress shard's awaited
            # produces at one per tick and cost 17% fleet saturation),
            # carrying any queued fire-and-forget batch ahead of them
            # in enqueue order — a commit queued before a release
            # publish still reaches the broker first
            self._wq.append(frame)
            self._do_flush()
            if sent is not None \
                    and not any(f is frame for f in self._wq):
                sent.append(True)
        else:
            self._writer.writelines(frame)
            if sent is not None:
                sent.append(True)
        return req_id, frame, fut

    @staticmethod
    def _answer(op: str, kwargs: dict, body) -> Any:
        msg = codec.decode(body, copy_arrays=False)
        if "err" in msg:
            if str(msg["err"]).startswith("FencedError:"):
                # the broker rejected a stale-epoch data-path write:
                # surface the DISTINCT error — with the rejected token's
                # identity — so the worker treats it as "I am no longer
                # the owner" instead of a retryable fault
                tok = kwargs.get("fence") or [None, None]
                raise FencedError(str(msg["err"]), tenant=tok[0],
                                  epoch=tok[1] if len(tok) > 1 else None)
            raise RuntimeError(f"wire call {op} failed remotely: {msg['err']}")
        return msg["ok"]

    def call_nowait(self, op: str, **kwargs: Any) -> None:
        """Fire-and-forget op on the coalescing path: rides this tick's
        multi-op batch frame. Never blocks; never spawns a task per op
        (the pre-fast-path design did, and a stalled broker grew the
        task set without limit — now the op queue is the only growth,
        and `backlogged` gates it)."""
        if self._dead:
            return
        if not self.pipeline:
            # legacy path (the A/B off leg): one spawned RPC per op
            self.spawn(self.call(op, **kwargs))
            return
        self._ff_ops.append({"op": op, **kwargs})
        if not self._mark_queued:
            self._wq.append(_BATCH_MARK)
            self._mark_queued = True
        self._schedule_flush()

    def spawn(self, coro) -> asyncio.Task:
        """Run a fire-and-forget coroutine, retained until done."""
        task = asyncio.get_running_loop().create_task(coro)
        self._bg.add(task)

        def done(t: asyncio.Task) -> None:
            self._bg.discard(t)
            if not t.cancelled() and t.exception() is not None:
                exc = t.exception()
                if isinstance(exc, FencedError) and self.on_fenced is not None:
                    # a fire-and-forget commit/produce was fenced: the
                    # worker must learn it lost the tenant even though
                    # no caller was awaiting this RPC. The rejected
                    # token's epoch rides along so a LATE rejection of
                    # an old grant can't fence a fresh re-adoption.
                    self.on_fenced(exc.tenant, exc.epoch)
                logger.debug("wire background call failed: %r", exc)

        task.add_done_callback(done)
        return task

    async def flush_background(self, timeout: float = 5.0) -> None:
        """Let queued/in-flight fire-and-forget work (final commits,
        consumer closes, the tick batch) land before teardown."""
        deadline = time.monotonic() + timeout
        while (self._ff_ops or self._ff_inflight) \
                and time.monotonic() < deadline and not self._dead:
            if self._ff_ops and not self._flush_scheduled:
                try:
                    self._schedule_flush()
                except RuntimeError:
                    break  # no running loop
            await asyncio.sleep(0.005)
        if self._bg:
            await asyncio.wait(list(self._bg),
                               timeout=max(deadline - time.monotonic(),
                                           0.05))

    def close(self) -> None:
        # a caller may be parked inside call(): resolve its future with a
        # connection error instead of leaving it waiting forever
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("wire client closed"))
        self._pending.clear()
        dropped = len(self._ff_ops)
        if dropped:
            logger.debug("wire: %d queued fire-and-forget op(s) dropped "
                         "at close", dropped)
        self._wq.clear()
        self._ff_ops.clear()
        self._mark_queued = False
        self._ff_inflight = 0
        self._push_handlers.clear()
        self._orphan_pushes.clear()
        if self._drain_task is not None:
            self._drain_task.cancel()
            self._drain_task = None
        if self._rx_task is not None:
            self._rx_task.cancel()
            self._rx_task = None
        if self._writer is not None:
            try:
                self._writer.close()
            except RuntimeError:
                pass
            self._writer = None

    def kill(self) -> None:
        """Crash-fidelity close (tests, SIGKILL stand-ins): the
        connection drops NOW, every later call raises ConnectionError,
        and nothing reconnects — the broker sees exactly what a killed
        process would leave behind."""
        self._dead = True
        self.close()


# ---------------------------------------------------------------------------
# data plane: the bus over the wire
# ---------------------------------------------------------------------------


class _PrefetchState:
    """Broker-side credit window for one prefetching consumer."""

    __slots__ = ("credit", "wake", "task")

    def __init__(self, credit: int):
        self.credit = int(credit)
        self.wake = asyncio.Event()
        self.task: Optional[asyncio.Task] = None


class BusServer(WireServer):
    """Host an `EventBus` for remote peers (the broker process)."""

    def __init__(self, bus: EventBus, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None):
        super().__init__(host, port, secret=secret)
        self.bus = bus
        self._consumers: dict[int, Any] = {}
        self._by_conn: dict[asyncio.StreamWriter, set[int]] = {}
        self._cids = itertools.count(1)
        self._prefetch: dict[int, _PrefetchState] = {}
        self.handlers = {
            "produce": self._op_produce,
            "subscribe": self._op_subscribe,
            "poll": self._op_poll,
            "commit": self._op_commit,
            "credit": self._op_credit,
            "batch": self._op_batch,
            "positions": self._op_positions,
            "seek_begin": self._op_seek_begin,
            "close_consumer": self._op_close,
            "end_offsets": self._op_end_offsets,
            "topic_names": self._op_topic_names,
            "group_lags": self._op_group_lags,
            "bus_stats": self._op_bus_stats,
        }

    async def _op_produce(self, msg, writer=None) -> tuple[int, int]:
        # `fence` rides the op verbatim; the EventBus authority rejects
        # stale-epoch writes and the FencedError travels back as the
        # distinct error string the client re-raises typed
        return await self.bus.produce(msg["topic"], msg["value"],
                                      key=msg.get("key"),
                                      partition=msg.get("partition"),
                                      fence=msg.get("fence"))

    async def _op_subscribe(self, msg, writer=None) -> int:
        # `owner` tags the membership with the fleet worker id, so a
        # controller death declaration evicts the dead worker's members
        # broker-side (EventBus.evict_owner) instead of letting a
        # SIGSTOPped zombie stall its partitions until SIGCONT
        consumer = self.bus.subscribe(msg["topics"], group=msg["group"],
                                      name=msg.get("name"),
                                      owner=msg.get("owner"))
        if msg.get("seek"):
            # seek-from-beginning decided before the subscribe landed
            # (replay consumers): apply it BEFORE any push delivery, so
            # the stream starts at the beginning instead of mixing
            # committed-position rows with replayed ones
            consumer.seek_to_beginning()
        cid = next(self._cids)
        self._consumers[cid] = consumer
        if writer is not None:
            # bind the consumer to its connection: a dropped peer leaves
            # its groups (rebalance) instead of starving them
            self._by_conn.setdefault(writer, set()).add(cid)
        credit = int(msg.get("prefetch") or 0)
        if credit > 0 and writer is not None:
            # streaming prefetch: the broker pushes deliver frames under
            # the client's credit window instead of answering poll RPCs
            st = _PrefetchState(credit)
            self._prefetch[cid] = st
            st.task = asyncio.get_running_loop().create_task(
                self._push_loop(cid, consumer, writer, st),
                name=f"wire-push-{cid}")
            # supervise: _push_loop handles the expected failure modes,
            # but an unexpected escape would otherwise die silently and
            # wedge this consumer's prefetch credit — the client keeps
            # waiting for pushes that will never come
            st.task.add_done_callback(self._push_loop_done)
        return cid

    @staticmethod
    def _push_loop_done(task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            logger.error("wire push loop %s died unexpectedly — the "
                         "consumer's prefetch stream is wedged",
                         task.get_name(), exc_info=task.exception())

    def _push_frame(self, writer: asyncio.StreamWriter, msg: dict) -> None:
        writer.writelines(_frame(0, msg))

    async def _push_loop(self, cid: int, consumer, writer,
                         st: _PrefetchState) -> None:
        """Stream records to one prefetching consumer while it has
        credit. The whole poll→frame-write step is atomic wrt the event
        loop after the poll resolves, so a rebalance/seek either lands
        before a delivery (its revoke precedes the re-fetched rows) or
        after it (the revoke follows the stale rows) — the client drops
        its undrained buffer on revoke either way, and the dropped rows
        re-deliver from committed offsets."""
        gen = getattr(consumer, "_generation", -1)
        try:
            while not getattr(consumer, "_closed", False):
                if st.credit <= 0:
                    st.wake.clear()
                    if st.credit <= 0:
                        try:
                            await asyncio.wait_for(st.wake.wait(), 1.0)
                        except asyncio.TimeoutError:
                            pass  # re-check closed/credit
                    continue
                n = min(st.credit, _PUSH_BATCH_MAX)
                records = await consumer.poll(max_records=n, timeout=0.5)
                if records and len(records) < n:
                    # scoop the same tick's remaining appends into this
                    # frame: the wake fires on the FIRST append of a
                    # burst, and one frame per record would pay encode +
                    # header + rx-decode per record under flood (the
                    # old poll RPC amortized a round trip's worth per
                    # response; one yield buys the same batching)
                    await asyncio.sleep(0)
                    records += consumer.poll_nowait(n - len(records))
                if consumer._generation != gen:
                    # REVOKE before delivering post-rebalance rows: the
                    # client's undrained window is stale (positions
                    # reset to committed broker-side) — a moved
                    # partition must not double-deliver through it
                    gen = consumer._generation
                    self._push_frame(writer, {"op": "revoke", "cid": cid,
                                              "gen": gen})
                if records:
                    st.credit -= len(records)
                    rows = [[r.topic, r.partition, r.offset, r.key,
                             r.value, r.timestamp] for r in records]
                    self._push_frame(writer, {"op": "deliver", "cid": cid,
                                              "rows": rows})
                    await writer.drain()
        except (ConnectionError, ConnectionResetError, RuntimeError):
            pass  # peer gone: on_disconnect reaps the consumer
        except asyncio.CancelledError:
            pass

    async def _op_credit(self, msg, writer=None) -> bool:
        st = self._prefetch.get(msg["cid"])
        if st is not None:
            st.credit += int(msg["n"])
            st.wake.set()
        return True

    async def _op_poll(self, msg, writer=None) -> list:
        consumer = self._consumers[msg["cid"]]
        records = await consumer.poll(max_records=msg["max_records"],
                                      timeout=msg["timeout"])
        return [[r.topic, r.partition, r.offset, r.key, r.value, r.timestamp]
                for r in records]

    async def _op_commit(self, msg, writer=None) -> bool:
        positions = msg.get("positions")
        if positions is not None:
            positions = {(t, p): off for t, p, off in positions}
        self._consumers[msg["cid"]].commit(positions, fence=msg.get("fence"))
        return True

    async def _op_positions(self, msg, writer=None) -> list:
        snap = self._consumers[msg["cid"]].snapshot_positions()
        return [[t, p, off] for (t, p), off in snap.items()]

    async def _op_seek_begin(self, msg, writer=None) -> bool:
        cid = msg["cid"]
        self._consumers[cid].seek_to_beginning()
        st = self._prefetch.get(cid)
        if st is not None and writer is not None:
            # prefetch: anything already pushed (or queued on the
            # socket) predates the seek — revoke so the client drops it
            # and the stream restarts from the beginning
            self._push_frame(writer, {"op": "revoke", "cid": cid,
                                      "gen": -1})
            st.wake.set()
        return True

    def _reap_prefetch(self, cid: int) -> None:
        st = self._prefetch.pop(cid, None)
        if st is not None and st.task is not None:
            st.task.cancel()

    async def _op_close(self, msg, writer=None) -> bool:
        self._reap_prefetch(msg["cid"])
        consumer = self._consumers.pop(msg["cid"], None)
        if consumer is not None:
            consumer.close()
        return True

    async def _op_end_offsets(self, msg, writer=None) -> list:
        return self.bus.end_offsets(msg["topic"])

    async def _op_topic_names(self, msg, writer=None) -> list:
        return self.bus.topic_names()

    async def _op_group_lags(self, msg, writer=None) -> dict:
        # committed-vs-head lag per consumer group — the fleet
        # controller's autoscaling input, served to any wire peer that
        # wants the broker's central view (observe/fleet tooling)
        return self.bus.group_lags()

    async def _op_bus_stats(self, msg, writer=None) -> dict:
        # the broker's own health surface (per-topic depth, per-group
        # lag + membership, fence rejections, members evicted) — the
        # FleetObserver / `GET /api/fleet` block that closes the
        # "broker is a black box" gap (docs/OBSERVABILITY.md)
        return self.bus.stats()

    def on_disconnect(self, writer: asyncio.StreamWriter) -> None:
        for cid in self._by_conn.pop(writer, ()):
            self._reap_prefetch(cid)
            consumer = self._consumers.pop(cid, None)
            if consumer is not None:
                consumer.close()

    async def stop(self) -> None:
        for cid in list(self._prefetch):
            self._reap_prefetch(cid)
        await super().stop()


class RemoteBusConsumer:
    """Client-side consumer handle; mirrors `BusConsumer`'s surface.

    Two delivery modes share it: the legacy poll RPC (prefetch off) and
    the streaming prefetch buffer (deliver frames land in `_buf` from
    the rx loop; `poll()` drains it locally and re-grants credit)."""

    def __init__(self, client: WireClient, cid: int, group: str, name: str,
                 tracer=None, prefetch: bool = False,
                 prefetch_credit: int = DEFAULT_PREFETCH_CREDIT):
        self._client = client
        self.cid = cid
        self.group = group
        self.name = name
        # trace spine (kernel/tracing.py): when the owning runtime set a
        # tracer on the RemoteEventBus, every delivered record whose
        # value carries a BatchContext records a `wire.poll` span — the
        # broker-hop queue wait (append wall time → delivery) that used
        # to be dark in a split deployment's critical path. Under
        # prefetch the span measures broker append → CREDIT DELIVERY
        # (the deliver frame's arrival), not drain time: time a record
        # then spends in the local prefetch buffer belongs to this
        # process, not the broker hop (docs/OBSERVABILITY.md).
        self.tracer = tracer
        self._closed = False
        self._prefetch = bool(prefetch)
        self._credit = max(int(prefetch_credit), 1)
        # prefetch buffer: (row, arrive_monotonic, arrive_wall) — the
        # arrival stamps are captured when the deliver frame lands
        self._buf: deque = deque()
        self._buf_wake = asyncio.Event()
        self._to_regrant = 0
        # delivered-through positions, tracked CLIENT-side: a bare
        # commit() must pin exactly what THIS PROCESS'S poll() handed
        # the app — never the broker consumer's positions (which run a
        # full credit window ahead under prefetch), and never the
        # prefetch buffer. A SIGKILL between delivery and drain then
        # redelivers instead of losing the window (the fleet kill drill
        # lost exactly one in-flight poll batch per killed consumer
        # before this pin existed; with prefetch the stake is the whole
        # credit window).
        self._delivered: dict[tuple[str, int], int] = {}

    # -- prefetch push path -------------------------------------------------

    def _on_push(self, msg: dict) -> None:
        op = msg.get("op")
        if op == "deliver":
            now_m = time.monotonic()
            now_w = time.time()
            for row in msg.get("rows") or ():
                self._buf.append((row, now_m, now_w))
            self._buf_wake.set()
        elif op == "revoke":
            # rebalance/seek revoked the credit window: drop the
            # undrained buffer — those rows re-deliver from committed
            # offsets (to this member or to whoever owns the partition
            # now) — and give their credit back
            dropped = len(self._buf)
            self._buf.clear()
            if dropped:
                self._regrant(dropped)

    def _regrant(self, n: int) -> None:
        self._to_regrant += n
        if self._to_regrant >= max(self._credit // 2, 1) \
                and self.cid >= 0 and not self._closed:
            try:
                self._client.call_nowait("credit", cid=self.cid,
                                         n=self._to_regrant)
                self._to_regrant = 0
            except RuntimeError:
                pass  # no loop (teardown): the window just stays shut

    def _drain_buffer(self, max_records: int) -> list[TopicRecord]:
        out: list[TopicRecord] = []
        tracer = self.tracer
        while self._buf and len(out) < max_records:
            (t, p, off, key, value, ts), arr_m, arr_w = self._buf.popleft()
            # cross-process: the producer stamped ctx.ingest_monotonic
            # in ITS monotonic epoch — re-stamp at delivery into this
            # process, so downstream latency measures from broker
            # handoff (buffer residency included: that queue is ours)
            ctx = getattr(value, "ctx", None)
            if ctx is not None and hasattr(ctx, "ingest_monotonic"):
                ctx.ingest_monotonic = arr_m
                if tracer is not None and ctx.trace_id \
                        and tracer.sampled(ctx.trace_id):
                    # broker append → credit delivery, wall clocks
                    # (no monotonic epoch spans processes; same-host
                    # skew is µs — docs/OBSERVABILITY.md)
                    wait = max(arr_w - ts, 0.0)
                    try:
                        n = len(value)
                    except TypeError:
                        n = 0
                    tracer.record(ctx.trace_id, "wire.poll",
                                  ctx.tenant_id, arr_m - wait, wait, n)
            self._delivered[(t, p)] = off + 1
            out.append(TopicRecord(t, p, off, key, value, ts))
        if out:
            self._regrant(len(out))
        return out

    async def poll(self, *, max_records: int = 512,
                   timeout: float = 1.0) -> list[TopicRecord]:
        if self._closed:
            return []
        if self._prefetch:
            # drain the local prefetch buffer; deliver frames land in it
            # straight from the rx loop (no RPC round trip per poll)
            await asyncio.sleep(0)  # always yield, like BusConsumer.poll
            if not self._buf:
                deadline = time.monotonic() + timeout
                while not self._buf and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._buf_wake.clear()
                    if self._buf:
                        break
                    try:
                        await asyncio.wait_for(self._buf_wake.wait(),
                                               remaining)
                    except asyncio.TimeoutError:
                        break
            return self._drain_buffer(max_records)
        rows = await self._client.call("poll", cid=self.cid,
                                       max_records=max_records,
                                       timeout=timeout)
        now = time.monotonic()
        now_wall = time.time()
        out = []
        for t, p, off, key, value, ts in rows:
            # legacy path: re-stamp at wire decode (see _drain_buffer)
            ctx = getattr(value, "ctx", None)
            if ctx is not None and hasattr(ctx, "ingest_monotonic"):
                ctx.ingest_monotonic = now
                if self.tracer is not None and ctx.trace_id \
                        and self.tracer.sampled(ctx.trace_id):
                    wait = max(now_wall - ts, 0.0)
                    try:
                        n = len(value)
                    except TypeError:
                        n = 0
                    self.tracer.record(ctx.trace_id, "wire.poll",
                                       ctx.tenant_id, now - wait, wait, n)
            self._delivered[(t, p)] = off + 1
            out.append(TopicRecord(t, p, off, key, value, ts))
        return out

    def commit(self, positions: Optional[dict] = None, *,
               fence=None) -> None:
        if positions is None:
            positions = self._delivered
        rows = [[t, p, off] for (t, p), off in positions.items()]
        # fire-and-forget: rides this tick's coalesced batch frame; a
        # FencedError in the batched ack resolves through the client's
        # on_fenced callback, since no caller awaits this op
        try:
            self._client.call_nowait("commit", cid=self.cid, positions=rows,
                                     fence=fence)
        except RuntimeError:
            pass  # no loop (teardown)

    def snapshot_positions(self):
        if self._prefetch:
            # under prefetch the broker-side consumer's positions run a
            # full credit window AHEAD of this process (the push loop
            # reads ahead into the client buffer) — a checkpoint built
            # from them would commit records poll() never handed the
            # app, and a kill in that window would LOSE them. The
            # client-side delivered-through map IS the snapshot; plain
            # dict (callers guard with inspect.isawaitable).
            return dict(self._delivered)
        # legacy RPC mode: broker positions advance only by serving
        # this client's poll calls, so the remote snapshot equals
        # delivered-through; expose the coroutine for callers to await
        return self._snapshot()

    def delivered_positions(self) -> dict:
        """Synchronous copy of the CLIENT-side delivered-through map
        (what a bare commit() would pin) — for callers that cannot
        await (the clean-handoff commit-through)."""
        return dict(self._delivered)

    async def _snapshot(self) -> dict:
        rows = await self._client.call("positions", cid=self.cid)
        return {(t, p): off for t, p, off in rows}

    def seek_to_beginning(self) -> None:
        self._delivered.clear()  # positions reset with the seek
        # prefetch: the broker answers the seek with a revoke push, so
        # rows delivered before it are dropped client-side and the
        # stream restarts from the beginning — no mixing
        try:
            self._client.call_nowait("seek_begin", cid=self.cid)
        except RuntimeError:
            pass

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._buf.clear()
            self._buf_wake.set()
            if self.cid >= 0:
                self._client.unregister_push(self.cid)
            try:
                self._client.call_nowait("close_consumer", cid=self.cid)
            except RuntimeError:
                pass  # no loop (interpreter teardown) — server reaps on drop


class RemoteEventBus:
    """Client-side `EventBus`: the produce/subscribe surface services
    use, backed by a broker process's `BusServer`.

    Lifecycle-wise it is a leaf component stand-in: `ServiceRuntime`
    accepts it via its `bus=` parameter and starts/stops it like the
    in-proc bus.

    Fast-path levers (InstanceSettings.wire_*): `prefetch` +
    `prefetch_credit` engage the streaming poll path, `pipeline` +
    `linger_ms` the per-tick coalesced writes, `inflight_cap` the
    fire-and-forget backpressure bound. All on by default; the A/B off
    leg (`bench.py --no-wire-fastpath`) restores the PR-8
    request/response plane bit for bit."""

    def __init__(self, host: str, port: int, secret: Optional[str] = None,
                 *, prefetch: bool = True,
                 prefetch_credit: int = DEFAULT_PREFETCH_CREDIT,
                 pipeline: bool = True, linger_ms: float = 0.0,
                 inflight_cap: int = DEFAULT_INFLIGHT_CAP):
        self.host, self.port = host, port
        self._client = WireClient(host, port, secret=secret,
                                  pipeline=pipeline, linger_ms=linger_ms,
                                  inflight_cap=inflight_cap)
        self.prefetch = bool(prefetch)
        self.prefetch_credit = max(int(prefetch_credit), 1)
        # fleet worker id: set by the worker entry (fleet/worker_main)
        # so every membership this process registers is owner-tagged —
        # the broker's death-declaration eviction needs the attribution
        self.owner: Optional[str] = None
        # trace spine: ServiceRuntime sets its Tracer here so the
        # broker hop records `wire.produce` / `wire.poll` spans for
        # traced batches — the cross-process trace stays ONE trace with
        # the hop's queue wait attributed (docs/OBSERVABILITY.md)
        self.tracer = None
        self._metrics = None

    # -- observability ------------------------------------------------------

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, registry) -> None:
        """ServiceRuntime wires its registry here: the fast path's
        gauges/counters (`wire.prefetch_credit`, `wire.linger_batches`,
        `wire.frames_coalesced`) land beside every other signal."""
        self._metrics = registry
        if registry is not None:
            registry.gauge("wire.prefetch_credit").set(
                self.prefetch_credit if self.prefetch else 0)
            self._client.coalesce_gauge = registry.gauge(
                "wire.linger_batches")
            self._client.coalesce_counter = registry.counter(
                "wire.frames_coalesced")

    @property
    def backlogged(self) -> bool:
        """Fire-and-forget op window full (stalled broker): the egress
        stage folds this into its commit-barrier `backlogged`, so
        consumer loops pause instead of queueing without bound."""
        return self._client.backlogged

    def wire_stats(self) -> dict:
        """Client-side fast-path surface (heartbeat signals, tests)."""
        return {
            "prefetch": self.prefetch,
            "prefetch_credit": self.prefetch_credit,
            "pipeline": self._client.pipeline,
            "ff_pending": self._client.ff_pending,
            "backlogged": self._client.backlogged,
            "frames_coalesced": self._client.frames_coalesced_total,
        }

    # lifecycle stand-ins (ServiceRuntime treats the bus as a child)
    async def initialize(self) -> None:
        await self._client.connect()

    async def start(self) -> None:
        if self._client._writer is None:
            await self._client.connect()

    async def stop(self) -> None:
        await self._client.flush_background()
        self._client.close()

    def create_topic(self, name: str, **kwargs: Any) -> None:
        pass  # broker auto-creates on produce/subscribe

    def end_offsets(self, topic: str):
        """Awaitable (the broker answers); callers on possibly-remote
        paths guard with `inspect.isawaitable`."""
        return self._client.call("end_offsets", topic=topic)

    def topic_names(self):
        """Awaitable; see `end_offsets`."""
        return self._client.call("topic_names")

    def group_lags(self):
        """Awaitable (the broker owns the committed/head view); callers
        on possibly-remote paths guard with `inspect.isawaitable` — the
        telemetry beat skips it and lets the broker-side process sample
        lag centrally (kernel/observe.py)."""
        return self._client.call("group_lags")

    def bus_stats(self):
        """Awaitable broker self-stats (`EventBus.stats()`): per-topic
        depth, per-group lag/membership, fence rejections, members
        evicted — the broker-black-box closer, served to any peer."""
        return self._client.call("bus_stats")

    @property
    def on_fenced(self):
        """Callback(tenant, epoch) for fire-and-forget fenced rejections
        — ServiceRuntime wires it to its FenceState so a background
        commit/produce rejection still demotes the zombie owner."""
        return self._client.on_fenced

    @on_fenced.setter
    def on_fenced(self, cb) -> None:
        self._client.on_fenced = cb

    async def produce(self, topic: str, value: Any, *,
                      key: Optional[str] = None,
                      partition: Optional[int] = None,
                      fence=None, _sent: Optional[list] = None
                      ) -> tuple[int, int]:
        """`_sent` is the publish-settlement probe (WireClient.call):
        kernel/fastlane.py `produce_settled` threads it so cancellation
        mid-publish stays unambiguous for commit accounting."""
        tracer = self.tracer
        ctx = getattr(value, "ctx", None)
        # the broker-hop's service half: encode + RPC + append
        # (`wire.poll` on the consuming peer records the queue half).
        # Gate on sampled() BEFORE touching the clock: the un-sampled
        # common case pays one modulo, nothing more (measured: even two
        # stray monotonic reads per produce show up at fleet
        # saturation on the 1-core rig).
        traced = (tracer is not None and ctx is not None
                  and getattr(ctx, "trace_id", 0)
                  and tracer.sampled(ctx.trace_id))
        t0 = time.monotonic() if traced else 0.0
        p, off = await self._client.call("produce", _sent=_sent,
                                         topic=topic, value=value,
                                         key=key, partition=partition,
                                         fence=fence)
        if traced:
            try:
                n = len(value)
            except TypeError:
                n = 0
            tracer.record(ctx.trace_id, "wire.produce", ctx.tenant_id,
                          t0, time.monotonic() - t0, n)
        return p, off

    def produce_nowait(self, topic: str, value: Any, *,
                       key: Optional[str] = None,
                       partition: Optional[int] = None,
                       fence=None) -> None:
        if self._client.pipeline:
            # coalescing fast path: the op rides this tick's multi-op
            # batch frame (no per-produce task, one drain per tick)
            self._client.call_nowait("produce", topic=topic, value=value,
                                     key=key, partition=partition,
                                     fence=fence)
        else:
            self._client.spawn(
                self.produce(topic, value, key=key, partition=partition,
                             fence=fence))

    def subscribe(self, topics: Iterable[str] | str, *, group: str,
                  name: Optional[str] = None,
                  owner: Optional[str] = None):
        # subscribe must return a consumer synchronously (services
        # subscribe in sync setup paths); the RPC resolves lazily via a
        # proxy that binds cid on first poll
        if isinstance(topics, str):
            topics = [topics]
        return _LazyRemoteConsumer(self._client, list(topics), group,
                                   name or group,
                                   owner=owner or self.owner,
                                   tracer=self.tracer,
                                   prefetch=self.prefetch,
                                   prefetch_credit=self.prefetch_credit)


class _LazyRemoteConsumer(RemoteBusConsumer):
    """RemoteBusConsumer that performs the subscribe RPC on first use."""

    def __init__(self, client: WireClient, topics: list, group: str,
                 name: str, owner: Optional[str] = None, tracer=None,
                 prefetch: bool = False,
                 prefetch_credit: int = DEFAULT_PREFETCH_CREDIT):
        super().__init__(client, cid=-1, group=group, name=name,
                         tracer=tracer, prefetch=prefetch,
                         prefetch_credit=prefetch_credit)
        self.owner = owner
        self._topics = topics
        self._seek_pending = False

    async def _ensure(self) -> None:
        if self.cid < 0:
            seek = self._seek_pending
            self._seek_pending = False
            call = await self._client.call_started(
                "subscribe", topics=self._topics, group=self.group,
                name=self.name, owner=self.owner,
                # seek rides the subscribe op itself: the broker seeks
                # BEFORE the first push delivery, so a prefetching
                # replay consumer never sees committed-position rows
                seek=seek,
                prefetch=self._credit if self._prefetch else 0)
            try:
                cid = await asyncio.shield(call)
            except asyncio.CancelledError:
                # the caller was cancelled (an engine stopped on its
                # first poll) with the subscribe on the broker's path:
                # the member it creates would hold its share of the
                # group's partitions with nobody polling them. Close it
                # when the answer lands.
                call.add_done_callback(self._close_unwanted)
                raise
            self.cid = cid
            if self._closed:
                # closed while the subscribe was in flight: reap the
                # broker-side consumer we just created, and mark the
                # cid closed so deliver frames already pushed for it
                # are dropped instead of parking in the orphan buffer
                # forever (a credit window of pinned frame bodies)
                self._client.unregister_push(self.cid)
                try:
                    self._client.call_nowait("close_consumer", cid=self.cid)
                except RuntimeError:
                    pass
                return
            if self._prefetch:
                self._client.register_push(self.cid, self._on_push)

    def _close_unwanted(self, call: asyncio.Future) -> None:
        if call.cancelled() or call.exception() is not None:
            return
        self._client.unregister_push(call.result())
        try:
            self._client.call_nowait("close_consumer", cid=call.result())
        except RuntimeError:
            pass

    async def poll(self, *, max_records: int = 512,
                   timeout: float = 1.0) -> list[TopicRecord]:
        await self._ensure()
        return await super().poll(max_records=max_records, timeout=timeout)

    def seek_to_beginning(self) -> None:
        # valid before the first poll on the local BusConsumer — queue
        # the intent and apply it with the subscribe op
        if self.cid < 0:
            self._seek_pending = True
        else:
            super().seek_to_beginning()

    def commit(self, positions: Optional[dict] = None, *,
               fence=None) -> None:
        if self.cid >= 0:
            super().commit(positions, fence=fence)
        elif positions:
            # explicit positions before the first poll: subscribe first
            async def ensure_then_commit():
                await self._ensure()
                rows = [[t, p, off] for (t, p), off in positions.items()]
                await self._client.call("commit", cid=self.cid,
                                        positions=rows, fence=fence)

            self._client.spawn(ensure_then_commit())

    def close(self) -> None:
        if self.cid >= 0:
            super().close()
        else:
            self._closed = True


# ---------------------------------------------------------------------------
# control plane: service APIs over the wire
# ---------------------------------------------------------------------------


class ApiServer(WireServer):
    """Expose a runtime's services to remote peers: wait-for-engine and
    method calls on services/engines (the reference's per-service gRPC
    APIs with tenant-token demux [SURVEY.md §2.1])."""

    def __init__(self, runtime, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None):
        super().__init__(host, port, secret=secret)
        self.runtime = runtime
        self.handlers = {
            "wait_engine": self._op_wait_engine,
            "call": self._op_call,
            "health": self._op_health,
            "observe": self._op_observe,
            "fleet": self._op_fleet,
            "trace": self._op_trace,
        }

    async def _op_wait_engine(self, msg, writer=None) -> bool:
        await self.runtime.wait_for_engine(msg["identifier"], msg["tenant"],
                                           timeout=msg.get("timeout", 30.0))
        return True

    def _target(self, msg):
        svc = self.runtime.services[msg["identifier"]]
        tenant = msg.get("tenant")
        if tenant is None:
            return svc.api()
        target = svc.engine(tenant)
        return target

    async def _op_call(self, msg, writer=None) -> Any:
        method = msg["method"]
        if method.startswith("_"):
            raise PermissionError(f"method {method!r} not exposed")
        target = self._target(msg)
        sub = msg.get("sub")
        if sub:  # e.g. management()/state() accessor before the method
            if sub.startswith("_"):
                # same guard as `method`: the accessor must not reach the
                # private surface the method check hides
                raise PermissionError(f"accessor {sub!r} not exposed")
            target = getattr(target, sub)
            if callable(target):
                target = target()
        fn = getattr(target, method)
        result = fn(*msg.get("args", ()), **msg.get("kwargs", {}))
        if asyncio.iscoroutine(result):
            result = await result
        return result

    async def _op_health(self, msg, writer=None) -> dict:
        return self.runtime.health()

    async def _op_observe(self, msg, writer=None) -> dict:
        """The flight-recorder report for THIS process — fleet workers
        expose their critical path / beat to peer tooling this way."""
        from sitewhere_tpu_torch.kernel.observe import observe_report

        return observe_report(self.runtime, tenant=msg.get("tenant"))

    async def _op_fleet(self, msg, writer=None) -> dict:
        fleet = getattr(self.runtime, "fleet", None)
        if fleet is None:
            raise LookupError("no fleet controller in this process")
        return fleet.snapshot()

    async def _op_trace(self, msg, writer=None) -> list:
        """This process's recorded spans for ONE trace id — trace ids
        are origin-scoped fleet-wide (Tracer.set_origin), so peers can
        stitch a cross-process journey by asking each worker for the
        same id and merging (tests + fleet tooling)."""
        return [s.to_dict() for s in
                self.runtime.tracer.trace(int(msg["trace_id"]),
                                          tenant=msg.get("tenant"))]


class RemoteEngineProxy:
    """Stand-in for a peer process's tenant engine: every attribute is a
    coroutine-returning method call. Callers on possibly-remote paths
    guard results with `inspect.isawaitable`."""

    def __init__(self, channel: "ApiChannel", identifier: str, tenant: str,
                 sub: Optional[str] = None):
        self._channel = channel
        self._identifier = identifier
        self._tenant = tenant
        self._sub = sub

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        async def call(*args, **kwargs):
            return await self._channel.call(
                self._identifier, name, args=list(args), kwargs=kwargs,
                tenant=self._tenant, sub=self._sub)

        call.__name__ = name
        return call


class ApiChannel:
    """Client side of `ApiServer` (reference: `ApiChannel`)."""

    def __init__(self, host: str, port: int, secret: Optional[str] = None):
        self._client = WireClient(host, port, secret=secret)

    async def wait_engine(self, identifier: str, tenant: str,
                          timeout: float = 30.0) -> bool:
        return await self._client.call("wait_engine", identifier=identifier,
                                       tenant=tenant, timeout=timeout)

    async def call(self, identifier: str, method: str, *, args=None,
                   kwargs=None, tenant: Optional[str] = None,
                   sub: Optional[str] = None) -> Any:
        return await self._client.call(
            "call", identifier=identifier, method=method,
            args=args or [], kwargs=kwargs or {}, tenant=tenant, sub=sub)

    async def health(self) -> dict:
        return await self._client.call("health")

    async def observe(self, tenant: Optional[str] = None) -> dict:
        return await self._client.call("observe", tenant=tenant)

    async def fleet(self) -> dict:
        return await self._client.call("fleet")

    async def trace(self, trace_id: int,
                    tenant: Optional[str] = None) -> list:
        return await self._client.call("trace", trace_id=trace_id,
                                       tenant=tenant)

    def close(self) -> None:
        self._client.close()


class RemoteService:
    """`ServiceRuntime.add_remote_service` handle: looks enough like a
    `Service` for `api()`/`wait_for_engine` call sites."""

    multitenant = True

    def __init__(self, identifier: str, channel: ApiChannel):
        self.identifier = identifier
        self.channel = channel

    def api(self) -> "RemoteService":
        return self

    def engine(self, tenant_id: str) -> RemoteEngineProxy:
        return RemoteEngineProxy(self.channel, self.identifier, tenant_id)

    def management(self, tenant_id: str) -> RemoteEngineProxy:
        # engines delegate their management/SPI surface via __getattr__,
        # so engine-level calls cover the management() call sites too
        return RemoteEngineProxy(self.channel, self.identifier, tenant_id)

    async def wait_engine(self, tenant_id: str,
                          timeout: float = 30.0) -> RemoteEngineProxy:
        await self.channel.wait_engine(self.identifier, tenant_id,
                                       timeout=timeout)
        return self.engine(tenant_id)

"""Device results, and the device-resident streaming state rings.

Results. A flush's scores leave the card as soon as they are dispatched:
`start_to_host` queues a non-blocking copy into pinned host memory on
the current stream and records a CUDA event behind it. The event loop
polls `result_ready` (an event query, never a sync), and a settle thread
calls `result_to_host`, which waits on that one event — never a
device-wide `torch.cuda.synchronize()`. On the CPU a result is ready at
once. A result is one score tensor or, with sparse anomaly readback, the
tuple `(n_anom, positions, scores)`; these helpers are the one place that
knows the tuple's shape.

Rings. The streaming twin of `scoring/ring.py`'s window ring: where
`DeviceRing` stores raw history and rescores the whole window per event,
these rings store the model's own recurrent state (h/c, standing
prediction, normalisation stats — whatever its `init_state` declares),
and a flush is

    gather state rows → model.step_score (one cell step) → scatter back

in place, uploading only (device id, value) deltas like the window ring.
For a configuration the fused kernels take (`model.fused`: one layer,
bf16, a hidden width K2 is built for) with the state on the card, that
whole step is one launch of K2 (`ops/lstm_stream_kernel.py`); elsewhere it
is the plain chain below (`streaming_step_plain`).
Contract with the model (`StreamingLstmModel` in models/lstm.py):

    init_state(cap)              -> dict of [cap, ...] leaves
    step_score(params, rows, v)  -> (scores, new rows)
    warm_state(params, x, valid) -> state dict (host-window replay seed)

In the plain chain the gather and scatter index flat rows of each leaf
outside any vmap; only `step_score` is vmapped over the stacked ring's
tenant axis. Ids are unique per dispatch apart from the scratch rows
(occurrence rounds), so the nondeterministic winner of duplicate
`index_put_` writes (or of K2's racing stores) lands only in a row
nobody reads. Ids are checked on the host before any launch:
on the card an out-of-range index is a device-side assert that ends the
process's CUDA context (JAX's scatter drops it instead).

The host `TelemetryStore` stays the durable copy: `load()` rebuilds state
from it at warmup or after a fault, as for the window ring.

`MeshRing` holds either stacked ring over a mesh: tenant rows over
`model`, batch columns over `data` (its docstring says how the shards
and their replicas are kept).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.ops import lstm_stream_kernel
from sitewhere_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    assemble,
    block_slices,
    column_replicas,
    megabatch_sharding,
    model_index,
    place_tree,
    tenant_placer,
)
from sitewhere_tpu_torch.scoring.ring import check_ids, torch_dtype
from sitewhere_tpu_torch.utils import grow_pow2, resolve_device

# -- device results ----------------------------------------------------------


@dataclass
class DeviceResult:
    """Host copy of a device result, complete once `event` has fired
    (`event` is None for CPU tensors: the copy is already there)."""

    host: Union[torch.Tensor, tuple]
    event: Optional[torch.cuda.Event] = None


def start_to_host(out) -> DeviceResult:
    """Begin the device→host copy of `out` (a tensor or a tuple of
    tensors) without blocking."""
    outs = out if isinstance(out, tuple) else (out,)
    event = None
    if outs[0].device.type != "cuda":
        host = tuple(o.detach() for o in outs)
    else:
        host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                     for o in outs)
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(outs[0].device))
    return DeviceResult(host if isinstance(out, tuple) else host[0], event)


def result_ready(res: DeviceResult) -> bool:
    return res.event is None or res.event.query()


def result_to_host(res: DeviceResult):
    """Settle-thread conversion: wait for this result's copy, then view it
    as numpy (a tuple of arrays for a sparse result)."""
    if res.event is not None:
        res.event.synchronize()
    if isinstance(res.host, tuple):
        return tuple(h.numpy() for h in res.host)
    return res.host.numpy()


def sparse_take(n_anom, pos, vals,
                n_real: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side reconstruction of ONE sparse result row: clamp to the k
    slots, drop bucket-padding positions (>= n_real), upcast scores.
    Returns (positions, scores_f32, overflow). `top_k` on the card orders
    tied scores and the -inf padding arbitrarily, so only the first
    `min(n_anom, k)` entries are read."""
    k_eff = min(int(n_anom), pos.shape[0])
    overflow = max(0, int(n_anom) - pos.shape[0])
    if k_eff == 0:
        return (np.empty(0, pos.dtype), np.empty(0, np.float32), overflow)
    p = pos[:k_eff]
    keep = p < n_real
    return p[keep], vals[:k_eff][keep].astype(np.float32), overflow


def sparse_rows(rows, overflow) -> tuple[np.ndarray, np.ndarray]:
    """The anomalous (position, score) pairs of one flush's sparse
    results. `rows` yields `((n_anom, positions, scores), n_real, rpos)`
    per dispatch round: each row goes through `sparse_take`, its
    positions map back through the round's positions `rpos` (None: the
    round is the flush in order), and its overflow is added to the
    counter `overflow`. Shared by the session's per-chunk settle and the
    pool's per-tenant settle so the overflow/remap accounting cannot
    drift between the two hot paths."""
    positions, scores = [np.empty(0, np.int64)], [np.empty(0, np.float32)]
    for (n_anom, pos, vals), n_real, rpos in rows:
        p, v, over = sparse_take(n_anom, pos, vals, n_real)
        if over:
            overflow.inc(over)
        positions.append(p if rpos is None else rpos[p])
        scores.append(v)
    return np.concatenate(positions), np.concatenate(scores)


# -- the step bodies ----------------------------------------------------------


def streaming_step(model, device, out_dtype=None,
                   stacked: bool = False) -> Callable:
    """The step body, shared by the dedicated ring and the stacked ring so
    the two hot paths cannot diverge, chosen once for a ring on `device`:
    K2 (`lstm_stream_kernel.lstm_stream_step`) where `takes_kernel` holds
    (the configuration `model.fused` and the state on the card), the plain
    chain (`streaming_step_plain`) everywhere else.

    `step(params, state, dev, v)`: `dev`/`v` are `[B]` (or `[T, B]` with
    `stacked`, per-tenant device ids); state leaves are updated in place.
    Returns the scores, narrowed to `out_dtype` (model state stays
    float32; settle upcasts)."""
    if not lstm_stream_kernel.takes_kernel(model, device):
        return streaming_step_plain(model, out_dtype, stacked)
    cfg = model.cfg

    def step(params, state, dev, v):
        return lstm_stream_kernel.lstm_stream_step(
            params, state, dev, v, window=cfg.window,
            min_count=model.min_history, score_clip=cfg.score_clip,
            out_dtype=out_dtype)

    return step


def streaming_step_plain(model, out_dtype=None,
                         stacked: bool = False) -> Callable:
    """`streaming_step` as a chain of PyTorch ops: gather the rows of
    every state leaf → `step_score` (vmapped over the tenant axis of
    params, rows and values with `stacked`) → scatter them back."""
    step_score = torch.func.vmap(model.step_score) if stacked else model.step_score

    def step(params, state, dev, v):
        if stacked:
            # flat rows t * (D_cap + 1) + dev into [T * (D_cap + 1), ...]
            # views of each leaf
            stride = next(iter(state.values())).shape[1]
            tenant = torch.arange(dev.shape[0], device=dev.device)
            rows = (dev + stride * tenant[:, None]).reshape(-1)
            state = {k: leaf.view(-1, *leaf.shape[2:])
                     for k, leaf in state.items()}
        else:
            rows = dev
        got = {k: leaf[rows].reshape(*dev.shape, *leaf.shape[1:])
               for k, leaf in state.items()}
        scores, new_rows = step_score(params, got, v)
        for k, leaf in state.items():
            leaf.index_put_((rows,), new_rows[k].reshape(-1, *leaf.shape[1:]))
        return scores if out_dtype is None else scores.to(out_dtype)

    return step


def streaming_step_sparse(model, device, k: int, scratch_index: int,
                          out_dtype=None, stacked: bool = False) -> Callable:
    """`streaming_step` with thresholding on the device: every event is
    still scored and its state advanced, but only the anomalous
    (position, score) pairs cross back to the host.

    `step(params, state, dev, v, threshold)` returns
    `(n_anom, positions[k], scores[k])` (a leading tenant axis with
    `stacked`, `threshold` then `[T, 1]`): `n_anom` counts real anomalies
    (scratch-row padding masked on the device), positions index the
    flush's padded bucket, entries past `min(n_anom, k)` are padding, and
    `n_anom > k` is overflow the host counts (`scoring.anomaly_overflow`),
    so a silent top-k truncation is impossible."""
    dense = streaming_step(model, device, None, stacked)

    def step(params, state, dev, v, threshold):
        return sparse_select(dense(params, state, dev, v), dev, threshold,
                             k, scratch_index, out_dtype)

    return step


def sparse_select(scores, dev, threshold, k: int, scratch_index: int,
                  out_dtype=None) -> tuple:
    """The sparse readback of dense `scores` (`[B]`, or `[T, B]` with a
    `[T, 1]` threshold): `(n_anom, positions[k], scores[k])` per row,
    scratch-row padding masked."""
    # scratch-row padding must never report: its state absorbs
    # arbitrary writes, so its score is garbage by design
    is_anom = (scores >= threshold) & (dev != scratch_index)
    n_anom = is_anom.sum(-1, dtype=torch.int32)
    masked = torch.where(is_anom, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, top_pos = torch.topk(masked, k, dim=-1)
    if out_dtype is not None:
        top_scores = top_scores.to(out_dtype)
    return n_anom, top_pos.to(torch.int32), top_scores


def _sparse_k(sparse_k: int, bucket: int) -> int:
    return min(sparse_k or max(128, bucket // 64), bucket)


def _valid(count: np.ndarray, w: int) -> np.ndarray:
    return np.arange(w)[None, :] >= (w - np.minimum(count, w))[:, None]


# -- the rings ----------------------------------------------------------------


class StreamingRing:
    """Per-device streaming model state for up to `capacity` devices,
    plus one scratch row (index `capacity`) that absorbs padding,
    resident on `device` (the card unless named)."""

    def __init__(self, model, capacity: int = 1024, score_dtype=None,
                 sparse_threshold: Optional[float] = None,
                 sparse_k: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.window = int(model.cfg.window)  # load()-contract width
        self.capacity = grow_pow2(int(capacity), floor=1024)
        self.score_dtype = torch_dtype(score_dtype)
        # sparse anomaly readback: set a threshold to ship only anomalous
        # (position, score) pairs home
        self.sparse_threshold = sparse_threshold
        self.sparse_k = sparse_k
        self.faulted = False
        self._params: Optional[dict] = None
        self._step = streaming_step(model, self.device, self.score_dtype)
        self.state = self._init_state(self.capacity + 1)

    def _init_state(self, n: int) -> dict:
        return {k: leaf.to(self.device)
                for k, leaf in self.model.init_state(n).items()}

    def ensure_capacity(self, max_index: int) -> None:
        """Grow (device-side) so `max_index` is a valid device row; old
        rows keep their state, new rows start cold."""
        if max_index < self.capacity:
            return
        new_cap = grow_pow2(max_index + 1, floor=self.capacity * 2)
        fresh = self._init_state(new_cap - self.capacity + 1)
        # drop the old scratch row, append fresh rows + a fresh scratch
        self.state = {k: torch.cat([leaf[:-1], fresh[k]])
                      for k, leaf in self.state.items()}
        self.capacity = new_cap

    def bind_params(self, params: dict) -> None:
        """Streaming state depends on the weights (h/c/pred are functions
        of them): the session binds current params before load()."""
        self._params = params

    def load(self, values: np.ndarray, count: np.ndarray,
             start: int = 0) -> None:
        """Seed rows `start..start+n` by replaying host windows
        (`TelemetryStore.window` layout: chronological, left-padded)."""
        n, w = values.shape
        assert w == self.window
        self.ensure_capacity(start + n - 1 if n else 0)
        if n == 0:
            self.faulted = False
            return
        if self._params is None:
            raise RuntimeError("StreamingRing.load needs params bound via "
                               "bind_params() before seeding")
        seeded = self.model.warm_state(
            self._params,
            torch.from_numpy(np.asarray(values, np.float32)).to(self.device),
            torch.from_numpy(_valid(count, w)).to(self.device))
        for k, leaf in self.state.items():
            leaf[start:start + n] = seeded[k]
        self.faulted = False

    def _pad(self, dev: np.ndarray, v: np.ndarray, bucket: int):
        check_ids(dev, self.capacity)
        n = dev.shape[0]
        out_dev = np.full(bucket, self.capacity, np.int32)  # scratch row
        out_v = np.zeros(bucket, np.float32)
        out_dev[:n] = dev
        out_v[:n] = v
        return (torch.from_numpy(out_dev).to(self.device),
                torch.from_numpy(out_v).to(self.device))

    def update_and_score(self, model, params, dev: np.ndarray,
                         v: np.ndarray, bucket: int):
        """Advance + score one event per row of `dev` (unique ids!);
        returns `[bucket]` scores on the device (asynchronous), or the
        sparse `(n_anom, positions, scores)` tuple."""
        self._params = params
        pdev, pv = self._pad(dev, v, bucket)
        try:
            if self.sparse_threshold is not None:
                step = streaming_step_sparse(
                    model, self.device, _sparse_k(self.sparse_k, bucket),
                    scratch_index=self.capacity, out_dtype=self.score_dtype)
                return step(params, self.state, pdev, pv,
                            float(self.sparse_threshold))
            return self._step(params, self.state, pdev, pv)
        except Exception:
            self.faulted = True  # partial update; needs load()
            raise

    def close(self) -> None:
        """Release the state's device memory; the ring is unusable
        afterwards."""
        self.state = {}


class StackedStreamingRing:
    """Per-tenant streaming model state stacked on a leading tenant axis —
    the pooled twin of `StreamingRing`, resident on `device` (the card
    unless named).

    State leaves are `[T_cap, D_cap+1, ...]`. One flush is one
    gather → vmap(step_score) → scatter over the tenant axis, in place:
    every tenant's events cost one cell step each, uploading only the
    `[T_cap, B]` (device id, value) deltas. Padding lands in each
    tenant's scratch row `D_cap`.

    Seeding is per tenant (`load_tenant`) because streaming state is a
    function of that tenant's weights: the caller passes the tenant's
    unstacked params and the state is rebuilt by `model.warm_state`
    replay of its host windows.
    """

    def __init__(self, model, n_tenants: int, device_cap: int = 1024,
                 score_dtype=None, sparse: bool = False, sparse_k: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.window = int(model.cfg.window)
        self.score_dtype = torch_dtype(score_dtype)
        # sparse anomaly readback, pooled form: per-tenant thresholds ride
        # as a [T_cap] runtime vector
        self.sparse = sparse
        self.sparse_k = sparse_k
        self.t_cap = int(n_tenants)
        self.device_cap = grow_pow2(int(device_cap), floor=1024)
        self.faulted = False
        self._step = streaming_step(model, self.device, self.score_dtype,
                                    stacked=True)
        self.state = self._alloc(self.t_cap, self.device_cap)

    def _init_state(self, n: int) -> dict:
        return {k: leaf.to(self.device)
                for k, leaf in self.model.init_state(n).items()}

    def _alloc(self, t: int, d: int) -> dict:
        return {k: leaf[None].repeat(t, *(1,) * leaf.ndim)
                for k, leaf in self._init_state(d + 1).items()}

    # -- capacity ----------------------------------------------------------

    def ensure(self, n_tenants: int, max_device: int) -> None:
        """Grow either axis (device-side). The tenant axis adopts
        `n_tenants` exactly — it must equal the param stack's capacity
        (vmap needs matching leading dims)."""
        new_t = max(self.t_cap, n_tenants)
        new_d = self.device_cap
        if max_device >= new_d:
            new_d = grow_pow2(max_device + 1, floor=new_d * 2)
        if new_t == self.t_cap and new_d == self.device_cap:
            return
        if new_d != self.device_cap:
            # drop the old scratch row, append fresh rows + a fresh
            # scratch per tenant (fresh rows are weight-independent)
            fresh = self._alloc(self.t_cap, new_d - self.device_cap)
            self.state = {k: torch.cat([leaf[:, :-1], fresh[k]], dim=1)
                          for k, leaf in self.state.items()}
        if new_t != self.t_cap:
            grown = self._alloc(new_t - self.t_cap, new_d)
            self.state = {k: torch.cat([leaf, grown[k]])
                          for k, leaf in self.state.items()}
        self.t_cap, self.device_cap = new_t, new_d

    # -- seeding -----------------------------------------------------------

    def load_tenant(self, slot: int, values: np.ndarray, count: np.ndarray,
                    params: dict) -> None:
        """Seed one tenant's state rows by replaying its host windows
        (`TelemetryStore.window` layout) under ITS params."""
        n, w = values.shape
        assert w == self.window
        self.ensure(slot + 1, n - 1 if n else 0)
        if n == 0:
            self.faulted = False
            return
        seeded = self.model.warm_state(
            params,
            torch.from_numpy(np.asarray(values, np.float32)).to(self.device),
            torch.from_numpy(_valid(count, w)).to(self.device))
        for k, leaf in self.state.items():
            leaf[slot, :n] = seeded[k]
        self.faulted = False

    def clear_tenant(self, slot: int) -> None:
        """Reset a departed tenant's rows (slot reuse must not leak)."""
        fresh = self._init_state(self.device_cap + 1)
        for k, leaf in self.state.items():
            leaf[slot] = fresh[k]

    def leaves(self) -> dict:
        """The state tensors, each `[T_cap, D_cap+1, ...]`."""
        return self.state

    # -- the step ----------------------------------------------------------

    def update_and_score(self, model, stacked_params, dev: np.ndarray,
                         v: np.ndarray, thresholds=None):
        """dev: [T_cap, B] int32 (scratch-row-padded, unique ids per
        tenant row!), v: [T_cap, B] float32 → [T_cap, B] scores on the
        device (asynchronous); sparse mode returns per-tenant
        (n_anom[T], positions[T, k], scores[T, k]) and needs
        `thresholds` [T_cap] float32."""
        if dev.shape[0] != self.t_cap or v.shape != dev.shape:
            raise ValueError(f"dispatch columns {dev.shape}/{v.shape} do "
                             f"not match the ring's {self.t_cap} tenants")
        check_ids(dev, self.device_cap + 1)  # the scratch row included
        pdev = torch.from_numpy(np.ascontiguousarray(dev, np.int32)).to(
            self.device)
        pv = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            self.device)
        try:
            if self.sparse:
                step = streaming_step_sparse(
                    model, self.device,
                    _sparse_k(self.sparse_k, dev.shape[1]),
                    scratch_index=self.device_cap,
                    out_dtype=self.score_dtype, stacked=True)
                th = torch.from_numpy(
                    np.asarray(thresholds, np.float32)).to(self.device)
                return step(stacked_params, self.state, pdev, pv, th[:, None])
            return self._step(stacked_params, self.state, pdev, pv)
        except Exception:
            self.faulted = True  # partial update; needs reseeding
            raise

    def close(self) -> None:
        """Release the state's device memory; the ring is unusable
        afterwards."""
        self.state = {}


class MeshRing:
    """A stacked ring over a mesh (`parallel/mesh.py`): tenant rows over
    `model`, replicated over `data`; megabatch columns over `data`.

    Each model shard's rows live in one meshless stacked ring per
    distinct device of its column — `make(n_tenants, device_cap, device,
    score_dtype)` builds it (`StackedStreamingRing` or
    `StackedDeviceRing`) — and positions of the column on the same device
    share that ring. A dispatch runs each position's block (its tenant
    rows × its batch columns) on its ring, in place. Ids are unique per
    tenant row, so the blocks of one column touch disjoint rows: where a
    column has replicas on several devices, each block's touched rows
    are then copied to the other replicas (the updates' all-gather). The
    score blocks land on the mesh's first device; sparse readback selects
    there, over whole rows."""

    def __init__(self, mesh: Mesh, make: Callable, n_tenants: int,
                 device_cap: int = 1024, score_dtype=None,
                 sparse: bool = False, sparse_k: int = 0):
        self.mesh = mesh
        self._make = make
        self._m = mesh.local_shape[MODEL_AXIS]
        if n_tenants % self._m:
            raise ValueError(f"{n_tenants} tenant rows do not split over "
                             f"a model axis of {self._m}")
        self.score_dtype = torch_dtype(score_dtype)
        self.sparse = sparse
        self.sparse_k = sparse_k
        self.faulted = False
        self.rings = self._build(n_tenants // self._m, device_cap)

    def _build(self, rows: int, device_cap: int) -> dict:
        rings, by_key = {}, {}
        for pos in self.mesh.positions():
            key = (model_index(self.mesh, pos), self.mesh.device(*pos))
            if key not in by_key:
                by_key[key] = self._make(
                    rows, device_cap, key[1],
                    None if self.sparse else self.score_dtype)
            rings[pos] = by_key[key]
        return rings

    def _distinct(self) -> list:
        out: list = []
        for ring in self.rings.values():
            if all(ring is not o for o in out):
                out.append(ring)
        return out

    @property
    def t_cap(self) -> int:
        return self._m * self._distinct()[0].t_cap

    @property
    def device_cap(self) -> int:
        return self._distinct()[0].device_cap

    @property
    def window(self) -> int:
        return self._distinct()[0].window

    def _owner(self, slot: int, rings: Optional[dict] = None,
               rows: Optional[int] = None) -> tuple[list, int]:
        """The rings holding tenant `slot` (its model shard's replicas)
        and its row in them."""
        rings = self.rings if rings is None else rings
        rows = self.t_cap // self._m if rows is None else rows
        return column_replicas(self.mesh, rings, slot // rows), slot % rows

    # -- capacity ----------------------------------------------------------

    def ensure(self, n_tenants: int, max_device: int) -> None:
        """Grow either axis. Growing the tenant axis re-cuts the shards
        (slot s moves to shard s // rows), so every tenant's rows are
        copied into the new rings."""
        for ring in self._distinct():
            ring.ensure(ring.t_cap, max_device)
        if n_tenants <= self.t_cap:
            return
        if n_tenants % self._m:
            raise ValueError(f"{n_tenants} tenant rows do not split over "
                             f"a model axis of {self._m}")
        old, old_rows, old_t = self.rings, self.t_cap // self._m, self.t_cap
        self.rings = self._build(n_tenants // self._m, self.device_cap)
        for slot in range(old_t):
            (src, *_), srow = self._owner(slot, old, old_rows)
            dsts, drow = self._owner(slot)
            for name, leaf in src.leaves().items():
                for dst in dsts:
                    out = dst.leaves()[name]
                    out[drow] = leaf[srow].to(out.device)
        for ring in {id(r): r for r in old.values()}.values():
            ring.close()

    # -- seeding -----------------------------------------------------------

    def load_tenant(self, slot: int, values: np.ndarray, count: np.ndarray,
                    params: Optional[dict] = None) -> None:
        """Seed tenant `slot` in every replica of its shard (a streaming
        ring replays under `params`, moved to each replica's device)."""
        self.ensure(self.t_cap, values.shape[0] - 1 if values.shape[0] else 0)
        rings, row = self._owner(slot)
        for ring in rings:
            if params is None:
                ring.load_tenant(row, values, count)
            else:
                ring.load_tenant(row, values, count, tree_map(
                    lambda t, d=ring.device: t.to(d), params))
        self.faulted = False

    def clear_tenant(self, slot: int) -> None:
        rings, row = self._owner(slot)
        for ring in rings:
            ring.clear_tenant(row)

    # -- the step ----------------------------------------------------------

    def update_and_score(self, model, stacked_params, dev: np.ndarray,
                         v: np.ndarray, thresholds=None):
        """As the meshless stacked rings' (`[T_cap, B]` columns, B a
        multiple of the data axis): `stacked_params` is the meshed
        `TenantStack.stacked` (`{position: params}`) or a whole stacked
        tree, cut here."""
        if dev.shape[0] != self.t_cap or v.shape != dev.shape:
            raise ValueError(f"dispatch columns {dev.shape}/{v.shape} do "
                             f"not match the ring's {self.t_cap} tenants")
        check_ids(dev, self.device_cap + 1)  # the scratch row included
        if not all(isinstance(k, tuple) for k in stacked_params):
            stacked_params = place_tree(stacked_params,
                                        tenant_placer(self.mesh), self.mesh)
        sh = megabatch_sharding(self.mesh, 2)
        blocks = {}
        try:
            for pos in self.mesh.positions():
                sl = block_slices(sh, dev.shape, pos)
                blocks[pos] = self.rings[pos].update_and_score(
                    model, stacked_params[pos],
                    np.ascontiguousarray(dev[sl]),
                    np.ascontiguousarray(v[sl]))
            self._sync(dev, sh)
        except Exception:
            self.faulted = True  # partial update; needs reseeding
            raise
        scores = assemble(self.mesh, blocks, dev.shape)
        if not self.sparse:
            return scores
        first = self.mesh.first
        return sparse_select(
            scores, torch.from_numpy(dev.astype(np.int64)).to(first),
            torch.from_numpy(np.asarray(thresholds, np.float32)).to(
                first)[:, None],
            _sparse_k(self.sparse_k, dev.shape[1]), self.device_cap,
            self.score_dtype)

    def _sync(self, dev: np.ndarray, sh) -> None:
        """Copy each block's touched rows to its column's other replicas."""
        for pos in self.mesh.positions():
            reps, _ = self._owner(model_index(self.mesh, pos) *
                                  (self.t_cap // self._m))
            src = self.rings[pos]
            if len(reps) < 2:
                continue
            block = dev[block_slices(sh, dev.shape, pos)]
            t_idx, c_idx = np.nonzero(block != self.device_cap)
            if not t_idx.shape[0]:
                continue
            rows = torch.from_numpy(t_idx.astype(np.int64))
            ids = torch.from_numpy(block[t_idx, c_idx].astype(np.int64))
            for name, leaf in src.leaves().items():
                got = leaf[rows.to(leaf.device), ids.to(leaf.device)]
                for dst in reps:
                    if dst is src:
                        continue
                    out = dst.leaves()[name]
                    out[rows.to(out.device), ids.to(out.device)] = \
                        got.to(out.device)

    def windows(self, slot: int, dev: np.ndarray):
        """The window ring's query path, from the slot's first replica."""
        rings, row = self._owner(slot)
        return rings[0].windows(row, dev)

    def close(self) -> None:
        for ring in self._distinct():
            ring.close()

"""Per-tenant model multiplexing: stacked params + vmap over the tenants.

Every tenant's params for one architecture are stacked on a leading
tenant axis (one dict, leaves `[T_cap, ...]`) resident on one device;
`vmap(model.score)` over that axis scores all tenants in one call, and
the stacked rings (scoring/ring.py, scoring/stream.py) vmap the hot path
the same way. Capacity grows in powers of two (`T_cap`), and one
tenant's param swap is a one-slot in-place write.

Hot-swap safety. The reference replaces its stacked arrays and relies on
a dispatched computation holding its own references; here `set_params`
writes the slot in place. That is safe because every dispatch and every
`set_params` write is enqueued on the same CUDA stream (the current one):
a write is ordered after every dispatch enqueued before it, so an
in-flight dispatch never reads torn weights. The version fence stays on
the host: the pool snapshots per-tenant versions at dispatch.

Over a mesh (`parallel/mesh.py`) the tenant axis is sharded over
`model` and replicated over `data`: `stacked` is then `{mesh position:
params}`, each position holding its model shard's rows on its device
(positions on the same device share one copy). Capacity grows to a
multiple of the model axis; a param swap, an add or a remove writes the
owning shard's replicas only, and `fence` and `rebuilds` count as they
do meshless.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    assemble,
    column_replicas,
    megabatch_placer,
    place_tree,
    tenant_placer,
)
from sitewhere_tpu_torch.utils import grow_pow2, resolve_device


def _clone_to(params, device):
    return tree_map(lambda v: v.detach().to(device, torch.float32).clone(),
                    params)


class TenantStack:
    """Stacked per-tenant params for one model architecture, on `device`
    (the card unless named).

    Tenants occupy integer slots in `[0, capacity)`; removed tenants free
    their slot for reuse. Unoccupied slots hold init params and score
    garbage nobody reads (cheaper than dynamic shapes).
    """

    def __init__(self, model, mesh: Optional[Mesh] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                                f"{type(mesh).__name__}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a stack "
                                 f"on {self.device}")
        self.mesh = mesh
        self.model = model
        self.seed = seed
        self.slots: dict[str, int] = {}
        self.versions: dict[str, int] = {}
        self._free: list[int] = []
        self.capacity = 0
        self.stacked: Optional[dict] = None    # leaves [T_cap, ...]
        # stack-mutation counter: bumped on every mutation (param swap,
        # tenant add/remove, growth) — the observable the fence tests pin
        self.fence = 0
        # capacity growths — the pool surfaces this as the
        # `scoring.stack_rebuilds` counter
        self.rebuilds = 0
        self._init_params = _clone_to(
            model.init(torch.Generator().manual_seed(seed)), self.device)

    # -- sharding helpers ---------------------------------------------------

    @property
    def _model_ax(self) -> int:
        return self.mesh.local_shape[MODEL_AXIS] if self.mesh is not None else 1

    @property
    def _data_ax(self) -> int:
        return self.mesh.local_shape[DATA_AXIS] if self.mesh is not None else 1

    def _full(self):
        """The whole stack on the stack's device (meshless: itself)."""
        if self.mesh is None or self.stacked is None:
            return self.stacked
        blocks = [column_replicas(self.mesh, self.stacked, m)[0]
                  for m in range(self._model_ax)]
        return tree_map(lambda *leaves: torch.cat(
            [leaf.to(self.device) for leaf in leaves]), *blocks)

    def _owner(self, slot: int) -> tuple[list, int]:
        """The param trees holding `slot` (every replica of its model
        shard) and its row in them."""
        if self.mesh is None:
            return [self.stacked], slot
        rows = self.capacity // self._model_ax
        return (column_replicas(self.mesh, self.stacked, slot // rows),
                slot % rows)

    # -- capacity / slots ---------------------------------------------------

    def _grow(self, needed: int) -> None:
        """Grow capacity to a power-of-two multiple of the model axis."""
        m = self._model_ax
        cap = m * grow_pow2((needed + m - 1) // m)
        if cap <= self.capacity:
            return
        old_cap, old = self.capacity, self._full()
        tiled = tree_map(
            lambda leaf: leaf[None].repeat(cap, *(1,) * leaf.ndim),
            self._init_params)
        if old is not None:
            def keep(t, o):
                t[:old_cap] = o
                return t
            tiled = tree_map(keep, tiled, old)
        if self.mesh is not None:
            tiled = place_tree(tiled, tenant_placer(self.mesh), self.mesh)
        self.stacked = tiled
        self.capacity = cap
        self.fence += 1
        self.rebuilds += 1

    def add_tenant(self, tenant_id: str, params: Optional[dict] = None) -> int:
        if tenant_id in self.slots:
            raise ValueError(f"tenant {tenant_id!r} already stacked")
        if self._free:
            slot = self._free.pop()
        else:
            slot = len(self.slots)
            self._grow(slot + 1)
        self.slots[tenant_id] = slot
        self.versions[tenant_id] = 0
        # always (re)write the slice: a reused freed slot still holds the
        # departed tenant's swapped-in weights (cross-tenant leak otherwise)
        self.set_params(tenant_id,
                        params if params is not None else self._init_params,
                        _bump=False)
        return slot

    def remove_tenant(self, tenant_id: str) -> None:
        slot = self.slots.pop(tenant_id, None)
        self.versions.pop(tenant_id, None)
        if slot is not None:
            self._free.append(slot)
            self.fence += 1

    def occupancy(self) -> np.ndarray:
        """[capacity] bool mask of occupied slots (introspection)."""
        occ = np.zeros(self.capacity, bool)
        for slot in self.slots.values():
            occ[slot] = True
        return occ

    def set_params(self, tenant_id: str, params: dict, *,
                   _bump: bool = True) -> int:
        """Hot-swap one tenant's slice (checkpoint rollout): a one-slot
        in-place write on the dispatch stream (see the module docstring);
        the rest of the stack is untouched."""
        trees, row = self._owner(self.slots[tenant_id])

        def write(s, p):
            s[row].copy_(p.detach().to(s.device, s.dtype))
        for tree in trees:
            tree_map(write, tree, params)
        self.fence += 1
        if _bump:
            self.versions[tenant_id] += 1
        return self.versions[tenant_id]

    def get_params(self, tenant_id: str) -> dict:
        """One tenant's params: tensors on the stack's device, cloned from
        its slot."""
        trees, row = self._owner(self.slots[tenant_id])
        return tree_map(lambda s: s[row].to(self.device, copy=True),
                        trees[0])

    # -- scoring ------------------------------------------------------------

    def pad_batch(self, n: int) -> int:
        """Round a per-tenant row count up to a data-axis multiple."""
        d = self._data_ax
        return ((max(n, 1) + d - 1) // d) * d

    def score(self, x: np.ndarray, valid: np.ndarray) -> torch.Tensor:
        """Score all tenants at once from host windows. x/valid:
        [T_cap, B, W] → [T_cap, B] on the device (over a mesh, each
        position scores its tenant rows × batch columns on its device,
        and the blocks land on the mesh's first device). The query/parity
        path; the hot path is the stacked rings' `update_and_score`."""
        if x.shape[0] != self.capacity:
            raise ValueError(f"{x.shape[0]} tenant rows for a stack of "
                             f"{self.capacity}")
        xs = torch.from_numpy(np.asarray(x, np.float32))
        vs = torch.from_numpy(np.asarray(valid, bool))
        score = torch.func.vmap(self.model.score)
        if self.mesh is None:
            return score(self.stacked, xs.to(self.device),
                         vs.to(self.device))
        place = megabatch_placer(self.mesh)
        xd, vd = place(xs), place(vs)
        out = {pos: score(self.stacked[pos], xd.blocks[pos],
                          vd.blocks[pos])
               for pos in self.mesh.positions()}
        return assemble(self.mesh, out, (self.capacity, x.shape[1]))


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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

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

    def __init__(self, model, mesh=None, seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding of the tenant stack and the stacked rings is "
                "not ported yet (ROADMAP A: parallel/mesh.py, multi-GPU)")
        self.device = resolve_device(device)
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

    # -- capacity / slots ---------------------------------------------------

    def _grow(self, needed: int) -> None:
        """Grow capacity to the next power of two."""
        cap = grow_pow2(needed)
        if cap <= self.capacity:
            return
        old_cap, old = self.capacity, self.stacked
        tiled = tree_map(
            lambda leaf: leaf[None].repeat(cap, *(1,) * leaf.ndim),
            self._init_params)
        if old is not None:
            def keep(t, o):
                t[:old_cap] = o
                return t
            tiled = tree_map(keep, tiled, old)
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
        slot = self.slots[tenant_id]

        def write(s, p):
            s[slot].copy_(p.detach().to(s.device, s.dtype))
        tree_map(write, self.stacked, params)
        self.fence += 1
        if _bump:
            self.versions[tenant_id] += 1
        return self.versions[tenant_id]

    def get_params(self, tenant_id: str) -> dict:
        """One tenant's params: tensors on the stack's device, cloned from
        its slot."""
        slot = self.slots[tenant_id]
        return tree_map(lambda s: s[slot].clone(), self.stacked)

    # -- scoring ------------------------------------------------------------

    def pad_batch(self, n: int) -> int:
        """A per-tenant row count as a dispatch width (no data axis to
        round to on one device)."""
        return max(n, 1)

    def score(self, x: np.ndarray, valid: np.ndarray) -> torch.Tensor:
        """Score all tenants at once from host windows. x/valid:
        [T_cap, B, W] → [T_cap, B] on the device. The query/parity path;
        the hot path is the stacked rings' `update_and_score`."""
        if x.shape[0] != self.capacity:
            raise ValueError(f"{x.shape[0]} tenant rows for a stack of "
                             f"{self.capacity}")
        return torch.func.vmap(self.model.score)(
            self.stacked,
            torch.from_numpy(np.asarray(x, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(valid, bool)).to(self.device))

"""Zone geofencing: vectorized location-event evaluation against zone
polygons (reference capability: SiteWhere's zone tests fire alerts when
a location event lands inside/outside a zone [SURVEY.md §2.2
device-management zones; the evaluation hook lives at rule-processing's
stream-processor extension point like every other rule]).

Shape: one LocationBatch = N points; one zone = an E-edge polygon;
containment is a single vectorized ray-casting pass ([N, E] crossing
parity, numpy on the host — the batch sizes here are far below where
shipping them to the card would pay). Transitions, not states,
produce events: a device ENTERING a zone (or EXITING, per config)
emits one alert, held until it leaves again — a parked truck inside a
restricted zone doesn't alert on every telemetry tick.

Config (tenant section `rule-processing`):
    geofences:
      - zone: "loading-dock"       # zone token (device-management)
        alert_on: "enter"          # enter | exit | both
        level: "warning"           # info | warning | error | critical
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

import numpy as np

from sitewhere_tpu_torch.domain.batch import LocationBatch
from sitewhere_tpu_torch.domain.events import AlertLevel

if TYPE_CHECKING:  # pragma: no cover
    from sitewhere_tpu_torch.services.rule_processing import RuleApi

logger = logging.getLogger(__name__)


def points_in_polygon(lat: np.ndarray, lon: np.ndarray,
                      bounds) -> np.ndarray:
    """Ray-casting containment for N points against one polygon.

    lat/lon: [N]; bounds: [(lat, lon), ...] (≥3 vertices, implicit
    closure). → [N] bool. Vectorized over points × edges: a point is
    inside iff a ray to +∞ longitude crosses an odd number of edges.
    Points exactly on an edge may land either side (standard ray-cast
    behavior); geofencing tolerances dwarf that."""
    poly = np.asarray(bounds, np.float64)          # [E, 2] (lat, lon)
    if poly.shape[0] < 3:
        return np.zeros(lat.shape[0], bool)
    y, x = lat[:, None], lon[:, None]              # [N, 1]
    y1, x1 = poly[:, 0][None, :], poly[:, 1][None, :]        # [1, E]
    y2 = np.roll(poly[:, 0], -1)[None, :]
    x2 = np.roll(poly[:, 1], -1)[None, :]
    # edge straddles the point's latitude (half-open to count a vertex
    # crossing exactly once)
    straddle = (y1 <= y) != (y2 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_cross = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
    crossings = straddle & (x < x_cross)
    return (crossings.sum(axis=1) % 2).astype(bool)


class GeofenceHook:
    """A rule hook (`async def __call__(event, api)`) evaluating every
    LocationBatch against the configured zones and emitting transition
    alerts. Zone polygons are fetched lazily from device-management and
    cached against the zone's updated_date (editing a zone takes effect
    on the next batch)."""

    def __init__(self, runtime, tenant_id: str, fences: list[dict]):
        self.runtime = runtime
        self.tenant_id = tenant_id
        self.fences = []
        for f in fences:
            self.fences.append({
                "zone": f["zone"],
                "alert_on": f.get("alert_on", "enter"),
                "level": AlertLevel[f.get("level", "WARNING").upper()],
            })
        # per FENCE (not per zone token: two fences may watch the same
        # zone with different alert_on/level, and sharing state would
        # let the first fence's bookkeeping swallow the second's
        # transition): set of device indices currently inside
        self._inside: list[set[int]] = [set() for _ in self.fences]
        # zone token -> (updated_date, [E, 2] float64 polygon): caches
        # the array conversion; zone edits take effect on the next batch
        self._poly_cache: dict[str, tuple[float, np.ndarray]] = {}
        self._warned_missing: set[str] = set()

    def _zone_polygon(self, token: str):
        dm = self.runtime.api("device-management").management(self.tenant_id)
        zone = dm.get_zone_by_token(token)
        if zone is None:
            if token not in self._warned_missing:
                self._warned_missing.add(token)
                logger.warning(
                    "geofence for tenant %s references unknown zone %r — "
                    "the fence is INERT until that zone exists",
                    self.tenant_id, token)
            return None
        self._warned_missing.discard(token)
        cached = self._poly_cache.get(token)
        if cached is not None and cached[0] == zone.updated_date:
            return cached[1]
        poly = np.asarray(zone.bounds, np.float64).reshape(-1, 2)
        self._poly_cache[token] = (zone.updated_date, poly)
        return poly

    async def __call__(self, event, api: "RuleApi") -> None:
        if not isinstance(event, LocationBatch):
            return
        dev = event.device_index.astype(np.int64, copy=False)
        if dev.size == 0:
            return
        # fence-invariant work once per batch
        lat = np.asarray(event.latitude, np.float64)
        lon = np.asarray(event.longitude, np.float64)
        order = np.argsort(event.ts, kind="stable")  # newest report wins
        for fence, was_inside in zip(self.fences, self._inside):
            token = fence["zone"]
            poly = self._zone_polygon(token)
            if poly is None or poly.shape[0] < 3:
                continue
            inside_now = points_in_polygon(lat, lon, poly)
            latest: dict[int, bool] = {}
            for i in order:
                latest[int(dev[i])] = bool(inside_now[i])
            for d, now_in in latest.items():
                if now_in and d not in was_inside:
                    was_inside.add(d)
                    if fence["alert_on"] in ("enter", "both"):
                        await api.emit_alert(
                            d, fence["level"].value, "zone.enter",
                            f"device entered zone {token}")
                elif not now_in and d in was_inside:
                    was_inside.discard(d)
                    if fence["alert_on"] in ("exit", "both"):
                        await api.emit_alert(
                            d, fence["level"].value, "zone.exit",
                            f"device exited zone {token}")

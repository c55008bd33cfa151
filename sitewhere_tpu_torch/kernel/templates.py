"""Tenant templates: dataset initializers for new tenants.

Reference parity [SURVEY.md §2.1 "tenant-template dataset initializers",
§3.5]: creating a tenant from a template seeds config AND sample data
through the live service APIs, so a templated tenant scores events with
no manual bootstrap. A template contributes:

- default config `sections` (merged under any caller-provided ones), and
- a `seed(runtime, tenant_id)` coroutine run after the tenant's engines
  are up (device types, fleet, groups, assets, scripts).
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional

Seeder = Callable[[object, str], Awaitable[None]]


class TenantTemplate:
    def __init__(self, name: str, description: str,
                 sections: Optional[dict] = None,
                 seed: Optional[Seeder] = None):
        self.name = name
        self.description = description
        self.sections = sections or {}
        self.seed = seed


async def _seed_demo(runtime, tenant_id: str) -> None:
    from sitewhere_tpu_torch.domain.model import (
        Asset,
        AssetType,
        DeviceGroup,
        DeviceGroupElement,
        DeviceType,
    )

    dm = runtime.api("device-management").management(tenant_id)
    dt = dm.create_device_type(DeviceType(token="thermo",
                                          name="Thermometer"))
    dm.bootstrap_fleet(dt, 100)
    group = dm.create_device_group(DeviceGroup(
        token="demo-floor-1", name="Floor 1", roles=("monitoring",)))
    devices = dm.list_devices(page_size=10)
    dm.add_device_group_elements(group.id, [
        DeviceGroupElement(group_id=group.id, device_id=d.id)
        for d in devices])
    try:
        am = runtime.api("asset-management").management(tenant_id)
        at = am.create_asset_type(AssetType(token="hvac", name="HVAC unit"))
        am.create_asset(Asset(token="hvac-1", name="HVAC unit 1",
                              asset_type_id=at.id))
    except KeyError:
        pass  # asset-management not hosted in this process
    try:
        rp = runtime.services["rule-processing"].engines[tenant_id]
        rp.put_script("high-temp-note", DEMO_SCRIPT)
    except KeyError:
        pass


DEMO_SCRIPT = '''\
async def process(value, api):
    """Demo rule: annotate very hot measurements with an extra alert."""
    import numpy as np
    values = getattr(value, "value", None)
    if values is None or not len(values):
        return
    hot = np.nonzero(np.asarray(values) > 90.0)[0]
    for i in hot[:8]:
        await api.emit_alert(int(value.device_index[i]), 1,
                             "demo.high-temp",
                             f"reading {float(values[i]):.1f}")
'''


TEMPLATES: dict[str, TenantTemplate] = {
    "empty": TenantTemplate("empty", "no sample data (the default)"),
    "demo": TenantTemplate(
        "demo",
        "100-device thermometer fleet, device group, HVAC asset, "
        "streaming-LSTM anomaly scoring, sample rule script",
        sections={
            "rule-processing": {"model": "lstm-stream",
                                "model_config": {"window": 64},
                                "threshold": 6.0},
            "device-registration": {"allow_unknown_devices": True,
                                    "default_device_type": "thermo"},
        },
        seed=_seed_demo),
}


def get_template(name: str) -> TenantTemplate:
    try:
        return TEMPLATES[name]
    except KeyError:
        raise ValueError(f"unknown tenant template {name!r} "
                         f"(known: {sorted(TEMPLATES)})") from None


def merged_sections(template: TenantTemplate,
                    sections: Optional[dict]) -> dict:
    """Caller-provided sections override the template's defaults
    per-section (shallow: a named section replaces wholesale)."""
    out = {k: dict(v) for k, v in template.sections.items()}
    out.update(sections or {})
    return out

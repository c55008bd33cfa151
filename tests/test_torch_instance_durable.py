"""instance-management's and asset-management's snapshots across the two
packages: a runtime of one package writes `instance/users.snap`,
`instance/tenants.snap` and `tenants/<t>/assets.snap` under its
`data_dir` and stops; a runtime of the other package starts on the same
directory and restores them. Exact: the same users (a restored password
authenticates, a wrong one does not, and a JWT minted after the restart
carries the same authorities), the same tenants with the same sections,
respun into the runtime, and the same assets."""

import asyncio
from types import SimpleNamespace

import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.kernel import service as tservice

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(config=jconfig, services=jservices, model=jmodel,
                      service=jservice, settings={})
PORT = SimpleNamespace(config=tconfig, services=tservices, model=tmodel,
                       service=tservice, settings={"device": "cpu"})
WAYS = {"jax-to-port": (JAX, PORT), "port-to-jax": (PORT, JAX)}
SECTIONS = {"rule-processing": {"model": None},
            "flow": {"rate": 500.0, "burst": 100.0}}


def _runtime(pkg, data_dir):
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="durable", data_dir=str(data_dir), **pkg.settings))
    rt.add_service(pkg.services.InstanceManagementService(rt,
                                                          serve_rest=False))
    rt.add_service(pkg.services.DeviceManagementService(rt))
    rt.add_service(pkg.services.AssetManagementService(rt))
    return rt


async def _write(pkg, data_dir):
    rt = _runtime(pkg, data_dir)
    await rt.start()
    try:
        im = rt.services["instance-management"]
        im.create_user("op", "s3cret", ("REST", "ADMINISTER_TENANTS"),
                       "Op", "Erator")
        await im.create_tenant("acme", "Acme", SECTIONS, ("op",))
        await im.create_tenant("beta", "Beta", {"rule-processing": {
            "model": None}})
        await im.update_tenant("beta", name="Beta Two")
        am = rt.api("asset-management").management("acme")
        at = am.create_asset_type(pkg.model.AssetType(token="hvac",
                                                      name="HVAC"))
        am.create_asset(pkg.model.Asset(token="hvac-1", name="HVAC 1",
                                        asset_type_id=at.id))
        return _state(rt)
    finally:
        await rt.stop()


def _state(rt):
    im = rt.services["instance-management"]
    users = sorted((u.username, u.first_name, u.last_name,
                    tuple(u.authorities), u.id)
                   for u in im.users.list_users())
    tenants = sorted((t.token, t.name, t.auth_token,
                      tuple(t.authorized_user_ids), t.id)
                     for t in im.list_tenants())
    configs = {tid: (cfg.name, cfg.sections)
               for tid, cfg in sorted(rt.tenants.items())}
    am = rt.api("asset-management").management("acme")
    assets = sorted((a.token, a.name, a.asset_type_id, a.id)
                    for a in am.list_assets())
    return {"users": users, "tenants": tenants, "configs": configs,
            "assets": assets}


async def _read(pkg, data_dir):
    rt = _runtime(pkg, data_dir)
    await rt.start()
    try:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10.0
        # restored tenants respin once every service has started
        while len(rt.tenants) < 2:
            assert loop.time() < deadline, sorted(rt.tenants)
            await asyncio.sleep(0.02)
        im = rt.services["instance-management"]
        token = im.authenticate("op", "s3cret")
        ctx = im.validate(token)
        return _state(rt), (ctx.username, ctx.authorities), \
            im.authenticate("op", "wrong"), \
            im.authenticate("admin", "password") is not None
    finally:
        await rt.stop()


@pytest.mark.parametrize("way", list(WAYS))
def test_instance_restarts_from_the_other_packages_snapshots(way, tmp_path,
                                                              run):
    writer, reader = WAYS[way]

    async def main():
        wrote = await _write(writer, tmp_path)
        read = await _read(reader, tmp_path)
        return wrote, read

    wrote, (state, op, wrong, admin) = run(main())
    assert (tmp_path / "instance" / "users.snap").is_file()
    assert (tmp_path / "instance" / "tenants.snap").is_file()
    assert (tmp_path / "tenants" / "acme" / "assets.snap").is_file()
    assert state == wrote
    assert op == ("op", ("REST", "ADMINISTER_TENANTS"))
    assert wrong is None and admin
    assert state["configs"]["acme"] == ("Acme", SECTIONS)
    assert state["configs"]["beta"][0] == "Beta Two"

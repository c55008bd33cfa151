"""JWTs between the two packages: `kernel/security.py` is a copy of the
JAX package's, so a token minted by either verifies in the other, and
on one clock the two mint the same bytes. Exact: no tolerance."""

import pytest
import torch

from sitewhere_tpu.kernel import security as jsec
from sitewhere_tpu_torch.kernel import security as tsec

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

PACKAGES = {"jax": jsec, "port": tsec}
PAIRS = [("jax", "port"), ("port", "jax")]


@pytest.mark.parametrize("minter,checker", PAIRS)
@pytest.mark.parametrize("kind", ["user", "system"])
def test_token_minted_by_one_verifies_in_the_other(minter, checker, kind):
    mint = PACKAGES[minter].TokenManagement("s3cret", expiration_s=600)
    check = PACKAGES[checker].TokenManagement("s3cret", expiration_s=600)
    if kind == "user":
        token = mint.issue("alice", ("REST", "ADMINISTER_USERS"))
    else:
        token = mint.system_token()
    got = check.validate(token)
    want = mint.validate(token)
    assert got is not None and want is not None
    assert (got.username, got.authorities, got.is_system) == (
        want.username, want.authorities, want.is_system)
    assert got.has_authority("ADMINISTER_USERS") == want.has_authority(
        "ADMINISTER_USERS")
    assert got.has_authority("ADMINISTER_TENANTS") == want.has_authority(
        "ADMINISTER_TENANTS")


@pytest.mark.parametrize("minter,checker", PAIRS)
def test_refusals_agree(minter, checker):
    """Expired, tampered, foreign-secret, foreign-issuer and garbage
    tokens are refused on both sides."""
    mint = PACKAGES[minter].TokenManagement("s3cret")
    check = PACKAGES[checker].TokenManagement("s3cret")
    good = mint.issue("bob", ("REST",))
    bad = {
        "expired": mint.issue("bob", ("REST",), expiration_s=-10),
        "tampered": good[:-4] + ("AAAA" if not good.endswith("AAAA")
                                 else "BBBB"),
        "secret": PACKAGES[minter].TokenManagement("other").issue("bob"),
        "issuer": PACKAGES[minter].TokenManagement(
            "s3cret", issuer="elsewhere").issue("bob"),
        "garbage": "not.a.jwt",
        "empty": "",
    }
    for name, token in bad.items():
        assert check.validate(token) is None, name
        assert mint.validate(token) is None, name


def test_same_clock_same_bytes(monkeypatch):
    """With the clock fixed, both packages mint identical tokens."""
    monkeypatch.setattr(jsec.time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(tsec.time, "time", lambda: 1_700_000_000.25)
    for args, kw in [(("u", ("REST",)), {}),
                     (("admin", jsec.ALL_AUTHORITIES), {"expiration_s": 5}),
                     (("system", ()), {"is_system": True})]:
        a = jsec.TokenManagement("k").issue(*args, **kw)
        b = tsec.TokenManagement("k").issue(*args, **kw)
        assert a == b


def test_authority_constants_match():
    assert tsec.ALL_AUTHORITIES == jsec.ALL_AUTHORITIES
    for name in ("AUTH_REST", "AUTH_ADMIN_USERS", "AUTH_ADMIN_TENANTS",
                 "AUTH_ADMIN_SCRIPTS"):
        assert getattr(tsec, name) == getattr(jsec, name)

"""Security: JWT issue/validate + system user (reference parity:
`TokenManagement`, `SystemUser`, JWT interceptors — [SURVEY.md §2.1
"Security"]).

Stdlib-only JWT (HS256): header.payload.signature with base64url parts
and an HMAC-SHA256 signature — interoperable with standard JWT parsers.
Service-to-service calls use the system user's token the same way the
reference's microservices do.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass
from typing import Optional


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


@dataclass(frozen=True)
class AuthContext:
    """Validated caller identity attached to a request."""

    username: str
    authorities: tuple[str, ...]
    is_system: bool = False

    def has_authority(self, authority: str) -> bool:
        return self.is_system or authority in self.authorities


class TokenManagement:
    """(reference: TokenManagement) HS256 JWT issue/validate."""

    def __init__(self, secret: str, expiration_s: int = 3600,
                 issuer: str = "swx"):
        self._key = secret.encode()
        self.expiration_s = expiration_s
        self.issuer = issuer

    def issue(self, username: str, authorities: tuple[str, ...] = (),
              *, is_system: bool = False,
              expiration_s: Optional[int] = None) -> str:
        header = {"alg": "HS256", "typ": "JWT"}
        now = int(time.time())
        payload = {
            "sub": username,
            "iss": self.issuer,
            "iat": now,
            "exp": now + (expiration_s or self.expiration_s),
            "auth": list(authorities),
            "sys": is_system,
        }
        signing_input = (_b64url(json.dumps(header, separators=(",", ":")).encode())
                         + "." +
                         _b64url(json.dumps(payload, separators=(",", ":")).encode()))
        sig = hmac.new(self._key, signing_input.encode(), hashlib.sha256).digest()
        return signing_input + "." + _b64url(sig)

    def validate(self, token: str) -> Optional[AuthContext]:
        """Returns the AuthContext, or None if invalid/expired."""
        try:
            signing_input, sig_part = token.rsplit(".", 1)
            expected = hmac.new(self._key, signing_input.encode(),
                                hashlib.sha256).digest()
            if not hmac.compare_digest(expected, _b64url_decode(sig_part)):
                return None
            payload = json.loads(_b64url_decode(signing_input.split(".")[1]))
        except (ValueError, KeyError, json.JSONDecodeError):
            return None
        if payload.get("iss") != self.issuer:
            return None
        if payload.get("exp", 0) < time.time():
            return None
        return AuthContext(username=payload.get("sub", ""),
                           authorities=tuple(payload.get("auth", [])),
                           is_system=bool(payload.get("sys")))

    def system_token(self) -> str:
        """(reference: SystemUser) token for service-to-service calls."""
        return self.issue("system", (), is_system=True)


# standard granted authorities (subset of the reference's catalog)
AUTH_REST = "REST"
AUTH_ADMIN_USERS = "ADMINISTER_USERS"
AUTH_ADMIN_TENANTS = "ADMINISTER_TENANTS"
AUTH_ADMIN_SCRIPTS = "ADMINISTER_SCRIPTS"
ALL_AUTHORITIES = (AUTH_REST, AUTH_ADMIN_USERS, AUTH_ADMIN_TENANTS,
                   AUTH_ADMIN_SCRIPTS)

"""HTTP authentication for the serving layer.

Parity: the reference protects all endpoints with DIGEST auth against a
single-user in-memory realm (ServingLayer.java DIGEST constant +
InMemoryRealm; user/password from oryx.serving.api.user-name/password).
RFC 7616 MD5 digest with qop="auth"; nonces are HMAC-stamped timestamps so
validation is stateless (no nonce table to grow or lock), with a freshness
window and `stale=true` re-challenge semantics. Basic over TLS remains
available via oryx.serving.api.auth-scheme = "basic".
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import secrets
import time

REALM = "Oryx"
_NONCE_TTL_SEC = 300.0


def _md5(s: str) -> str:
    return hashlib.md5(s.encode("utf-8")).hexdigest()


def _parse_auth_params(header: str) -> dict[str, str]:
    """Parse the comma-separated (possibly quoted) k=v list of a Digest
    Authorization header."""
    out: dict[str, str] = {}
    rest = header
    while rest:
        rest = rest.lstrip(", ")
        if "=" not in rest:
            break
        key, rest = rest.split("=", 1)
        key = key.strip().lower()
        if rest.startswith('"'):
            end = rest.find('"', 1)
            if end < 0:
                break
            out[key] = rest[1:end]
            rest = rest[end + 1:]
        else:
            end = rest.find(",")
            if end < 0:
                out[key] = rest.strip()
                rest = ""
            else:
                out[key] = rest[:end].strip()
                rest = rest[end:]
    return out


class Authenticator:
    """Interface: check(method, uri, auth_header) -> True | challenge str.

    A str return is the WWW-Authenticate value to send with a 401.
    """

    def check(self, method: str, uri: str, header: str | None):  # pragma: no cover
        raise NotImplementedError


class BasicAuthenticator(Authenticator):
    def __init__(self, user: str, password: str):
        token = base64.b64encode(f"{user}:{password}".encode()).decode()
        self._expect = f"Basic {token}"

    def check(self, method: str, uri: str, header: str | None):
        if header is not None and hmac.compare_digest(header, self._expect):
            return True
        return f'Basic realm="{REALM}"'


class DigestAuthenticator(Authenticator):
    """Stateless RFC 7616 (MD5, qop=auth) verifier for one user."""

    def __init__(self, user: str, password: str, secret: bytes | None = None):
        self.user = user
        # HA1 precomputed: the realm never changes, and this mirrors the
        # reference's digest-ready credential storage in InMemoryRealm
        self._ha1 = _md5(f"{user}:{REALM}:{password}")
        self._secret = secret if secret is not None else os.urandom(32)

    # -- nonces ------------------------------------------------------------

    def _make_nonce(self) -> str:
        ts = f"{time.time():.3f}"
        mac = hmac.new(self._secret, ts.encode(), hashlib.sha256).hexdigest()[:24]
        return f"{ts}:{mac}"

    def _nonce_fresh(self, nonce: str) -> bool:
        ts, _, mac = nonce.partition(":")
        want = hmac.new(self._secret, ts.encode(), hashlib.sha256).hexdigest()[:24]
        if not hmac.compare_digest(mac, want):
            return False
        try:
            age = time.time() - float(ts)
        except ValueError:
            return False
        # small negative tolerance: the stamp is rounded to the nearest ms,
        # so a just-issued nonce can sit fractionally in the future
        return -1.0 <= age <= _NONCE_TTL_SEC

    def challenge(self, stale: bool = False) -> str:
        extra = ", stale=true" if stale else ""
        return (
            f'Digest realm="{REALM}", qop="auth", algorithm=MD5, '
            f'nonce="{self._make_nonce()}", opaque="{secrets.token_hex(8)}"{extra}'
        )

    # -- verification ------------------------------------------------------

    def check(self, method: str, uri: str, header: str | None):
        if not header or not header.startswith("Digest "):
            return self.challenge()
        p = _parse_auth_params(header[len("Digest "):])
        required = ("username", "nonce", "uri", "response")
        if any(k not in p for k in required):
            return self.challenge()
        if p["username"] != self.user:
            return self.challenge()
        # uri must match the request target (ignore authority-form quirks)
        if p["uri"] != uri:
            return self.challenge()
        ha2 = _md5(f"{method}:{p['uri']}")
        qop = p.get("qop")
        if qop == "auth":
            if "nc" not in p or "cnonce" not in p:
                return self.challenge()
            expect = _md5(
                f"{self._ha1}:{p['nonce']}:{p['nc']}:{p['cnonce']}:auth:{ha2}"
            )
        elif qop is None:  # RFC 2069 compatibility
            expect = _md5(f"{self._ha1}:{p['nonce']}:{ha2}")
        else:
            return self.challenge()
        if not hmac.compare_digest(p["response"], expect):
            return self.challenge()
        if not self._nonce_fresh(p["nonce"]):
            # correct credentials, expired nonce: re-challenge without
            # making the client re-prompt (RFC 7616 stale semantics)
            return self.challenge(stale=True)
        return True


def make_authenticator(config) -> Authenticator | None:
    """Build the configured authenticator, or None when auth is off
    (user-name/password unset, like the reference's optional realm)."""
    user = config.get_string("oryx.serving.api.user-name", None)
    password = config.get_string("oryx.serving.api.password", None)
    if not user or not password:
        return None
    scheme = (config.get_string("oryx.serving.api.auth-scheme", None) or "digest").lower()
    if scheme == "basic":
        return BasicAuthenticator(user, password)
    if scheme == "digest":
        return DigestAuthenticator(user, password)
    raise ValueError(f"unknown oryx.serving.api.auth-scheme: {scheme}")

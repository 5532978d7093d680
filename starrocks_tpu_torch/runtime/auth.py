"""Authentication + table-level authorization.

Reference behavior: fe/fe-core/.../authentication/AuthenticationMgr.java
(mysql_native_password verification against a stored double-SHA1) and
authorization/AuthorizationMgr.java (privilege collections), re-designed to
the analytic subset: users carry table-level SELECT/INSERT/UPDATE/DELETE
grants plus an ALL-on-* admin form. State lives on the catalog (the FE
metadata holder) and is process-local like the rest of the control plane.
"""

from __future__ import annotations

import hashlib
import secrets


def _sha1(b: bytes) -> bytes:
    return hashlib.sha1(b).digest()


def scramble_password(password: str, salt: bytes) -> bytes:
    """Client-side mysql_native_password token:
    SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    s1 = _sha1(password.encode())
    s2 = _sha1(s1)
    mask = _sha1(salt + s2)
    return bytes(a ^ b for a, b in zip(s1, mask))


ALL_PRIVS = frozenset({"select", "insert", "update", "delete"})


class AuthManager:
    def __init__(self):
        # user -> stage2 hash SHA1(SHA1(pw)) (b"" = empty password)
        self.users: dict = {"root": b""}
        # user -> {table_or_* : set(privs)}; root is implicit admin
        self.grants: dict = {"root": {"*": set(ALL_PRIVS)}}

    # --- authentication ------------------------------------------------------
    @staticmethod
    def new_salt() -> bytes:
        # scramble bytes must be 1..255: several clients parse the second
        # salt half as a NUL-terminated C string
        return bytes(secrets.randbelow(255) + 1 for _ in range(20))

    def create_user(self, user: str, password: str):
        if user in self.users:
            raise ValueError(f"user {user!r} already exists")
        self.users[user] = _sha1(_sha1(password.encode())) if password else b""
        self.grants.setdefault(user, {})

    def drop_user(self, user: str):
        if user == "root":
            raise ValueError("cannot drop root")
        self.users.pop(user, None)
        self.grants.pop(user, None)

    def verify_plain(self, user: str, password: str) -> bool:
        """Plaintext check (HTTP Basic auth path)."""
        import hmac

        stage2 = self.users.get(user)
        if stage2 is None:
            return False
        if stage2 == b"":
            return password == ""
        calc = _sha1(_sha1(password.encode()))
        return hmac.compare_digest(calc, stage2)

    def verify(self, user: str, salt: bytes, token: bytes) -> bool:
        stage2 = self.users.get(user)
        if stage2 is None:
            return False
        if stage2 == b"":
            return token == b""
        if len(token) != 20:
            return False
        mask = _sha1(salt + stage2)
        sha1_pw = bytes(a ^ b for a, b in zip(token, mask))
        return _sha1(sha1_pw) == stage2

    # --- authorization -------------------------------------------------------
    def grant(self, user: str, table: str, privs):
        if user not in self.users:
            raise ValueError(f"unknown user {user!r}")
        g = self.grants.setdefault(user, {})
        g.setdefault(table.lower(), set()).update(privs)

    def revoke(self, user: str, table: str, privs):
        g = self.grants.get(user, {})
        if table.lower() in g:
            g[table.lower()] -= set(privs)

    def check(self, user: str, table: str, priv: str) -> bool:
        g = self.grants.get(user, {})
        return priv in g.get("*", ()) or priv in g.get(table.lower(), ())

    def is_admin(self, user: str) -> bool:
        return ALL_PRIVS <= self.grants.get(user, {}).get("*", set())

    def require(self, user: str, table: str, priv: str):
        if not self.check(user, table, priv):
            raise PermissionError(
                f"{priv.upper()} command denied to user {user!r} "
                f"for table {table!r}")

    def show_grants(self, user: str):
        out = []
        for table, privs in sorted(self.grants.get(user, {}).items()):
            if privs:
                out.append(
                    f"GRANT {', '.join(sorted(p.upper() for p in privs))} "
                    f"ON {table} TO '{user}'")
        return out or [f"GRANT USAGE ON * TO '{user}'"]

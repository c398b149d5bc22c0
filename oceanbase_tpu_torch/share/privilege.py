"""User accounts + table privileges, enforced at statement resolve time.

Reference surface: src/sql/privilege_check/ (ObOraSysChecker and the
MySQL-mode priv check entrypoints) and the DCL resolvers under
src/sql/resolver/dcl/ — GRANT/REVOKE mutate the privilege columns of the
__all_user / __all_database_privilege inner tables, and every resolved
statement is checked against them before optimization.

The rebuild keeps the same shape at this engine's scale: one
PrivilegeManager per tenant Database, persisted in node meta (grants
survive restart exactly like schema), checked in DbSession._dispatch
before any plan executes. MySQL-compatible error codes surface through
SqlError.code (1142 ER_TABLEACCESS_DENIED_ERROR, 1045 for bad login,
1396 for user-management failures).
"""

from __future__ import annotations

import hashlib

PRIVS = {"select", "insert", "update", "delete", "create", "drop", "index"}


def stage2_hash(password: str) -> str:
    """mysql_native_password stage-2 hash SHA1(SHA1(pw)) as hex ('' stays
    ''). This is what __all_user stores in the reference — never the
    plaintext — and it is all the front door needs to verify a login
    scramble (see mysql_front.verify_native_password)."""
    if not password:
        return ""
    return hashlib.sha1(hashlib.sha1(password.encode()).digest()).hexdigest()

ER_TABLEACCESS_DENIED = 1142
ER_CANNOT_USER = 1396
ER_ACCESS_DENIED = 1045


class AccessDenied(Exception):
    def __init__(self, msg: str, code: int = ER_TABLEACCESS_DENIED):
        super().__init__(msg)
        self.code = code


class PrivilegeManager:
    """Accounts + grants. `root` is the bootstrap superuser (implicit ALL
    everywhere, cannot be dropped) — the reference's __all_user bootstrap
    row. Grants: user -> object ('*' = global) -> set of privileges."""

    def __init__(self, users: dict[str, str] | None = None,
                 grants: dict[str, dict[str, set]] | None = None):
        self.users = dict(users) if users else {"root": ""}
        self.users.setdefault("root", "")
        self.grants: dict[str, dict[str, set]] = {
            u: {o: set(p) for o, p in g.items()}
            for u, g in (grants or {}).items()
        }

    # ------------------------------------------------------- accounts
    def create_user(self, name: str, password: str) -> None:
        if name in self.users:
            raise AccessDenied(
                f"CREATE USER failed: '{name}' exists", ER_CANNOT_USER)
        # Only the stage-2 hash is ever stored (or persisted via to_meta):
        # plaintext at rest would disclose every credential to any
        # meta-file read.
        self.users[name] = stage2_hash(password)
        self.grants.setdefault(name, {})

    def drop_user(self, name: str) -> None:
        if name == "root":
            raise AccessDenied("cannot drop root", ER_CANNOT_USER)
        if name not in self.users:
            raise AccessDenied(
                f"DROP USER failed: no user '{name}'", ER_CANNOT_USER)
        del self.users[name]
        self.grants.pop(name, None)

    def authenticate_db(self) -> dict[str, str]:
        """name -> stage2-hash map for the MySQL front door."""
        return dict(self.users)

    # --------------------------------------------------------- grants
    def grant(self, user: str, obj: str, privs) -> None:
        if user not in self.users:
            raise AccessDenied(
                f"GRANT to unknown user '{user}'", ER_CANNOT_USER)
        ps = set(privs)
        if "all" in ps:
            ps = set(PRIVS)
        bad = ps - PRIVS
        if bad:
            raise AccessDenied(f"unknown privileges {sorted(bad)}")
        self.grants.setdefault(user, {}).setdefault(obj, set()).update(ps)

    def revoke(self, user: str, obj: str, privs) -> None:
        if user not in self.users:
            raise AccessDenied(
                f"REVOKE from unknown user '{user}'", ER_CANNOT_USER)
        ps = set(privs)
        if "all" in ps:
            ps = set(PRIVS)
        have = self.grants.get(user, {}).get(obj)
        if have is not None:
            have -= ps
            if not have:
                self.grants[user].pop(obj, None)

    def check(self, user: str, priv: str, objs) -> None:
        """Raise AccessDenied(1142) unless `user` holds `priv` on every
        object in `objs` (directly or via the '*' global grant)."""
        if user == "root":
            return
        g = self.grants.get(user, {})
        glob = g.get("*", ())
        for obj in objs:
            if priv in glob or priv in g.get(obj, ()):
                continue
            raise AccessDenied(
                f"{priv.upper()} command denied to user '{user}' "
                f"for table '{obj}'"
            )

    # ---------------------------------------------------- persistence
    def to_meta(self) -> dict:
        return {
            "users": dict(self.users),
            "hashed": True,
            "grants": {
                u: {o: sorted(p) for o, p in g.items()}
                for u, g in self.grants.items()
            },
        }

    @classmethod
    def from_meta(cls, meta: dict | None) -> "PrivilegeManager":
        if not meta:
            return cls()
        users = meta.get("users")
        if users and not meta.get("hashed"):
            # Pre-r5 metas persisted plaintext — hash on load, and the
            # next to_meta writes the hashed form.
            users = {u: stage2_hash(p) for u, p in users.items()}
        return cls(users, meta.get("grants"))

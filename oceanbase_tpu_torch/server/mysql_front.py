"""MySQL wire-protocol front door: stock clients connect and run SQL.

Reference surface: the MySQL command layer — connection handshake and
COM_QUERY dispatch (src/observer/mysql/obmp_query.cpp:53, obmp_connect),
prepared statements (obmp_stmt_prepare.cpp / obmp_stmt_execute.cpp),
packet codecs (deps/oblib/src/rpc/obmysql). The rebuild speaks classic
protocol v10 / CLIENT_PROTOCOL_41:

  greeting -> login (mysql_native_password verified against the user
  table) -> OK
  COM_QUERY         -> text resultset (typed column defs, EOF, rows, EOF)
                       or OK (DML/DDL with affected-rows) or ERR
  COM_STMT_PREPARE  -> stmt id + param count ('?' placeholders)
  COM_STMT_EXECUTE  -> binary resultset (typed rows, NULL bitmap); bound
                       parameters substitute as literals and ride the
                       plan cache's parameterization, so re-executions
                       reuse the compiled XLA artifact
  COM_STMT_CLOSE / COM_PING / COM_INIT_DB / COM_QUIT

Each connection binds one DbSession (transactions span statements on the
same connection, like a real server thread). Column defs carry real
types (LONGLONG / DOUBLE / VAR_STRING) derived from the result arrays.
"""

from __future__ import annotations

import hashlib
import socket
import socketserver
import struct
import threading
import time as _time

import numpy as np

from .database import Database, SqlError

CLIENT_PROTOCOL_41 = 0x0200
CLIENT_CONNECT_WITH_DB = 0x0008
CLIENT_SSL = 0x0800
CLIENT_SECURE_CONNECTION = 0x8000

MYSQL_TYPE_LONGLONG = 8
MYSQL_TYPE_DOUBLE = 5
MYSQL_TYPE_VAR_STRING = 253


def native_password_scramble(password: str, salt: bytes) -> bytes:
    """mysql_native_password CLIENT side:
    SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def verify_native_password(stage2_hex: str, auth: bytes, salt: bytes) -> bool:
    """SERVER side: the stored credential is only the stage-2 hash
    SHA1(SHA1(pw)) (privilege.stage2_hash) — recover stage1 from the
    client scramble as auth XOR SHA1(salt + stage2) and check
    SHA1(stage1) == stage2. The plaintext never exists server-side."""
    import hmac

    if not stage2_hex:
        return len(auth) == 0
    if len(auth) != 20:
        return False
    h2 = bytes.fromhex(stage2_hex)
    h3 = hashlib.sha1(salt + h2).digest()
    h1 = bytes(a ^ b for a, b in zip(auth, h3))
    return hmac.compare_digest(hashlib.sha1(h1).digest(), h2)


def _lenenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + n.to_bytes(2, "little")
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little")
    return b"\xfe" + n.to_bytes(8, "little")


def _lenenc_str(s: bytes) -> bytes:
    return _lenenc_int(len(s)) + s


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def read_packet(self) -> bytes:
        head = self._read_n(4)
        length = int.from_bytes(head[:3], "little")
        self.seq = (head[3] + 1) & 0xFF
        return self._read_n(length)

    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    def send_packet(self, payload: bytes) -> None:
        head = len(payload).to_bytes(3, "little") + bytes([self.seq])
        self.seq = (self.seq + 1) & 0xFF
        self.sock.sendall(head + payload)

    def reset_seq(self) -> None:
        self.seq = 0


def _ok_packet(affected: int = 0, info: bytes = b"") -> bytes:
    return (
        b"\x00" + _lenenc_int(affected) + _lenenc_int(0)
        + (0x0002).to_bytes(2, "little")  # SERVER_STATUS_AUTOCOMMIT
        + (0).to_bytes(2, "little") + info
    )


def _eof_packet() -> bytes:
    return b"\xfe" + (0).to_bytes(2, "little") + (0x0002).to_bytes(2, "little")


def _err_packet(code: int, msg: str) -> bytes:
    return (
        b"\xff" + code.to_bytes(2, "little") + b"#HY000"
        + msg.encode()[:400]
    )


def _coldef(name: str, mysql_type: int = MYSQL_TYPE_VAR_STRING) -> bytes:
    return (
        _lenenc_str(b"def") + _lenenc_str(b"") + _lenenc_str(b"")
        + _lenenc_str(b"") + _lenenc_str(name.encode())
        + _lenenc_str(name.encode())
        + b"\x0c" + (33).to_bytes(2, "little")  # utf8
        + (255).to_bytes(4, "little")
        + bytes([mysql_type])
        + (0).to_bytes(2, "little") + b"\x00" + b"\x00\x00"
    )


def _col_mysql_type(col) -> int:
    """Real wire type from the host result array (the typed-resultset
    surface obmp_query builds from ObField types)."""
    a = np.asarray(col)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return MYSQL_TYPE_LONGLONG
    if np.issubdtype(a.dtype, np.floating):
        return MYSQL_TYPE_DOUBLE
    return MYSQL_TYPE_VAR_STRING


def _cell(v) -> bytes:
    if v is None:
        return b"\xfb"
    if isinstance(v, float) and v != v:  # NaN surfaces SQL NULL
        return b"\xfb"
    if isinstance(v, (np.floating, float)):
        return _lenenc_str(repr(float(v)).encode())
    if isinstance(v, (np.integer, int)):
        return _lenenc_str(str(int(v)).encode())
    return _lenenc_str(str(v).encode())


# --------------------------------------------------------------------------
# Response builders shared by BOTH front ends (threaded MySqlFrontend here,
# AsyncMySqlFrontend in async_front.py). Each returns the response as an
# ordered list of packet payloads — framing/sequencing belongs to the
# transport — so the two servers emit byte-identical result sets.

def _split_placeholders(sql: str) -> list[str]:
    """SQL split at '?' placeholders outside quoted regions ('...',
    "...", `...`) and comments (-- to EOL, /* */) — a '?' inside any
    of those is literal text, and miscounting here shifts every
    later COM_STMT_EXECUTE substitution by one."""
    pieces, cur = [], []
    quote = None  # "'", '"' or '`' while inside that quoted region
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if quote is not None:
            cur.append(ch)
            if ch == quote:
                # doubled-quote escape stays inside the region
                if i + 1 < n and sql[i + 1] == quote:
                    cur.append(quote)
                    i += 1
                else:
                    quote = None
        elif ch in ("'", '"', "`"):
            quote = ch
            cur.append(ch)
        elif ch == "-" and i + 1 < n and sql[i + 1] == "-" and (
            i + 2 >= n or sql[i + 2] in " \t\n"
        ):
            # MySQL comment syntax: '--' must be followed by
            # whitespace (or EOL) — `x=x--1` is double negation
            j = sql.find("\n", i)
            j = n if j < 0 else j
            cur.append(sql[i:j])
            i = j - 1
        elif ch == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            cur.append(sql[i:j])
            i = j - 1
        elif ch == "?":
            pieces.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    pieces.append("".join(cur))
    return pieces


def _decode_params(pkt: bytes, nparams: int,
                   prev_types: list[int] | None) -> tuple[list, list[int]]:
    """Binary parameter block of COM_STMT_EXECUTE. Returns
    (values, types); `prev_types` supplies the types when the driver
    sets new_params_bound_flag=0 (every re-execution)."""
    if nparams == 0:
        # bitmap/flag/types are OMITTED entirely for param-less stmts
        return [], []
    off = 1 + 4 + 1 + 4  # cmd, stmt id, flags, iteration count
    nb = (nparams + 7) // 8
    null_bitmap = pkt[off:off + nb]
    off += nb
    new_bound = pkt[off]
    off += 1
    types: list[int] = []
    if new_bound:
        for _ in range(nparams):
            types.append(pkt[off] | (pkt[off + 1] << 8))
            off += 2
    elif prev_types is not None:
        types = prev_types
    else:
        types = [MYSQL_TYPE_VAR_STRING] * nparams

    def lenenc():
        nonlocal off
        b0 = pkt[off]
        off += 1
        if b0 < 251:
            n = b0
        elif b0 == 0xFC:
            n = int.from_bytes(pkt[off:off + 2], "little")
            off += 2
        elif b0 == 0xFD:
            n = int.from_bytes(pkt[off:off + 3], "little")
            off += 3
        else:
            n = int.from_bytes(pkt[off:off + 8], "little")
            off += 8
        s = pkt[off:off + n]
        off += n
        return s

    out = []
    for i in range(nparams):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            out.append(None)
            continue
        t = types[i] & 0xFF
        if t == 1:  # TINY
            out.append(int.from_bytes(
                pkt[off:off + 1], "little", signed=True))
            off += 1
        elif t == 2:  # SHORT
            out.append(int.from_bytes(
                pkt[off:off + 2], "little", signed=True))
            off += 2
        elif t == 3:  # LONG
            out.append(int.from_bytes(
                pkt[off:off + 4], "little", signed=True))
            off += 4
        elif t == 8:  # LONGLONG
            out.append(int.from_bytes(
                pkt[off:off + 8], "little", signed=True))
            off += 8
        elif t == 4:  # FLOAT
            out.append(struct.unpack_from("<f", pkt, off)[0])
            off += 4
        elif t == 5:  # DOUBLE
            out.append(struct.unpack_from("<d", pkt, off)[0])
            off += 8
        else:  # strings, decimals, dates: length-encoded text
            out.append(lenenc().decode())
    return out, types


def _literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    s = str(v).replace("'", "''")
    return f"'{s}'"


def _fold_wire(sess, phase: str, seconds: float) -> None:
    """Host-tax attribution for wall spent OUTSIDE the statement ledger
    (the ledger closed when sess.sql returned): result encode / packet
    work rides the statement's digest aggregate via fold_extra, which
    adds to both the phase and the digest e2e so digest-level
    conservation still holds."""
    ht = getattr(sess.db, "host_tax", None)
    dg = getattr(sess, "_last_digest", "")
    if ht is not None and ht.enabled and dg and seconds > 0.0:
        ht.fold_extra(dg, phase, seconds)


def query_payloads(sess, sql: str) -> list[bytes]:
    """COM_QUERY: text resultset (typed column defs, EOF, rows, EOF),
    or OK (DML/DDL with affected-rows), or ERR."""
    try:
        rs = sess.sql(sql)
    except Exception as e:  # SqlError, parse errors, resolver errors
        return [_err_packet(
            getattr(e, "code", 1064), f"{type(e).__name__}: {e}")]
    if not rs.names:
        return [_ok_packet(affected=rs.affected)]
    tw = _time.perf_counter()
    cols = [rs.columns[n] for n in rs.names]
    out = [_lenenc_int(len(rs.names))]
    for n, c in zip(rs.names, cols):
        out.append(_coldef(n, _col_mysql_type(c)))
    out.append(_eof_packet())
    for i in range(rs.nrows):
        out.append(b"".join(_cell(c[i]) for c in cols))
    out.append(_eof_packet())
    _fold_wire(sess, "wire write", _time.perf_counter() - tw)
    return out


def stmt_prepare_payloads(sql: str, stmts: dict, next_stmt: list) -> list[bytes]:
    """COM_STMT_PREPARE: register the pieces under a fresh statement id
    and answer COM_STMT_PREPARE_OK (+ param defs when any)."""
    pieces = _split_placeholders(sql)
    nparams = len(pieces) - 1
    sid = next_stmt[0]
    next_stmt[0] += 1
    stmts[sid] = [pieces, nparams, None]
    # COM_STMT_PREPARE_OK: status, stmt id, 0 columns (deferred to
    # execute), param count, filler, warnings
    out = [
        b"\x00" + sid.to_bytes(4, "little")
        + (0).to_bytes(2, "little")
        + nparams.to_bytes(2, "little")
        + b"\x00" + (0).to_bytes(2, "little")
    ]
    for _ in range(nparams):
        out.append(_coldef("?", MYSQL_TYPE_VAR_STRING))
    if nparams:
        out.append(_eof_packet())
    return out


def stmt_execute_payloads(sess, pkt: bytes, stmts: dict) -> list[bytes]:
    """COM_STMT_EXECUTE: binary resultset (typed rows, NULL bitmap).
    Bound parameters substitute as literals and ride the plan cache's
    parameterization, so re-executions reuse the compiled artifact."""
    tr = _time.perf_counter()
    sid = int.from_bytes(pkt[1:5], "little")
    entry = stmts.get(sid)
    if entry is None:
        return [_err_packet(1243, "unknown statement id")]
    pieces, nparams, prev_types = entry
    try:
        params, types_used = _decode_params(pkt, nparams, prev_types)
    except (IndexError, struct.error):
        return [_err_packet(1210, "malformed execute packet")]
    entry[2] = types_used  # remembered for new_params_bound=0 rounds
    sql = "".join(
        p + (_literal(params[i]) if i < nparams else "")
        for i, p in enumerate(pieces)
    )
    wire_read_s = _time.perf_counter() - tr
    try:
        rs = sess.sql(sql)
    except Exception as e:
        return [_err_packet(
            getattr(e, "code", 1064), f"{type(e).__name__}: {e}")]
    # packet decode + literal substitution happened before the ledger
    # opened; attribute it now that the digest is known
    _fold_wire(sess, "wire read", wire_read_s)
    if not rs.names:
        return [_ok_packet(affected=rs.affected)]
    tw = _time.perf_counter()
    cols = [rs.columns[n] for n in rs.names]
    types = [_col_mysql_type(c) for c in cols]
    out = [_lenenc_int(len(rs.names))]
    for n, t in zip(rs.names, types):
        out.append(_coldef(n, t))
    out.append(_eof_packet())
    ncols = len(cols)
    nb = (ncols + 2 + 7) // 8
    for i in range(rs.nrows):
        bitmap = bytearray(nb)
        body = bytearray()
        for j, (c, t) in enumerate(zip(cols, types)):
            v = c[i]
            is_null = v is None or (
                isinstance(v, float) and v != v
            )
            if is_null:
                # binary-row NULL bitmap has a 2-bit offset
                bit = j + 2
                bitmap[bit // 8] |= 1 << (bit % 8)
                continue
            if t == MYSQL_TYPE_LONGLONG:
                body += int(v).to_bytes(8, "little", signed=True)
            elif t == MYSQL_TYPE_DOUBLE:
                body += struct.pack("<d", float(v))
            else:
                body += _lenenc_str(str(v).encode())
        out.append(b"\x00" + bytes(bitmap) + bytes(body))
    out.append(_eof_packet())
    _fold_wire(sess, "wire write", _time.perf_counter() - tw)
    return out


def stmt_reset_payload(pkt: bytes, stmts: dict) -> bytes:
    """COM_STMT_RESET: standard connectors send it between executes to
    drop accumulated long data / cursors. The rebuild holds neither —
    resetting forgets the remembered param types, so the next execute
    must send a fresh type block (new_params_bound=1, which compliant
    drivers do after a reset)."""
    if len(pkt) < 5:
        return _err_packet(1210, "malformed reset packet")
    entry = stmts.get(int.from_bytes(pkt[1:5], "little"))
    if entry is None:
        return _err_packet(1243, "unknown statement id")
    entry[2] = None
    return _ok_packet()


def build_greeting(salt: bytes, with_ssl: bool) -> bytes:
    """Protocol v10 greeting payload (the salt is the caller's: it must
    outlive the packet to verify the login scramble)."""
    caps = (
        CLIENT_PROTOCOL_41 | CLIENT_CONNECT_WITH_DB
        | CLIENT_SECURE_CONNECTION
    )
    if with_ssl:
        caps |= CLIENT_SSL
    return (
        b"\x0a" + b"5.7.0-oceanbase-tpu\x00"
        + (1).to_bytes(4, "little")
        + salt[:8] + b"\x00"
        + (caps & 0xFFFF).to_bytes(2, "little")
        + bytes([33])  # charset utf8
        + (0x0002).to_bytes(2, "little")
        + ((caps >> 16) & 0xFFFF).to_bytes(2, "little")
        + bytes([len(salt) + 1])
        + b"\x00" * 10
        + salt[8:] + b"\x00"
        + b"mysql_native_password\x00"
    )


def make_salt() -> bytes:
    import os

    return bytes(
        (b % 94) + 33 for b in os.urandom(20)  # printable, no NULs
    )


def is_ssl_request(login: bytes) -> bool:
    """SSLRequest = caps+maxpacket+charset+23 filler, no user name."""
    return len(login) < 36 and (
        len(login) >= 4
        and int.from_bytes(login[:4], "little") & CLIENT_SSL
    )


def check_login(db, users, login: bytes, salt: bytes) -> str | None:
    """Verified login user name, or None. With no explicit `users`
    map, accounts come from the database's privilege manager (root
    with empty password exists from bootstrap), so CREATE USER /
    GRANT govern the front door too."""
    if users is None:
        pm = getattr(db, "privileges", None)
        users = pm.authenticate_db() if pm is not None else None
    try:
        # HandshakeResponse41: caps u32, max packet u32, charset u8,
        # 23 reserved, user\0, lenenc auth response
        off = 4 + 4 + 1 + 23
        end = login.index(b"\x00", off)
        user = login[off:end].decode()
        off = end + 1
        alen = login[off]
        off += 1
        auth = login[off:off + alen]
    except (ValueError, IndexError):
        return None
    if users is None:
        return user or "root"  # open door (no privilege manager)
    if user not in users:
        return None
    # verify_native_password compares full SHA1 digests via
    # hmac.compare_digest — constant-time, stage2-only at rest.
    return user if verify_native_password(users[user], auth, salt) \
        else None


class MySqlFrontend:
    """TCP listener translating MySQL protocol to DbSessions.

    `users` maps user name -> password; None (default) keeps the open
    door for in-process tests. With users set, logins verify the
    mysql_native_password scramble against the salt."""

    def __init__(self, db: Database, host: str = "127.0.0.1", port: int = 0,
                 users: dict[str, str] | None = None,
                 ssl_context=None):
        self.db = db
        # An explicit `users` map arrives as plaintext (test/embedding
        # convenience) — reduce to stage-2 hashes immediately; the
        # frontend never holds plaintext credentials.
        if users is not None:
            from ..share.privilege import stage2_hash

            users = {u: stage2_hash(p) for u, p in users.items()}
        self.users = users
        # ssl.SSLContext (share/tls.server_context): advertise CLIENT_SSL
        # and upgrade the connection on an SSLRequest packet, per the
        # MySQL protocol's mid-handshake TLS negotiation
        self.ssl_context = ssl_context
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._serve(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # a serving front door gets bursts of hundreds of connects
            # (bench ramp-up, reconnect storms); the socketserver
            # default backlog of 5 drops SYNs into multi-second
            # retransmit limbo
            request_queue_size = 256

        self.server = Server((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )

    def start(self) -> "MySqlFrontend":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    # ---------------------------------------------------------- protocol
    def _serve(self, sock: socket.socket) -> None:
        # a resultset is several small packets, each its own send():
        # without NODELAY, Nagle + delayed ACK stall every multi-packet
        # response ~40ms (the asyncio front end gets NODELAY by default)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        conn = _Conn(sock)
        # id -> [pieces, nparams, last-bound param types] (drivers send
        # types only on the FIRST execute; new_params_bound=0 reuses them)
        stmts: dict[int, list] = {}
        next_stmt = [1]
        sess = None
        try:
            salt = make_salt()
            conn.send_packet(
                build_greeting(salt, self.ssl_context is not None))
            login = conn.read_packet()
            if self.ssl_context is not None and is_ssl_request(login):
                # SSLRequest (caps+maxpacket+charset+23 filler, no user):
                # upgrade the socket, then read the real login over TLS.
                # The packet sequence number continues across the upgrade.
                conn.sock = self.ssl_context.wrap_socket(
                    conn.sock, server_side=True
                )
                sock = conn.sock  # the finally-close must close the TLS fd
                login = conn.read_packet()
            user = check_login(self.db, self.users, login, salt)
            if user is None:
                conn.send_packet(
                    _err_packet(1045, "Access denied (bad credentials)"))
                return
            sess = self.db.session(user=user)
            conn.send_packet(_ok_packet())
            while True:
                conn.reset_seq()
                pkt = conn.read_packet()
                if not pkt:
                    return
                cmd = pkt[0]
                if cmd == 0x01:  # COM_QUIT
                    return
                if cmd in (0x0E, 0x02):  # COM_PING / COM_INIT_DB
                    conn.send_packet(_ok_packet())
                    continue
                if cmd == 0x03:  # COM_QUERY
                    for p in query_payloads(sess, pkt[1:].decode()):
                        conn.send_packet(p)
                    continue
                if cmd == 0x16:  # COM_STMT_PREPARE
                    for p in stmt_prepare_payloads(pkt[1:].decode(),
                                                   stmts, next_stmt):
                        conn.send_packet(p)
                    continue
                if cmd == 0x17:  # COM_STMT_EXECUTE
                    for p in stmt_execute_payloads(sess, pkt, stmts):
                        conn.send_packet(p)
                    continue
                if cmd == 0x19:  # COM_STMT_CLOSE (no response)
                    if len(pkt) >= 5:
                        stmts.pop(int.from_bytes(pkt[1:5], "little"), None)
                    continue
                if cmd == 0x1A:  # COM_STMT_RESET
                    conn.send_packet(stmt_reset_payload(pkt, stmts))
                    continue
                conn.send_packet(_err_packet(1047, "unsupported command"))
        except (ConnectionError, OSError):
            pass
        finally:
            # drop the engine session FIRST: rolls back an open tx and
            # flushes the workload-repo accumulator NOW (digest counts
            # reconcile on disconnect, not at some later GC)
            if sess is not None:
                try:
                    sess.close()
                except Exception:  # noqa: BLE001 — disconnect is best-effort
                    pass
            try:
                sock.close()
            except OSError:
                pass

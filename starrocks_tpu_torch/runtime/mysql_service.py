"""MySQL wire protocol front door.

Reference behavior: the FE's MySQL protocol server — the entry point for
every standard client, driver, and BI tool
(fe/fe-core/src/main/java/com/starrocks/mysql/MysqlServer.java:55,
mysql/nio/AcceptListener.java:57 accept loop, mysql/MysqlProto.java
handshake/auth negotiation, qe/ConnectProcessor.java:679 COM_* dispatch)
with result-set encoding per be/src/data_sink/result/mysql_result_writer.h:48.

Implemented subset (enough for the `mysql` CLI, Connector-family drivers and
pymysql to connect and query):
- protocol 10 initial handshake + HandshakeResponse41 with REAL
  mysql_native_password verification against the auth manager
  (runtime/auth.py; per-connection random salt, AuthSwitchRequest for
  clients that opened with another plugin; wrong password -> ERR 1045);
- command phase: COM_QUERY (text resultset), COM_PING, COM_INIT_DB,
  COM_QUIT, COM_FIELD_LIST (deprecated no-op);
- prepared statements: COM_STMT_PREPARE / EXECUTE / CLOSE / RESET with
  BINARY protocol result rows (qe/ConnectProcessor.java:563 analog);
  parameters substitute by lexer-located '?' markers, so string escaping
  is exact;
- Protocol::ColumnDefinition41 column metadata with engine->MySQL type
  mapping, lenenc text rows, EOF framing (CLIENT_DEPRECATE_EOF not
  advertised, so old and new clients both parse us);
- multi-statement off.

One serving tier per server (runtime/serving.py): each connection owns a
lightweight Session over the shared catalog/device-cache/store, and
statements execute through the tier's priority pool — concurrent
connections genuinely overlap. Warm repeats take the tier's inline fast
path. Privilege checks are per-user on the connection's own session.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading

from .. import types as T
from .session import Session

# --- capability flags (mysql_com.h) ------------------------------------------
CLIENT_LONG_PASSWORD = 0x0001
CLIENT_FOUND_ROWS = 0x0002
CLIENT_LONG_FLAG = 0x0004
CLIENT_CONNECT_WITH_DB = 0x0008
CLIENT_PROTOCOL_41 = 0x0200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x0008_0000

SERVER_CAPS = (
    CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
    | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH
)

CHARSET_UTF8MB4 = 45  # utf8mb4_general_ci
SERVER_STATUS_AUTOCOMMIT = 0x0002

# --- MySQL column types (binary protocol type codes) --------------------------
MYSQL_TYPE_TINY = 1
MYSQL_TYPE_LONG = 3
MYSQL_TYPE_DOUBLE = 5
MYSQL_TYPE_LONGLONG = 8
MYSQL_TYPE_DATE = 10
MYSQL_TYPE_DATETIME = 12
MYSQL_TYPE_VAR_STRING = 253
MYSQL_TYPE_NEWDECIMAL = 246


def _mysql_type(lt) -> int:
    k = lt.kind
    if k is T.TypeKind.BOOLEAN:
        return MYSQL_TYPE_TINY
    if k in (T.TypeKind.TINYINT, T.TypeKind.SMALLINT, T.TypeKind.INT):
        return MYSQL_TYPE_LONG
    if k is T.TypeKind.BIGINT:
        return MYSQL_TYPE_LONGLONG
    if k in (T.TypeKind.FLOAT, T.TypeKind.DOUBLE):
        return MYSQL_TYPE_DOUBLE
    if k is T.TypeKind.DECIMAL:
        return MYSQL_TYPE_NEWDECIMAL
    if k is T.TypeKind.DATE:
        return MYSQL_TYPE_DATE
    if k is T.TypeKind.DATETIME:
        return MYSQL_TYPE_DATETIME
    return MYSQL_TYPE_VAR_STRING


# --- wire primitives ----------------------------------------------------------


def lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


class _Conn:
    """One client connection: packet framing + protocol state."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    # packet = 3-byte little-endian length, 1-byte sequence id, payload
    def read_packet(self) -> bytes:
        head = self._read_n(4)
        if head is None:
            return None
        (ln,) = struct.unpack("<I", head[:3] + b"\x00")
        self.seq = (head[3] + 1) & 0xFF
        return self._read_n(ln)

    def _read_n(self, n: int):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def send_packet(self, payload: bytes):
        # 16MB+ payloads would need continuation packets; result rows are
        # emitted one packet per row so only a single enormous cell hits this
        assert len(payload) < 0xFFFFFF, "oversized packet"
        self.sock.sendall(
            struct.pack("<I", len(payload))[:3] + bytes([self.seq]) + payload
        )
        self.seq = (self.seq + 1) & 0xFF

    # --- composite packets ---
    def send_handshake(self, thread_id: int, salt: bytes):
        self.seq = 0
        p = (
            b"\x0a"  # protocol version 10
            + b"8.0.33-starrocks-tpu\x00"
            + struct.pack("<I", thread_id)
            + salt[:8] + b"\x00"
            + struct.pack("<H", SERVER_CAPS & 0xFFFF)
            + bytes([CHARSET_UTF8MB4])
            + struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
            + struct.pack("<H", SERVER_CAPS >> 16)
            + bytes([21])  # auth plugin data length
            + b"\x00" * 10
            + salt[8:] + b"\x00"
            + b"mysql_native_password\x00"
        )
        self.send_packet(p)

    def send_ok(self, affected: int = 0, info: bytes = b""):
        self.send_packet(
            b"\x00" + lenenc_int(affected) + lenenc_int(0)
            + struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
            + struct.pack("<H", 0) + info
        )

    def send_eof(self):
        self.send_packet(
            b"\xfe" + struct.pack("<H", 0)
            + struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
        )

    def send_err(self, code: int, msg: str, sqlstate: bytes = b"HY000"):
        self.send_packet(
            b"\xff" + struct.pack("<H", code) + b"#" + sqlstate
            + msg.encode("utf-8", "replace")[:1000]
        )

    def send_column_def(self, name: str, lt):
        p = (
            lenenc_str(b"def")                    # catalog
            + lenenc_str(b"")                     # schema
            + lenenc_str(b"")                     # table
            + lenenc_str(b"")                     # org_table
            + lenenc_str(name.encode())           # name
            + lenenc_str(name.encode())           # org_name
            + lenenc_int(0x0C)                    # fixed-length fields
            + struct.pack("<H", CHARSET_UTF8MB4)
            + struct.pack("<I", 255)              # column_length
            + bytes([_mysql_type(lt)])
            + struct.pack("<H", 0)                # flags
            + bytes([31])                         # decimals
            + b"\x00\x00"
        )
        self.send_packet(p)


def _cell(v) -> bytes:
    if v is None:
        return b"\xfb"
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, float):
        s = repr(v)
    else:
        s = str(v)
    return lenenc_str(s.encode("utf-8", "replace"))


class MySQLServer:
    """Threaded MySQL-protocol server over a serving tier: every
    connection gets its own lightweight Session (shared catalog / device
    cache / store), and statements dispatch through the tier's priority
    executor pool — independent queries from different connections
    genuinely overlap (runtime/serving.py). KILL / SHOW PROCESSLIST
    bypass the tier by design (the victim may hold its gate)."""

    def __init__(self, session: Session, host="127.0.0.1", port=9030,
                 tier=None):
        from .serving import ServingTier

        self.session = session  # the tier's template (replayed the store)
        self.tier = tier or ServingTier(session)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._serve(self.request)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            # a dashboard fleet connects in bursts; the stdlib default
            # backlog of 5 drops simultaneous connects on the floor
            request_queue_size = 128

        self.server = Server((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread_ids = iter(range(1, 1 << 30))

    def start(self):
        t = threading.Thread(target=self.server.serve_forever, daemon=True)
        t.start()
        return self

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        self.tier.shutdown()

    # --- connection lifecycle -------------------------------------------------
    def _authenticate(self, conn: _Conn, salt: bytes):
        """Parse HandshakeResponse41 and verify mysql_native_password.
        Returns the authenticated user name or None (ERR already sent)."""
        resp = conn.read_packet()
        if resp is None or len(resp) < 32:
            return None
        caps = struct.unpack_from("<I", resp, 0)[0]
        pos = 4 + 4 + 1 + 23  # caps, max packet, charset, filler
        end = resp.index(b"\x00", pos)
        user = resp[pos:end].decode("utf-8", "replace")
        pos = end + 1
        if caps & 0x0020_0000:  # CLIENT_PLUGIN_AUTH_LENENC_CLIENT_DATA
            n = resp[pos]
            pos += 1
            token = resp[pos:pos + n]
            pos += n
        elif caps & CLIENT_SECURE_CONNECTION:
            n = resp[pos]
            pos += 1
            token = resp[pos:pos + n]
            pos += n
        else:  # NUL-terminated
            end = resp.index(b"\x00", pos)
            token = resp[pos:end]
            pos = end + 1
        plugin = None
        if caps & CLIENT_CONNECT_WITH_DB and b"\x00" in resp[pos:]:
            pos = resp.index(b"\x00", pos) + 1  # skip database name
        if caps & CLIENT_PLUGIN_AUTH and b"\x00" in resp[pos:]:
            end = resp.index(b"\x00", pos)
            plugin = resp[pos:end].decode("ascii", "replace")
        if plugin is not None and plugin != "mysql_native_password":
            # AuthSwitchRequest: the client re-scrambles with our plugin
            conn.send_packet(b"\xfe" + b"mysql_native_password\x00"
                             + salt + b"\x00")
            token = conn.read_packet()
            if token is None:
                return None
        auth = self.session.auth()
        if not auth.verify(user, salt, bytes(token)):
            conn.send_err(
                1045, f"Access denied for user '{user}'", b"28000")
            return None
        conn.send_ok()
        return user

    def _serve(self, sock: socket.socket):
        from .auth import AuthManager

        conn = _Conn(sock)
        salt = AuthManager.new_salt()
        conn.send_handshake(next(self._thread_ids), salt)
        user = self._authenticate(conn, salt)
        if user is None:
            return
        # per-connection session over the tier's shared catalog/cache:
        # session state (user, resource group) is private to this client
        sess = self.tier.new_session(user)
        stmts: dict = {}  # stmt_id -> (sql_text, param_positions)
        stmt_ids = iter(range(1, 1 << 30))
        while True:
            conn.seq = 0
            pkt = conn.read_packet()
            if pkt is None or not pkt:
                return
            conn.seq = 1
            cmd, arg = pkt[0], pkt[1:]
            if cmd == 0x01:  # COM_QUIT
                return
            if cmd == 0x0E:  # COM_PING
                conn.send_ok()
                continue
            if cmd == 0x02:  # COM_INIT_DB
                conn.send_ok()
                continue
            if cmd == 0x04:  # COM_FIELD_LIST (deprecated): empty list
                conn.send_eof()
                continue
            if cmd == 0x03:  # COM_QUERY
                self._query(conn, arg.decode("utf-8", "replace"), sess)
                continue
            if cmd == 0x16:  # COM_STMT_PREPARE
                self._stmt_prepare(conn, arg.decode("utf-8", "replace"),
                                   stmts, stmt_ids)
                continue
            if cmd == 0x17:  # COM_STMT_EXECUTE
                self._stmt_execute(conn, arg, stmts, sess)
                continue
            if cmd == 0x19:  # COM_STMT_CLOSE (no response)
                if len(arg) >= 4:
                    stmts.pop(struct.unpack_from("<I", arg, 0)[0], None)
                continue
            if cmd == 0x1A:  # COM_STMT_RESET
                conn.send_ok()
                continue
            conn.send_err(1295, f"command {cmd:#x} not supported")

    def _run_as(self, sql: str, sess):
        return self.tier.execute(sess, sql)

    def _kill_bypass(self, conn: _Conn, sql: str, user: str) -> bool:
        """KILL QUERY / SHOW PROCESSLIST handled WITHOUT the session lock:
        the lock serializes queries, so a kill routed through it would
        queue behind the very query it targets. The registry and auth
        manager are thread-safe; nothing here touches session state.
        Returns True when the statement was handled."""
        from ..sql import ast as _ast
        from ..sql.parser import parse as _parse
        from .lifecycle import REGISTRY

        try:
            stmt = _parse(sql)
        except Exception:  # noqa: BLE001  # lint: swallow-ok — not a
            return False   # kill/processlist statement: normal path parses
        if isinstance(stmt, _ast.KillQuery):
            try:
                ok = REGISTRY.cancel(
                    stmt.query_id, requester=user,
                    admin=self.session.auth().is_admin(user))
            except PermissionError as e:
                conn.send_err(1142, str(e), b"42000")
                return True
            conn.send_ok(info=(
                b"cancel delivered" if ok else b"query not running; "
                b"KILL is a no-op"))
            return True
        if isinstance(stmt, _ast.ShowProcesslist):
            rows = REGISTRY.snapshot()
            names = ("Id", "User", "State", "Time_ms", "Group",
                     "Mem_bytes", "Stage", "Info")
            types = (T.BIGINT, T.VARCHAR, T.VARCHAR, T.BIGINT, T.VARCHAR,
                     T.BIGINT, T.VARCHAR, T.VARCHAR)
            conn.send_packet(lenenc_int(len(names)))
            for n, t in zip(names, types):
                conn.send_column_def(n, t)
            conn.send_eof()
            for r in rows:
                conn.send_packet(b"".join(_cell(v) for v in r))
            conn.send_eof()
            return True
        return False

    def _query(self, conn: _Conn, sql: str, sess):
        from .failpoint import fail_point

        sql = sql.strip().rstrip(";")
        fail_point("mysql::query")
        low = sql.lower()
        if low.startswith(("kill", "show")) and self._kill_bypass(
                conn, sql, sess.current_user):
            return
        # connector session boilerplate: accept silently
        if low.startswith(("set ", "commit", "rollback", "start transaction",
                           "use ")) and not low.startswith("set global"):
            try:
                self._run_as(sql, sess)
            except Exception:  # lint: swallow-ok — connector boilerplate
                pass  # unknown session vars from connectors are non-fatal
            conn.send_ok()
            return
        try:
            res = self._run_as(sql, sess)
        except PermissionError as e:
            conn.send_err(1142, str(e), b"42000")
            return
        except Exception as e:  # noqa: BLE001  # lint: swallow-ok — every engine error -> ERR
            conn.send_err(1064, f"{type(e).__name__}: {e}", b"42000")
            return
        if res is None:
            conn.send_ok()
            return
        if isinstance(res, (str, int, list)):
            if not low.startswith(("explain", "show", "desc")):
                # DML/DDL status strings -> OK packet (MySQL semantics),
                # status text rides in the info field
                conn.send_ok(info=str(res).encode("utf-8", "replace"))
                return
            # EXPLAIN/SHOW text -> one-column resultset; multi-line text
            # (EXPLAIN ANALYZE / SHOW PROFILE trees) renders one row per
            # line so wire clients show the tree, not one folded cell
            if isinstance(res, list):
                rows = [(str(r),) for r in res]
            elif isinstance(res, str) and "\n" in res:
                rows = [(line,) for line in res.split("\n")]
            else:
                rows = [(str(res),)]
            conn.send_packet(lenenc_int(1))
            conn.send_column_def("result", T.VARCHAR)
            conn.send_eof()
            for r in rows:
                conn.send_packet(b"".join(_cell(v) for v in r))
            conn.send_eof()
            return
        table = res.table
        fields = list(table.schema)
        conn.send_packet(lenenc_int(len(fields)))
        for f in fields:
            conn.send_column_def(f.name, f.type)
        conn.send_eof()
        for row in table.to_pylist():
            conn.send_packet(b"".join(_cell(v) for v in row))
        conn.send_eof()


    # --- prepared statements --------------------------------------------------
    def _stmt_prepare(self, conn: _Conn, sql: str, stmts: dict, stmt_ids):
        from ..sql.lexer import tokenize

        try:
            marks = [t.pos for t in tokenize(sql)
                     if t.kind == "op" and t.value == "?"]
        except Exception as e:  # noqa: BLE001  # lint: swallow-ok — ERR packet
            conn.send_err(1064, f"{type(e).__name__}: {e}", b"42000")
            return
        sid = next(stmt_ids)
        stmts[sid] = [sql, marks, None]  # [text, positions, cached types]
        # COM_STMT_PREPARE_OK: columns=0 (sent at execute — planning is
        # deferred), params as counted
        conn.send_packet(
            b"\x00" + struct.pack("<I", sid) + struct.pack("<H", 0)
            + struct.pack("<H", len(marks)) + b"\x00"
            + struct.pack("<H", 0))
        for _ in marks:  # parameter definitions (untyped placeholders)
            conn.send_column_def("?", T.VARCHAR)
        if marks:
            conn.send_eof()

    def _stmt_execute(self, conn: _Conn, arg: bytes, stmts: dict, sess):
        if len(arg) < 9:
            conn.send_err(1064, "malformed COM_STMT_EXECUTE")
            return
        sid = struct.unpack_from("<I", arg, 0)[0]
        entry = stmts.get(sid)
        if entry is None:
            conn.send_err(1243, f"unknown prepared statement {sid}")
            return
        sql, marks, cached_types = entry
        pos = 9  # stmt_id(4) flags(1) iteration_count(4)
        try:
            params, types = self._decode_params(
                arg, pos, len(marks), cached_types)
            entry[2] = types  # drivers send types only on the first execute
        except Exception as e:  # noqa: BLE001  # lint: swallow-ok — ERR packet
            conn.send_err(1064, f"bad parameter block: {e}")
            return
        final = self._splice(sql, marks, params)
        try:
            res = self._run_as(final, sess)
        except PermissionError as e:
            conn.send_err(1142, str(e), b"42000")
            return
        except Exception as e:  # noqa: BLE001  # lint: swallow-ok — ERR packet
            conn.send_err(1064, f"{type(e).__name__}: {e}", b"42000")
            return
        if res is None or isinstance(res, (str, int, list)):
            conn.send_ok(info=b"" if res is None else str(res).encode())
            return
        table = res.table
        fields = list(table.schema)
        conn.send_packet(lenenc_int(len(fields)))
        for f in fields:
            conn.send_column_def(f.name, f.type)
        conn.send_eof()
        for row in table.to_pylist():
            conn.send_packet(_binary_row(row, fields))
        conn.send_eof()

    @staticmethod
    def _decode_params(arg: bytes, pos: int, nparams: int, cached_types):
        """Binary parameter block -> (values, types). Types arrive only with
        new_params_bound_flag=1 (the first execute); later executes reuse
        the statement's cached types per the protocol."""
        if nparams == 0:
            return [], None
        nul_len = (nparams + 7) // 8
        nulmap = arg[pos:pos + nul_len]
        pos += nul_len
        bound = arg[pos]
        pos += 1
        if bound:
            types = [arg[pos + 2 * i] for i in range(nparams)]
            pos += 2 * nparams
        elif cached_types is not None:
            types = cached_types
        else:
            raise ValueError("no parameter types bound")
        out = []
        for i, t in enumerate(types):
            if nulmap[i // 8] & (1 << (i % 8)):
                out.append(None)
                continue
            if t == MYSQL_TYPE_LONGLONG:
                out.append(struct.unpack_from("<q", arg, pos)[0])
                pos += 8
            elif t == MYSQL_TYPE_LONG:
                out.append(struct.unpack_from("<i", arg, pos)[0])
                pos += 4
            elif t == 2:  # SHORT
                out.append(struct.unpack_from("<h", arg, pos)[0])
                pos += 2
            elif t == MYSQL_TYPE_TINY:
                out.append(struct.unpack_from("<b", arg, pos)[0])
                pos += 1
            elif t == MYSQL_TYPE_DOUBLE:
                out.append(struct.unpack_from("<d", arg, pos)[0])
                pos += 8
            elif t == 4:  # FLOAT
                out.append(struct.unpack_from("<f", arg, pos)[0])
                pos += 4
            elif t in (MYSQL_TYPE_DATE, MYSQL_TYPE_DATETIME, 7):
                # length-prefixed y/m/d[/h/m/s[/us]]; length 0 = zero date
                n = arg[pos]
                pos += 1
                if n == 0:
                    out.append("0000-00-00")
                    continue
                y = struct.unpack_from("<H", arg, pos)[0]
                mo, d = arg[pos + 2], arg[pos + 3]
                s = f"{y:04d}-{mo:02d}-{d:02d}"
                if n >= 7:
                    s += (f" {arg[pos + 4]:02d}:{arg[pos + 5]:02d}"
                          f":{arg[pos + 6]:02d}")
                out.append(s)
                pos += n
            elif t == 11:  # TIME: length-prefixed sign/days/h/m/s[/us]
                n = arg[pos]
                pos += 1
                if n == 0:
                    out.append("00:00:00")
                    continue
                hh = arg[pos + 5] + 24 * struct.unpack_from(
                    "<I", arg, pos + 1)[0]
                out.append(f"{hh:02d}:{arg[pos + 6]:02d}:{arg[pos + 7]:02d}")
                pos += n
            else:  # VAR_STRING / STRING / BLOB / DECIMAL...: lenenc bytes
                n = arg[pos]
                pos += 1
                if n == 0xFC:
                    n = struct.unpack_from("<H", arg, pos)[0]
                    pos += 2
                elif n == 0xFD:
                    n = struct.unpack(
                        "<I", arg[pos:pos + 3] + b"\x00")[0]
                    pos += 3
                out.append(arg[pos:pos + n].decode("utf-8", "replace"))
                pos += n
        return out, types

    @staticmethod
    def _splice(sql: str, marks, params) -> str:
        """Substitute literals at the lexer-located '?' positions (exact:
        markers inside strings/comments were never tokenized as ops)."""
        out, last = [], 0
        for mpos, v in zip(marks, params):
            out.append(sql[last:mpos])
            if v is None:
                out.append("NULL")
            elif isinstance(v, (int, float)):
                out.append(repr(v))
            else:
                out.append("'" + str(v).replace("'", "''") + "'")
            last = mpos + 1
        out.append(sql[last:])
        return "".join(out)


def _binary_row(row, fields) -> bytes:
    """Binary-protocol resultset row (used for prepared statements)."""
    n = len(fields)
    nulmap = bytearray((n + 7 + 2) // 8)
    vals = []
    for i, (v, f) in enumerate(zip(row, fields)):
        if v is None:
            nulmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
            continue
        k = f.type.kind
        if k is T.TypeKind.BOOLEAN:
            vals.append(struct.pack("<b", int(v)))
        elif k in (T.TypeKind.TINYINT, T.TypeKind.SMALLINT, T.TypeKind.INT):
            vals.append(struct.pack("<i", int(v)))
        elif k is T.TypeKind.BIGINT:
            vals.append(struct.pack("<q", int(v)))
        elif k in (T.TypeKind.FLOAT, T.TypeKind.DOUBLE):
            vals.append(struct.pack("<d", float(v)))
        elif k is T.TypeKind.DATE:
            y, m, d = str(v)[:10].split("-")
            vals.append(bytes([4]) + struct.pack("<H", int(y))
                        + bytes([int(m), int(d)]))
        elif k is T.TypeKind.DATETIME:
            s = str(v).replace("T", " ")
            y, m, d = s[:10].split("-")
            hh, mm, ss = (s[11:19] or "00:00:00").split(":")
            vals.append(bytes([7]) + struct.pack("<H", int(y))
                        + bytes([int(m), int(d), int(hh), int(mm),
                                 int(float(ss))]))
        else:  # DECIMAL/VARCHAR/sketches: lenenc string form
            s = repr(v) if isinstance(v, float) else str(v)
            b = s.encode("utf-8", "replace") if not isinstance(v, bytes) \
                else v
            vals.append(lenenc_str(b))
    return b"\x00" + bytes(nulmap) + b"".join(vals)


def serve_mysql(catalog, host="127.0.0.1", port=9030) -> MySQLServer:
    """Start a MySQL-protocol server over a fresh session on `catalog`."""
    return MySQLServer(Session(catalog), host, port).start()

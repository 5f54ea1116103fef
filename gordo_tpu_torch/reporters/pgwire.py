"""
A minimal client of PostgreSQL's frontend/backend protocol (version 3.0)
over a plain socket, for the Postgres reporter: the card's machine has no
``psycopg2``.

- the StartupMessage (``user``, ``database``, ``client_encoding`` UTF8);
- authentication: trust, cleartext password, MD5, and SCRAM-SHA-256
  (RFC 5802 with RFC 7677's hash; no channel binding, so ``n,,``). Once
  a SCRAM exchange has begun, ``AuthenticationOk`` is refused until the
  server's final signature has come and matched, as libpq does;
- ``ErrorResponse`` decoded into :class:`PgError` (severity, SQLSTATE,
  message, detail);
- the extended query protocol: ``Parse``, ``Bind``, ``Execute`` and
  ``Sync`` a statement, the parameters bound as text (``None`` as SQL
  NULL) and never spliced into the SQL, the rows read back as text.

No TLS, no COPY, no notifications; one statement at a time, each its own
transaction (the ``Sync`` commits it).
"""

import base64
import hashlib
import hmac
import secrets
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

PROTOCOL = 196608  # 3.0
SCRAM = "SCRAM-SHA-256"
_FIELDS = {"S": "severity", "V": "severity", "C": "code", "M": "message", "D": "detail", "H": "hint"}

Row = Tuple[Optional[str], ...]


class PgError(Exception):
    """A failure the server reported (``ErrorResponse``), or one of the
    protocol: the connection closed, an unknown authentication request, a
    server signature that does not match."""

    def __init__(self, message: str, fields: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.fields = fields or {}


def error_fields(body: bytes) -> Dict[str, str]:
    """An ``ErrorResponse`` (or ``NoticeResponse``) body's fields by name:
    ``severity``, ``code``, ``message``, ``detail``, ``hint``, and the
    others by their code letter."""
    fields: Dict[str, str] = {}
    for part in body.split(b"\0"):
        if part:
            code, value = chr(part[0]), part[1:].decode("utf-8", "replace")
            fields[_FIELDS.get(code, code)] = value
    return fields


def _error(body: bytes) -> PgError:
    fields = error_fields(body)
    return PgError(f"{fields.get('severity', 'ERROR')} {fields.get('code', '?')}: {fields.get('message', '')}",
                   fields)


def cstring(text: str) -> bytes:
    return text.encode("utf-8") + b"\0"


def message(kind: bytes, body: bytes) -> bytes:
    """A typed protocol message: its kind byte, then its length (itself
    included) and body."""
    return kind + struct.pack("!i", len(body) + 4) + body


# -- SCRAM-SHA-256 ---------------------------------------------------------------------


def _saslname(user: str) -> str:
    return user.replace("=", "=3D").replace(",", "=2C")


def scram_client_first(user: str, nonce: str) -> str:
    """The client-first-message-bare (RFC 5802 §7). Postgres reads the
    user from the StartupMessage and ignores this one."""
    return f"n={_saslname(user)},r={nonce}"


def scram_client_final(password: str, client_first_bare: str, server_first: str,
                       client_nonce: str) -> Tuple[str, str]:
    """``(client-final-message, the server signature it must prove)`` for
    a server-first-message; ``PgError`` when the server's nonce does not
    extend the client's."""
    attrs = dict(part.split("=", 1) for part in server_first.split(","))
    nonce, salt, iterations = attrs["r"], base64.b64decode(attrs["s"]), int(attrs["i"])
    if not nonce.startswith(client_nonce) or len(nonce) == len(client_nonce):
        raise PgError("SCRAM: the server's nonce does not extend the client's")
    salted = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt, iterations)
    client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
    stored_key = hashlib.sha256(client_key).digest()
    without_proof = f"c={base64.b64encode(b'n,,').decode()},r={nonce}"
    auth_message = f"{client_first_bare},{server_first},{without_proof}".encode("utf-8")
    client_signature = hmac.new(stored_key, auth_message, hashlib.sha256).digest()
    proof = bytes(a ^ b for a, b in zip(client_key, client_signature))
    server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    server_signature = hmac.new(server_key, auth_message, hashlib.sha256).digest()
    return (f"{without_proof},p={base64.b64encode(proof).decode()}",
            base64.b64encode(server_signature).decode())


def md5_password(user: str, password: str, salt: bytes) -> str:
    """The ``PasswordMessage`` of MD5 authentication:
    ``md5`` + md5(md5(password + user) + salt)."""
    inner = hashlib.md5((password + user).encode("utf-8")).hexdigest()
    return "md5" + hashlib.md5(inner.encode("ascii") + salt).hexdigest()


def _parameter(value: Any) -> bytes:
    """A bound parameter: its length and text, or -1 for NULL."""
    if value is None:
        return struct.pack("!i", -1)
    text = str(value).encode("utf-8")
    return struct.pack("!i", len(text)) + text


# -- the connection --------------------------------------------------------------------


class Connection:
    """One authenticated session; :meth:`execute` a statement at a time."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.parameters: Dict[str, str] = {}
        self._buffer = b""

    def _recv(self, n: int) -> bytes:
        while len(self._buffer) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise PgError("the server closed the connection")
            self._buffer += chunk
        data, self._buffer = self._buffer[:n], self._buffer[n:]
        return data

    def read(self) -> Tuple[bytes, bytes]:
        """The next backend message: ``(kind, body)``."""
        kind, length = struct.unpack("!ci", self._recv(5))
        return kind, self._recv(length - 4)

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def authenticate(self, user: str, password: str, database: str, nonce: Optional[str] = None) -> None:
        """Start the session and answer the server's authentication
        requests until it is ready for a query."""
        body = struct.pack("!i", PROTOCOL) + b"".join(
            cstring(k) + cstring(v) for k, v in (("user", user), ("database", database),
                                                  ("client_encoding", "UTF8"))) + b"\0"
        self.send(struct.pack("!i", len(body) + 4) + body)
        # a SCRAM exchange: its stage ("first", "final", then "verified") and what that stage answers with
        stage: Optional[str] = None
        scram: Tuple[str, str] = ("", "")  # (client-first-bare, client nonce), then (the server signature, "")
        while True:
            kind, body = self.read()
            if kind == b"E":
                raise _error(body)
            if kind == b"Z":
                return
            if kind == b"S":
                key, value = body.rstrip(b"\0").split(b"\0", 1)
                self.parameters[key.decode()] = value.decode()
                continue
            if kind != b"R":  # BackendKeyData, NoticeResponse
                continue
            (code,) = struct.unpack("!i", body[:4])
            if code == 0:
                if stage not in (None, "verified"):
                    raise PgError("SCRAM: the server ended authentication without proving its signature")
                continue
            if code == 3:
                self.send(message(b"p", cstring(password)))
            elif code == 5:
                self.send(message(b"p", cstring(md5_password(user, password, body[4:8]))))
            elif code == 10:
                mechanisms = [m.decode() for m in body[4:].split(b"\0") if m]
                if SCRAM not in mechanisms:
                    raise PgError(f"the server offers {mechanisms}, not {SCRAM}")
                client_nonce = nonce or base64.b64encode(secrets.token_bytes(18)).decode()
                bare = scram_client_first(user, client_nonce)
                first = ("n,," + bare).encode("utf-8")
                self.send(message(b"p", cstring(SCRAM) + struct.pack("!i", len(first)) + first))
                stage, scram = "first", (bare, client_nonce)
            elif code == 11 and stage == "first":
                final, signature = scram_client_final(password, scram[0], body[4:].decode("utf-8"), scram[1])
                self.send(message(b"p", final.encode("utf-8")))
                stage, scram = "final", (signature, "")
            elif code == 12 and stage == "final":
                attrs = dict(part.split("=", 1) for part in body[4:].decode("utf-8").split(","))
                if not hmac.compare_digest(attrs.get("v", ""), scram[0]):
                    raise PgError("SCRAM: the server's signature does not match")
                stage = "verified"
            else:
                raise PgError(f"authentication request {code} is not supported")

    def execute(self, sql: str, params: Sequence[Any] = ()) -> List[Row]:
        """Run one statement with its parameters bound as text
        (``$1``, ``$2``, ...); the rows it returns, each value text or
        ``None``. An ``ErrorResponse`` raises :class:`PgError` once the
        server is ready again."""
        values = b"".join(_parameter(p) for p in params)
        self.send(
            message(b"P", cstring("") + cstring(sql) + struct.pack("!h", 0))
            + message(b"B", cstring("") + cstring("") + struct.pack("!hh", 0, len(params)) + values
                      + struct.pack("!h", 0))
            + message(b"E", cstring("") + struct.pack("!i", 0))
            + message(b"S", b"")
        )
        rows: List[Row] = []
        failure: Optional[PgError] = None
        while True:
            kind, body = self.read()
            if kind == b"Z":
                if failure is not None:
                    raise failure
                return rows
            if kind == b"E":
                failure = _error(body)
            elif kind == b"D":
                (count,) = struct.unpack("!h", body[:2])
                pos, row = 2, []
                for _ in range(count):
                    (size,) = struct.unpack("!i", body[pos:pos + 4])
                    pos += 4
                    row.append(None if size < 0 else body[pos:pos + size].decode("utf-8"))
                    pos += max(size, 0)
                rows.append(tuple(row))

    def close(self) -> None:
        try:
            self.send(message(b"X", b""))
        except OSError:
            pass
        self.sock.close()


def connect(host: str, port: int = 5432, user: str = "postgres", password: str = "postgres",
            database: str = "postgres", timeout: float = 30.0, nonce: Optional[str] = None) -> Connection:
    """An authenticated :class:`Connection` to ``host:port``; ``OSError``
    when the host cannot be reached, :class:`PgError` when the server
    refuses."""
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    connection = Connection(sock)
    try:
        connection.authenticate(user, password, database, nonce)
    except BaseException:
        sock.close()
        raise
    return connection

"""
A stand-in for a Postgres server on a local port, for the reporters'
tests and ``chip_smoke.py``: the protocol's startup, each authentication
the ``pgwire`` client speaks, and the extended query flow over the one
``machine`` table that :class:`~gordo_tpu_torch.reporters.PostgresReporter`
writes. It is no database: any other statement answers an ``ErrorResponse``.
"""

import base64
import hashlib
import hmac
import json
import os
import socket
import struct
import threading


class PostgresStub:
    """A local stand-in for a Postgres server: the protocol's startup, an
    authentication (``trust``, ``password``, ``md5`` or ``scram``: SCRAM-
    SHA-256 with ``salt``, ``iterations`` and the server nonce given or
    drawn), then the extended query flow over a ``machine`` table held in
    ``rows`` (``CREATE TABLE``, the reporter's upsert, its ``SELECT``);
    JSON parameters are parsed as a ``jsonb`` column would, and any other
    statement answers an ``ErrorResponse``. ``statements`` records each
    statement's text and parameters, ``refused`` each failed login,
    ``scram`` each SCRAM exchange's messages. ``refuse = True`` fails every
    password; ``sasl_final = False`` ends a SCRAM exchange with
    ``AuthenticationOk`` and no server signature, as a server that cannot
    prove it knows the password would."""

    def __init__(self, auth="scram", user="postgres", password="postgres", salt=b"stub-salt-16byte",
                 iterations=4096, server_nonce=None):
        self.auth, self.user, self.password = auth, user, password
        self.salt, self.iterations, self.server_nonce = salt, iterations, server_nonce
        self.refuse, self.sasl_final = False, True
        self.rows, self.statements, self.refused, self.scram = {}, [], [], []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._accept, daemon=True)
        self.thread.start()

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the accept
        except OSError:
            pass
        self.sock.close()
        self.thread.join(timeout=5)

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._session, args=(conn,), daemon=True).start()

    @staticmethod
    def _read(conn, n):
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                raise ConnectionError("the client closed the connection")
            data += chunk
        return data

    def _message(self, conn):
        kind = self._read(conn, 1)
        (length,) = struct.unpack("!i", self._read(conn, 4))
        return kind, self._read(conn, length - 4)

    @staticmethod
    def _send(conn, kind, body=b""):
        conn.sendall(kind + struct.pack("!i", len(body) + 4) + body)

    def _error(self, conn, code, text, severity="ERROR"):
        self._send(conn, b"E", b"S" + severity.encode() + b"\0V" + severity.encode() + b"\0C" + code.encode()
                   + b"\0M" + text.encode() + b"\0\0")

    def _session(self, conn):
        try:
            (length,) = struct.unpack("!i", self._read(conn, 4))
            body = self._read(conn, length - 4)
            parts = body[4:].split(b"\0")
            startup = dict(zip((p.decode() for p in parts[0::2]), (p.decode() for p in parts[1::2])))
            if not self._authenticate(conn, startup.get("user")):
                return
            self._send(conn, b"S", b"server_version\x0014.0 (stub)\0")
            self._send(conn, b"K", struct.pack("!ii", 1, 2))
            self._send(conn, b"Z", b"I")
            self._queries(conn)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _authenticate(self, conn, user):
        if self.auth == "trust":
            self._send(conn, b"R", struct.pack("!i", 0))
            return True
        ok = False
        if self.auth == "password":
            self._send(conn, b"R", struct.pack("!i", 3))
            ok = self._message(conn)[1].rstrip(b"\0").decode() == self.password
        elif self.auth == "md5":
            salt = os.urandom(4)
            self._send(conn, b"R", struct.pack("!i", 5) + salt)
            inner = hashlib.md5((self.password + user).encode()).hexdigest()
            expected = "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
            ok = self._message(conn)[1].rstrip(b"\0").decode() == expected
        else:
            ok = self._scram(conn)
            if ok is None:
                return False
        if ok and not self.refuse and user == self.user:
            self._send(conn, b"R", struct.pack("!i", 0))
            return True
        self.refused.append(user)
        self._error(conn, "28P01", f'password authentication failed for user "{user}"', "FATAL")
        return False

    def _scram(self, conn):
        """SCRAM-SHA-256 as the server computes it (RFC 5802): the client's
        proof checked against the stored key of ``password``; ``None`` when
        the exchange itself breaks."""
        self._send(conn, b"R", struct.pack("!i", 10) + b"SCRAM-SHA-256\0\0")
        body = self._message(conn)[1]
        mechanism, rest = body.split(b"\0", 1)
        first = rest[4:4 + struct.unpack("!i", rest[:4])[0]].decode()
        if mechanism != b"SCRAM-SHA-256" or not first.startswith("n,,"):
            self._error(conn, "28000", "unsupported SASL exchange", "FATAL")
            return None
        bare = first[3:]
        client_nonce = dict(p.split("=", 1) for p in bare.split(","))["r"]
        nonce = client_nonce + (self.server_nonce or base64.b64encode(os.urandom(18)).decode())
        server_first = f"r={nonce},s={base64.b64encode(self.salt).decode()},i={self.iterations}"
        self._send(conn, b"R", struct.pack("!i", 11) + server_first.encode())
        final = self._message(conn)[1].decode()
        without_proof, _, proof = final.rpartition(",p=")
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(), self.salt, self.iterations)
        stored_key = hashlib.sha256(hmac.new(salted, b"Client Key", hashlib.sha256).digest()).digest()
        auth_message = f"{bare},{server_first},{without_proof}".encode()
        signature = hmac.new(stored_key, auth_message, hashlib.sha256).digest()
        client_key = bytes(a ^ b for a, b in zip(base64.b64decode(proof), signature))
        server_signature = hmac.new(hmac.new(salted, b"Server Key", hashlib.sha256).digest(), auth_message,
                                    hashlib.sha256).digest()
        server_final = f"v={base64.b64encode(server_signature).decode()}"
        self.scram.append((first, server_first, final, server_final))
        ok = without_proof == f"c=biws,r={nonce}" and hashlib.sha256(client_key).digest() == stored_key
        if ok and not self.refuse and self.sasl_final:
            self._send(conn, b"R", struct.pack("!i", 12) + server_final.encode())
        return ok

    def _queries(self, conn):
        statement, params, failed = None, [], False
        while True:
            kind, body = self._message(conn)
            if kind == b"X":
                return
            if kind == b"S":
                self._send(conn, b"Z", b"I")
                statement, params, failed = None, [], False
            elif failed:
                continue
            elif kind == b"P":
                statement = body.split(b"\0")[1].decode()
                self._send(conn, b"1")
            elif kind == b"B":
                pos = body.index(b"\0") + 1
                pos = body.index(b"\0", pos) + 1
                (formats,) = struct.unpack("!h", body[pos:pos + 2])
                pos += 2 + 2 * formats
                (count,) = struct.unpack("!h", body[pos:pos + 2])
                pos += 2
                params = []
                for _ in range(count):
                    (size,) = struct.unpack("!i", body[pos:pos + 4])
                    pos += 4
                    params.append(None if size < 0 else body[pos:pos + size].decode())
                    pos += max(size, 0)
                self._send(conn, b"2")
            elif kind == b"E":
                failed = not self._execute(conn, statement, params)

    def _execute(self, conn, sql, params):
        self.statements.append((sql, list(params)))
        if sql.startswith("CREATE TABLE IF NOT EXISTS machine"):
            self._send(conn, b"C", b"CREATE TABLE\0")
            return True
        if sql.startswith("INSERT INTO machine (name, dataset, model, metadata) VALUES ($1, $2, $3, $4)"):
            try:
                self.rows[params[0]] = tuple(json.dumps(json.loads(p)) for p in params[1:])
            except (TypeError, ValueError):
                self._error(conn, "22P02", "invalid input syntax for type json")
                return False
            self._send(conn, b"C", b"INSERT 0 1\0")
            return True
        if sql == "SELECT name, dataset, model, metadata FROM machine WHERE name = $1":
            found = [(params[0], *self.rows[params[0]])] if params[0] in self.rows else []
            for row in found:
                values = [v.encode() for v in row]
                self._send(conn, b"D", struct.pack("!h", len(values)) + b"".join(
                    struct.pack("!i", len(v)) + v for v in values))
            self._send(conn, b"C", f"SELECT {len(found)}\0".encode())
            return True
        self._error(conn, "42601", f"syntax error in {sql[:40]!r}")
        return False

"""
The Postgres reporter, the port's ``gordo_tpu/reporters/postgres.py``:
one row a machine in a ``machine`` table (``name`` unique, ``dataset``,
``model`` and ``metadata`` as JSON), written by an upsert on ``name`` (the
latest build wins), any failure raised as
:class:`PostgresReporterException` (``build`` and ``build-fleet`` exit 90).

A ``sqlite:///path`` or ``sqlite://:memory:`` host is a ``sqlite3``
database with TEXT columns, as in the JAX package. Any other host is a
Postgres server, reached through the port's own client of its wire
protocol (``reporters/pgwire.py``) where the JAX package needs
``psycopg2``: the columns are ``JSONB``, the machine's JSON goes as bound
parameters (``$1``...), and the statements are the JAX reporter's.
"""

import json
import logging

from ..utils.args import capture_args
from . import pgwire
from .base import BaseReporter, ReporterException

logger = logging.getLogger(__name__)

SQLITE_PREFIX = "sqlite://"


class PostgresReporterException(ReporterException):
    pass


class PostgresReporter(BaseReporter):
    """A machine's row in a SQL database, by name; the JAX reporter's
    parameters (``host``, ``port``, ``user``, ``password``, ``database``)."""

    @capture_args
    def __init__(self, host: str, port: int = 5432, user: str = "postgres", password: str = "postgres",
                 database: str = "postgres"):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        try:
            self._connect()
            self._create_table()
        except PostgresReporterException:
            raise
        except Exception as exc:
            raise PostgresReporterException(exc)

    @property
    def _is_sqlite(self) -> bool:
        return self.host.startswith(SQLITE_PREFIX)

    def _connect(self) -> None:
        if self._is_sqlite:
            import sqlite3

            # sqlite:///abs/path.db -> /abs/path.db; sqlite://:memory: (or sqlite://) -> in memory
            path = self.host[len(SQLITE_PREFIX):]
            if path in ("", ":memory:", "/:memory:"):
                path = ":memory:"
            self._conn = sqlite3.connect(path)
            self._json_type = "TEXT"
        else:
            self._conn = pgwire.connect(self.host, self.port, self.user, self.password, self.database)
            self._json_type = "JSONB"

    def _placeholders(self, n: int) -> list:
        return ["?"] * n if self._is_sqlite else [f"${i + 1}" for i in range(n)]

    def _create_table(self) -> None:
        self._execute(
            f"CREATE TABLE IF NOT EXISTS machine ("
            f"name VARCHAR(255) NOT NULL UNIQUE, "
            f"dataset {self._json_type} NOT NULL, "
            f"model {self._json_type} NOT NULL, "
            f"metadata {self._json_type} NOT NULL)"
        )

    def _execute(self, sql: str, params=()) -> list:
        if self._is_sqlite:
            with self._conn:
                return self._conn.execute(sql, params).fetchall()
        return self._conn.execute(sql, params)

    def report(self, machine) -> None:
        """Upsert the machine: ``name`` and the JSON of its ``dataset``,
        ``model`` and ``metadata``."""
        try:
            record = json.loads(machine.to_json())
            logger.info("Inserting machine %s in sql", machine.name)
            p = self._placeholders(4)
            self._execute(
                f"INSERT INTO machine (name, dataset, model, metadata) "
                f"VALUES ({p[0]}, {p[1]}, {p[2]}, {p[3]}) "
                f"ON CONFLICT (name) DO UPDATE SET "
                f"dataset=excluded.dataset, model=excluded.model, "
                f"metadata=excluded.metadata",
                (record["name"], json.dumps(record["dataset"]), json.dumps(record["model"]),
                 json.dumps(record["metadata"])),
            )
        except Exception as exc:
            raise PostgresReporterException(exc)

    def fetch(self, name: str) -> dict:
        """One machine's row as a dict of its parsed JSON columns."""
        rows = self._execute(
            f"SELECT name, dataset, model, metadata FROM machine WHERE name = {self._placeholders(1)[0]}", (name,))
        if not rows:
            raise PostgresReporterException(f"No machine named {name!r}")
        row = rows[0]

        def parse(value):
            return json.loads(value) if isinstance(value, (str, bytes)) else value

        return {"name": row[0], "dataset": parse(row[1]), "model": parse(row[2]), "metadata": parse(row[3])}

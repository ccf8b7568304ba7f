"""DB-API 2.0 (PEP 249) interface.

``warpdb_tpu.dbapi.connect(source)`` returns a :class:`Connection`
wrapping a :class:`~warpdb_tpu.api.WarpDB` engine, so any DB-API
consumer (ORMs, notebook magics, ``pandas.read_sql``) can query the
engine without learning its native API.  Extension over the
reference, whose only binding surface was the ad-hoc pywarpdb module
(pywarpdb.cpp:18-60).

The engine is read-only (device tables are immutable), so transaction
methods are no-ops per the PEP's permissive reading: ``commit()``
succeeds silently and ``rollback()`` raises :class:`NotSupportedError`.

Typical use::

    import warpdb_tpu.dbapi as dbapi
    conn = dbapi.connect("data/test.csv")
    cur = conn.cursor()
    cur.execute("SELECT quantity, SUM(price) FROM test GROUP BY quantity")
    print(cur.description)   # (name, type_code, ...) per column
    rows = cur.fetchall()    # list of tuples
"""

from __future__ import annotations

import datetime
import time
from typing import Optional

from .errors import (
    ExecutionError,
    ParseError,
    TokenizeError,
    UnsupportedError,
    ValidationError,
    WarpDBError,
)

apilevel = "2.0"
threadsafety = 2  # threads may share the module and connections
paramstyle = "format"  # %s placeholders (values interpolate as literals)


# -- PEP 249 exception hierarchy --------------------------------------------


class Error(WarpDBError):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


# -- type objects (PEP 249 §Type Objects) ------------------------------------


class _DBAPIType:
    def __init__(self, name: str):
        self.name = name

    def __eq__(self, other):  # type: ignore[override]
        return isinstance(other, _DBAPIType) and self.name == other.name

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"<dbapi type {self.name}>"


STRING = _DBAPIType("STRING")
NUMBER = _DBAPIType("NUMBER")
BINARY = _DBAPIType("BINARY")
DATETIME = _DBAPIType("DATETIME")
ROWID = _DBAPIType("ROWID")

Date = datetime.date
Time = datetime.time
Timestamp = datetime.datetime


def DateFromTicks(ticks):
    return Date(*time.localtime(ticks)[:3])


def TimeFromTicks(ticks):
    return Time(*time.localtime(ticks)[3:6])


def TimestampFromTicks(ticks):
    return Timestamp(*time.localtime(ticks)[:6])


def Binary(b):
    return bytes(b)


def _quote(value) -> str:
    """Render one parameter as a SQL literal (the engine has no
    server-side parameter protocol; literals land in the plan canonical
    like any other constant)."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        if value != value or value in (float("inf"), float("-inf")):
            raise DataError(f"Non-finite parameter: {value!r}")
        return repr(value)
    if isinstance(value, str):
        if "\0" in value:
            raise DataError("NUL byte in string parameter")
        return "'" + value.replace("'", "''") + "'"
    raise DataError(f"Unsupported parameter type: {type(value).__name__}")


class Cursor:
    """PEP 249 cursor over a :class:`~warpdb_tpu.api.WarpDB` engine."""

    arraysize = 1

    def __init__(self, connection: "Connection"):
        self._conn = connection
        self._rows: Optional[list[tuple]] = None
        self._pos = 0
        self.description = None
        self.rowcount = -1

    # -- helpers -----------------------------------------------------------

    def _db(self):
        if self._conn._db is None:
            raise InterfaceError("Cursor used after connection close")
        return self._conn._db

    def _require_results(self):
        if self._rows is None:
            raise ProgrammingError("fetch called before execute")

    # -- PEP 249 surface -----------------------------------------------------

    def execute(self, operation: str, parameters=None) -> "Cursor":
        if parameters:
            try:
                operation = operation % tuple(
                    _quote(p) for p in parameters
                )
            except (TypeError, ValueError) as e:
                raise ProgrammingError(
                    f"Parameter interpolation failed: {e}"
                ) from None
        try:
            out = self._db().query_sql_table(operation)
        except (ParseError, TokenizeError, ValidationError) as e:
            raise ProgrammingError(str(e)) from None
        except UnsupportedError as e:
            raise NotSupportedError(str(e)) from None
        except ExecutionError as e:
            raise OperationalError(str(e)) from None
        names = list(out.keys())
        cols = [list(c) for c in out.values()]
        self.description = tuple(
            (
                name,
                STRING
                if any(isinstance(x, str) for x in col)
                else NUMBER,
                None, None, None, None, True,
            )
            for name, col in zip(names, cols)
        )
        self._rows = [
            tuple(
                float(x) if not isinstance(x, str) else x for x in row
            )
            for row in zip(*cols)
        ]
        self.rowcount = len(self._rows)
        self._pos = 0
        return self

    def executemany(self, operation: str, seq_of_parameters) -> "Cursor":
        for parameters in seq_of_parameters:
            self.execute(operation, parameters)
        return self

    def fetchone(self) -> Optional[tuple]:
        self._require_results()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> list[tuple]:
        self._require_results()
        size = self.arraysize if size is None else size
        out = self._rows[self._pos : self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> list[tuple]:
        self._require_results()
        out = self._rows[self._pos :]
        self._pos = len(self._rows)
        return out

    def close(self) -> None:
        self._rows = None
        self.description = None

    def setinputsizes(self, sizes) -> None:  # pragma: no cover - no-op
        pass

    def setoutputsize(self, size, column=None) -> None:  # pragma: no cover
        pass

    def __iter__(self):
        self._require_results()
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Connection:
    """PEP 249 connection.  ``source`` is anything the
    :class:`~warpdb_tpu.api.WarpDB` constructor accepts (CSV/NDJSON/
    Parquet/Feather/ORC path, HostTable, pyarrow table); extra named
    tables register via :meth:`register_table` for JOINs."""

    # Exceptions as connection attributes (PEP 249 optional extension).
    Error = Error
    InterfaceError = InterfaceError
    DatabaseError = DatabaseError
    DataError = DataError
    OperationalError = OperationalError
    IntegrityError = IntegrityError
    InternalError = InternalError
    ProgrammingError = ProgrammingError
    NotSupportedError = NotSupportedError

    def __init__(self, source, schema=None, mesh=None):
        from .api import WarpDB

        self._db = WarpDB(source, schema, mesh=mesh)

    def register_table(self, name: str, source, schema=None) -> None:
        if self._db is None:
            raise InterfaceError("Connection is closed")
        self._db.register_table(name, source, schema)

    def cursor(self) -> Cursor:
        if self._db is None:
            raise InterfaceError("Connection is closed")
        return Cursor(self)

    def commit(self) -> None:
        # Read-only engine: nothing to commit; succeed per PEP 249's
        # guidance for databases without transactions.
        if self._db is None:
            raise InterfaceError("Connection is closed")

    def rollback(self) -> None:
        raise NotSupportedError("warpdb_tpu is read-only")

    def close(self) -> None:
        self._db = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def connect(source, schema=None, mesh=None) -> Connection:
    """Open a PEP 249 connection over a table source."""
    return Connection(source, schema, mesh=mesh)

"""Serializers and deserializers for Kafka messages.

API parity with the reference
(upstream bytewax ``pysrc/bytewax/connectors/kafka/serde.py``).  The
Avro implementations require the ``fastavro`` package; the abstract
interfaces are dependency-free.
"""

import io
from abc import ABC, abstractmethod
from typing import Any, Generic, TypeVar

In = TypeVar("In")
Out = TypeVar("Out")

__all__ = [
    "ConfluentAvroDeserializer",
    "ConfluentAvroSerializer",
    "Deserializer",
    "PlainAvroDeserializer",
    "PlainAvroSerializer",
    "SchemaDeserializer",
    "SchemaRegistryClient",
    "SchemaSerializer",
    "Serializer",
    "confluent_wire_decode",
    "confluent_wire_encode",
]


class SchemaSerializer(ABC, Generic[In, Out]):
    """Serialize a value using a schema."""

    @abstractmethod
    def ser(self, obj: In) -> Out:
        """Serialize the object."""
        ...


class SchemaDeserializer(ABC, Generic[In, Out]):
    """Deserialize a value using a schema."""

    @abstractmethod
    def de(self, data: In) -> Out:
        """Deserialize the data."""
        ...


class Serializer(SchemaSerializer[Any, bytes]):
    """Serialize any object to bytes."""


class Deserializer(SchemaDeserializer[bytes, Any]):
    """Deserialize bytes to an object."""


def _require_fastavro():
    try:
        import fastavro

        return fastavro
    except ImportError as ex:
        msg = (
            "Avro serde requires the `fastavro` package; install it to "
            "use PlainAvroSerializer/PlainAvroDeserializer"
        )
        raise ImportError(msg) from ex


class PlainAvroSerializer(Serializer):
    """Serialize with plain Avro binary encoding (no schema-registry
    framing; use the Confluent serializers for wire-format messages)."""

    def __init__(self, schema: Any):
        fastavro = _require_fastavro()
        self._schema = fastavro.parse_schema(
            schema if isinstance(schema, dict) else _load_schema(schema)
        )
        self._fastavro = fastavro

    def ser(self, obj: Any) -> bytes:
        buf = io.BytesIO()
        self._fastavro.schemaless_writer(buf, self._schema, obj)
        return buf.getvalue()


class PlainAvroDeserializer(Deserializer):
    """Deserialize plain Avro binary data (no schema-registry
    framing)."""

    def __init__(self, schema: Any):
        fastavro = _require_fastavro()
        self._schema = fastavro.parse_schema(
            schema if isinstance(schema, dict) else _load_schema(schema)
        )
        self._fastavro = fastavro

    def de(self, data: bytes) -> Any:
        buf = io.BytesIO(data)
        return self._fastavro.schemaless_reader(buf, self._schema)


def _load_schema(schema: Any) -> dict:
    import json

    if isinstance(schema, str):
        return json.loads(schema)
    msg = f"unsupported schema type {type(schema)!r}"
    raise TypeError(msg)


# -- Confluent schema-registry wire format ----------------------------------
#
# Reference exposes ConfluentSerializer/ConfluentDeserializer wrapping
# the `confluent_kafka` client (`pysrc/bytewax/connectors/kafka/
# serde.py`).  Here the wire format (magic byte 0 + big-endian schema
# id + Avro body) and a dependency-free urllib registry client are
# implemented natively, so serde works wherever `fastavro` does —
# no `confluent_kafka` needed for the data plane.

_WIRE_MAGIC = 0


def confluent_wire_encode(schema_id: int, payload: bytes) -> bytes:
    """Frame an encoded payload in Confluent wire format."""
    import struct

    return struct.pack(">bI", _WIRE_MAGIC, schema_id) + payload


def confluent_wire_decode(data: bytes) -> "tuple[int, bytes]":
    """Split Confluent wire format into ``(schema_id, payload)``."""
    import struct

    if len(data) < 5:
        msg = f"message too short for Confluent wire format: {len(data)}B"
        raise ValueError(msg)
    magic, schema_id = struct.unpack(">bI", data[:5])
    if magic != _WIRE_MAGIC:
        msg = f"unknown Confluent wire-format magic byte {magic}"
        raise ValueError(msg)
    return schema_id, data[5:]


class SchemaRegistryClient:
    """Minimal Confluent-compatible schema-registry REST client
    (works with Confluent Schema Registry and Redpanda's registry;
    stdlib urllib only)."""

    def __init__(self, url: str, auth: "tuple[str, str] | None" = None):
        self.url = url.rstrip("/")
        self._auth = auth
        self._by_id: dict = {}

    def _request(self, path: str, body: "bytes | None" = None) -> Any:
        import base64
        import json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.url + path, data=body)
        req.add_header(
            "Content-Type", "application/vnd.schemaregistry.v1+json"
        )
        if self._auth is not None:
            token = base64.b64encode(
                f"{self._auth[0]}:{self._auth[1]}".encode()
            ).decode()
            req.add_header("Authorization", f"Basic {token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as ex:
            # Surface the registry's JSON error body (error_code +
            # message, e.g. schema-incompatibility details).
            detail = ""
            try:
                detail = ex.read().decode(errors="replace")
            except OSError:
                pass
            msg = f"schema registry request {path!r} failed: {ex}"
            if detail:
                msg += f" — {detail}"
            raise RuntimeError(msg) from ex

    def schema_for_id(self, schema_id: int) -> dict:
        """The parsed schema registered under ``schema_id`` (cached)."""
        import json

        schema = self._by_id.get(schema_id)
        if schema is None:
            got = self._request(f"/schemas/ids/{schema_id}")
            schema = json.loads(got["schema"])
            self._by_id[schema_id] = schema
        return schema

    def latest_for_subject(self, subject: str) -> "tuple[int, dict]":
        """``(schema_id, parsed_schema)`` of a subject's latest
        version."""
        import json

        got = self._request(f"/subjects/{subject}/versions/latest")
        schema = json.loads(got["schema"])
        self._by_id[got["id"]] = schema
        return got["id"], schema

    def register(self, subject: str, schema: dict) -> int:
        """Register a schema under a subject; returns its id."""
        import json

        body = json.dumps({"schema": json.dumps(schema)}).encode()
        got = self._request(f"/subjects/{subject}/versions", body)
        return got["id"]


class ConfluentAvroSerializer(Serializer):
    """Serialize to Confluent wire format, registering (or fetching)
    the subject's schema on first use."""

    def __init__(
        self, client: SchemaRegistryClient, subject: str, schema: Any = None
    ):
        fastavro = _require_fastavro()
        self._fastavro = fastavro
        if schema is not None:
            parsed = schema if isinstance(schema, dict) else _load_schema(schema)
            self._schema_id = client.register(subject, parsed)
        else:
            self._schema_id, parsed = client.latest_for_subject(subject)
        self._schema = fastavro.parse_schema(parsed)

    def ser(self, obj: Any) -> bytes:
        buf = io.BytesIO()
        self._fastavro.schemaless_writer(buf, self._schema, obj)
        return confluent_wire_encode(self._schema_id, buf.getvalue())


class ConfluentAvroDeserializer(Deserializer):
    """Deserialize Confluent wire format, resolving the writer schema
    from the registry by the frame's schema id (cached per id)."""

    def __init__(self, client: SchemaRegistryClient):
        self._fastavro = _require_fastavro()
        self._client = client
        self._parsed: dict = {}

    def de(self, data: bytes) -> Any:
        schema_id, payload = confluent_wire_decode(data)
        schema = self._parsed.get(schema_id)
        if schema is None:
            schema = self._fastavro.parse_schema(
                self._client.schema_for_id(schema_id)
            )
            self._parsed[schema_id] = schema
        return self._fastavro.schemaless_reader(io.BytesIO(payload), schema)

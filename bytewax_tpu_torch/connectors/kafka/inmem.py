"""In-process broker speaking the ``confluent_kafka`` surface.

A protocol-level stand-in for a Kafka cluster — NOT a mock: topics are
real partitioned append-only logs with offset semantics, consumers
hold per-partition positions, ``enable.partition.eof`` raises the same
``_PARTITION_EOF`` error object a live broker would, the statistics
callback delivers librdkafka-shaped JSON (the consumer-lag path), and
producers run the default hash partitioner.  The connector code in
:mod:`bytewax_tpu_torch.connectors.kafka` runs UNMODIFIED against it — the
reference gates the equivalent tests on a live broker
(upstream bytewax ``pytests/connectors/test_kafka.py:27-30``); this
module lets partition discovery, offset resume, EOF, error routing,
and the lag gauge run hermetically, with live-broker tests still
gated on ``TEST_KAFKA_BROKER``.

Usage (tests or local dev)::

    from bytewax_tpu_torch.connectors.kafka import inmem

    broker = inmem.broker_for("inmem://demo")   # registry by address
    broker.create_topic("events", partitions=3)
    broker.produce("events", key=b"k", value=b"v")
    with inmem.installed():                     # sys.modules shim
        ...  # KafkaSource/KafkaSink against brokers=["inmem://demo"]
"""

import contextlib
import json
import sys
import threading
import time
import types
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "InMemoryBroker",
    "broker_for",
    "installed",
    "reset",
    "Consumer",
    "Producer",
    "KafkaError",
    "Message",
    "TopicPartition",
    "AdminClient",
]

OFFSET_BEGINNING = -2
OFFSET_END = -1

_REGISTRY: Dict[str, "InMemoryBroker"] = {}
_REG_LOCK = threading.Lock()


def broker_for(address: str) -> "InMemoryBroker":
    """The broker behind an address, created on first use (the same
    address always names the same broker within a process)."""
    with _REG_LOCK:
        broker = _REGISTRY.get(address)
        if broker is None:
            broker = InMemoryBroker()
            _REGISTRY[address] = broker
        return broker


def reset() -> None:
    """Drop every registered broker (test isolation)."""
    with _REG_LOCK:
        _REGISTRY.clear()


class KafkaError:
    """Mirror of ``confluent_kafka.KafkaError`` (code + reason)."""

    _PARTITION_EOF = -191

    def __init__(self, code: int, reason: str = ""):
        self._code = code
        self._reason = reason

    def code(self) -> int:
        return self._code

    def __str__(self) -> str:
        return self._reason or f"KafkaError(code={self._code})"

    def __repr__(self) -> str:
        return f"KafkaError({self._code}, {self._reason!r})"


class Message:
    """Mirror of ``confluent_kafka.Message`` (method-style accessors)."""

    __slots__ = (
        "_key",
        "_value",
        "_topic",
        "_partition",
        "_offset",
        "_headers",
        "_timestamp",
        "_error",
    )

    def __init__(
        self,
        key,
        value,
        topic,
        partition,
        offset,
        headers=None,
        timestamp=None,
        error=None,
    ):
        self._key = key
        self._value = value
        self._topic = topic
        self._partition = partition
        self._offset = offset
        self._headers = headers or []
        self._timestamp = timestamp or (1, int(time.time() * 1000))
        self._error = error

    def key(self):
        return self._key

    def value(self):
        return self._value

    def topic(self):
        return self._topic

    def partition(self):
        return self._partition

    def offset(self):
        return self._offset

    def headers(self):
        return self._headers

    def timestamp(self):
        return self._timestamp

    def latency(self):
        return None

    def error(self):
        return self._error


class TopicPartition:
    """Mirror of ``confluent_kafka.TopicPartition``."""

    def __init__(self, topic: str, partition: int = -1, offset: int = -1001):
        self.topic = topic
        self.partition = partition
        self.offset = offset


class _PartitionMeta:
    def __init__(self, pid: int):
        self.id = pid


class _TopicMeta:
    def __init__(self, name: str, n_parts: int):
        self.topic = name
        self.partitions = {i: _PartitionMeta(i) for i in range(n_parts)}


class _ClusterMeta:
    def __init__(self, topics: Dict[str, _TopicMeta]):
        self.topics = topics


class InMemoryBroker:
    """Partitioned append-only logs plus the metadata surface."""

    def __init__(self):
        self._lock = threading.Lock()
        #: topic -> list of per-partition logs (lists of Message).
        self._topics: Dict[str, List[List[Message]]] = {}

    def create_topic(self, name: str, partitions: int = 1) -> None:
        with self._lock:
            self._topics.setdefault(
                name, [[] for _ in range(partitions)]
            )

    def partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._topics.get(topic, ()))

    def log(self, topic: str, partition: int) -> List[Message]:
        with self._lock:
            return list(self._topics[topic][partition])

    def produce(
        self,
        topic: str,
        value: Optional[bytes] = None,
        key: Optional[bytes] = None,
        headers: Optional[List[Tuple[str, bytes]]] = None,
        partition: Optional[int] = None,
    ) -> Message:
        """Append a message; partition by key hash (None key → 0) when
        unspecified, like the default partitioner."""
        with self._lock:
            if topic not in self._topics:
                # Auto-create single-partition topics, the common
                # broker default (auto.create.topics.enable).
                self._topics[topic] = [[]]
            logs = self._topics[topic]
            if partition is None:
                partition = (
                    zlib.crc32(key) % len(logs) if key is not None else 0
                )
            log = logs[partition]
            msg = Message(
                key, value, topic, partition, len(log), headers
            )
            log.append(msg)
            return msg

    def inject_error(
        self, topic: str, partition: int, code: int, reason: str
    ) -> None:
        """Append a transport-error marker (consumers surface it as a
        message whose ``.error()`` is set, like librdkafka)."""
        with self._lock:
            log = self._topics[topic][partition]
            log.append(
                Message(
                    None,
                    None,
                    topic,
                    partition,
                    len(log),
                    error=KafkaError(code, reason),
                )
            )

    def _meta(self) -> _ClusterMeta:
        with self._lock:
            return _ClusterMeta(
                {
                    name: _TopicMeta(name, len(logs))
                    for name, logs in self._topics.items()
                }
            )


def _broker_of_config(config: dict) -> InMemoryBroker:
    addrs = str(config.get("bootstrap.servers", "")).split(",")
    return broker_for(addrs[0])


class Consumer:
    """Mirror of ``confluent_kafka.Consumer`` over the registry."""

    def __init__(self, config: dict):
        self._broker = _broker_of_config(config)
        self._positions: Dict[Tuple[str, int], int] = {}
        self._eof_sent: Dict[Tuple[str, int], int] = {}
        self._partition_eof = (
            str(config.get("enable.partition.eof", "false")).lower()
            == "true"
        )
        self._stats_cb = config.get("stats_cb")
        self._closed = False

    def assign(self, parts: List[TopicPartition]) -> None:
        for tp in parts:
            log_len = len(self._broker._topics[tp.topic][tp.partition])
            offset = tp.offset
            if offset == OFFSET_BEGINNING:
                offset = 0
            elif offset == OFFSET_END:
                offset = log_len
            self._positions[(tp.topic, tp.partition)] = max(0, offset)

    def _fire_stats(self) -> None:
        if self._stats_cb is None:
            return
        topics: Dict[str, Any] = {}
        for (topic, part), _pos in self._positions.items():
            log = self._broker._topics[topic][part]
            topics.setdefault(topic, {"partitions": {}})["partitions"][
                str(part)
            ] = {"ls_offset": len(log)}
        self._stats_cb(json.dumps({"topics": topics}))

    def consume(self, num_messages: int, timeout: float = 0.0):
        if self._closed:
            msg = "consumer is closed"
            raise RuntimeError(msg)
        out: List[Message] = []
        self._fire_stats()
        for (topic, part), pos in self._positions.items():
            log = self._broker._topics[topic][part]
            while pos < len(log) and len(out) < num_messages:
                out.append(log[pos])
                pos += 1
            self._positions[(topic, part)] = pos
            if (
                self._partition_eof
                and pos >= len(log)
                and len(out) < num_messages
                and self._eof_sent.get((topic, part)) != pos
            ):
                # One EOF marker per arrival at the log end — new
                # appends rearm it, exactly like librdkafka.
                self._eof_sent[(topic, part)] = pos
                out.append(
                    Message(
                        None,
                        None,
                        topic,
                        part,
                        pos,
                        error=KafkaError(
                            KafkaError._PARTITION_EOF,
                            f"{topic}[{part}] reached end of log",
                        ),
                    )
                )
        return out

    def close(self) -> None:
        self._closed = True


class Producer:
    """Mirror of ``confluent_kafka.Producer`` over the registry."""

    def __init__(self, config: dict):
        self._broker = _broker_of_config(config)
        self._pending = 0

    def produce(
        self,
        topic: str,
        value=None,
        key=None,
        headers=None,
        partition: Optional[int] = None,
        on_delivery=None,
    ) -> None:
        msg = self._broker.produce(
            topic, value, key, headers, partition
        )
        self._pending += 1
        if on_delivery is not None:
            on_delivery(None, msg)

    def poll(self, timeout: float = 0.0) -> int:
        served, self._pending = self._pending, 0
        return served

    def flush(self, timeout: float = -1.0) -> int:
        self._pending = 0
        return 0


class AdminClient:
    """Mirror of ``confluent_kafka.admin.AdminClient``."""

    def __init__(self, config: dict):
        self._broker = _broker_of_config(config)

    def poll(self, timeout: float = 0.0) -> int:
        return 0

    def list_topics(self, timeout: float = -1.0) -> _ClusterMeta:
        return self._meta()

    def _meta(self) -> _ClusterMeta:
        return self._broker._meta()


def _build_modules() -> Tuple[types.ModuleType, types.ModuleType]:
    mod = types.ModuleType("confluent_kafka")
    mod.Consumer = Consumer
    mod.Producer = Producer
    mod.KafkaError = KafkaError
    mod.Message = Message
    mod.TopicPartition = TopicPartition
    mod.OFFSET_BEGINNING = OFFSET_BEGINNING
    mod.OFFSET_END = OFFSET_END
    admin = types.ModuleType("confluent_kafka.admin")
    admin.AdminClient = AdminClient
    mod.admin = admin
    return mod, admin


@contextlib.contextmanager
def installed():
    """Install the in-process broker as ``confluent_kafka`` in
    ``sys.modules`` for the duration of the block (no-op overlay when
    the real client is absent; restores whatever was there)."""
    mod, admin = _build_modules()
    saved = {
        name: sys.modules.get(name)
        for name in ("confluent_kafka", "confluent_kafka.admin")
    }
    sys.modules["confluent_kafka"] = mod
    sys.modules["confluent_kafka.admin"] = admin
    try:
        yield mod
    finally:
        for name, old in saved.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old

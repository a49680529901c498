"""Connectors for Kafka.

API parity with the reference
(upstream bytewax ``pysrc/bytewax/connectors/kafka/__init__.py``);
implementation is our own.  Importing this module works without
``confluent_kafka`` installed (message dataclasses and serde
interfaces are pure Python); constructing a source/sink without the
library raises a clear error.

Use :class:`KafkaSource`/:class:`KafkaSink` directly for raw bytes, or
the operator namespace in :mod:`bytewax_tpu_torch.connectors.kafka.operators`
for error-split streams and (de)serialization.
"""

import json
from dataclasses import dataclass, field
from typing import (
    Any,
    Dict,
    Generic,
    Iterable,
    List,
    Optional,
    Tuple,
    TypeVar,
    Union,
)

import numpy as np
from bytewax_tpu_torch._metrics import Gauge
from bytewax_tpu_torch.errors import TransientSinkError, TransientSourceError
from bytewax_tpu_torch.inputs import (
    ColumnarBatch,
    FixedPartitionedSource,
    StatefulSourcePartition,
)
from bytewax_tpu_torch.outputs import DynamicSink, StatelessSinkPartition

K = TypeVar("K")
V = TypeVar("V")
K2 = TypeVar("K2")
V2 = TypeVar("V2")

__all__ = [
    "KafkaError",
    "KafkaSink",
    "KafkaSinkMessage",
    "KafkaSource",
    "KafkaSourceMessage",
    "TRANSIENT_KAFKA_CODES",
    "is_transient_kafka_error",
]

#: Start from the beginning of the topic (mirror of
#: ``confluent_kafka.OFFSET_BEGINNING``).
OFFSET_BEGINNING = -2
#: Start from the end of the topic.
OFFSET_END = -1

#: librdkafka error codes classified transient by default: transport
#: hiccups, broker/coordinator timeouts and elections — the failures
#: a healthy cluster recovers from in seconds.  A poll/produce error
#: with one of these codes raises a typed
#: :class:`~bytewax_tpu_torch.errors.TransientSourceError` /
#: :class:`~bytewax_tpu_torch.errors.TransientSinkError` that the engine
#: retries at the poll/write boundary (docs/recovery.md
#: "Connector-edge resilience") instead of unwinding the execution.
#: Negative codes are librdkafka-internal (``_TRANSPORT`` et al.);
#: positive ones are broker protocol errors.
TRANSIENT_KAFKA_CODES = frozenset(
    {
        -195,  # _TRANSPORT: broker transport failure
        -187,  # _ALL_BROKERS_DOWN
        -185,  # _TIMED_OUT: operation timed out
        -192,  # _MSG_TIMED_OUT: local message timeout
        -180,  # _WAIT_COORD: waiting for coordinator
        -168,  # _RETRY: retry operation
        5,  # LEADER_NOT_AVAILABLE
        6,  # NOT_LEADER_FOR_PARTITION
        7,  # REQUEST_TIMED_OUT
        13,  # NETWORK_EXCEPTION
        14,  # COORDINATOR_LOAD_IN_PROGRESS
        15,  # COORDINATOR_NOT_AVAILABLE
        16,  # NOT_COORDINATOR
        19,  # NOT_ENOUGH_REPLICAS
        20,  # NOT_ENOUGH_REPLICAS_AFTER_APPEND
    }
)


def is_transient_kafka_error(error: Any) -> bool:
    """Whether a ``confluent_kafka.KafkaError`` is worth retrying at
    the connector edge.  Prefers librdkafka's own ``retriable()``
    verdict when the client exposes it, falling back to the pinned
    :data:`TRANSIENT_KAFKA_CODES`."""
    if error is None:
        return False
    retriable = getattr(error, "retriable", None)
    if callable(retriable):
        try:
            if retriable():
                return True
        except Exception:  # noqa: BLE001 - stub/partial mocks
            pass
    code = getattr(error, "code", None)
    try:
        return callable(code) and code() in TRANSIENT_KAFKA_CODES
    except Exception:  # noqa: BLE001
        return False


def _kafka_error_of(ex: BaseException) -> Any:
    """The ``KafkaError`` carried by a ``KafkaException`` (its first
    arg, per the confluent_kafka convention), or None."""
    args = getattr(ex, "args", ())
    return args[0] if args else None

#: On the engine's registry (exposed beside the default one at
#: ``GET /metrics``), so that this package and the JAX package can be
#: imported into one process without registering the name twice.
_CONSUMER_LAG_GAUGE = Gauge(
    "bytewax_kafka_consumer_lag",
    "Difference between last offset on the broker and the current consumed offset",
    ["step_id", "topic", "partition"],
)


def _require_confluent():
    try:
        import confluent_kafka  # noqa: F401

        return confluent_kafka
    except ImportError as ex:
        msg = (
            "Kafka connectors require the `confluent_kafka` package; "
            "pip install bytewax-tpu[kafka]"
        )
        raise ImportError(msg) from ex


@dataclass(frozen=True)
class KafkaSourceMessage(Generic[K, V]):
    """Message read from Kafka.

    >>> from bytewax_tpu_torch.connectors.kafka import KafkaSourceMessage
    >>> msg = KafkaSourceMessage(key=b"k", value=b"v", topic="events")
    >>> msg.to_sink()
    KafkaSinkMessage(key=b'k', value=b'v', topic='events', headers=[], \
partition=None, timestamp=0)
    """

    key: K
    value: V
    topic: Optional[str] = field(default=None)
    headers: List[Tuple[str, bytes]] = field(default_factory=list)
    latency: Optional[float] = field(default=None)
    offset: Optional[int] = field(default=None)
    partition: Optional[int] = field(default=None)
    timestamp: Optional[Tuple[int, int]] = field(default=None)

    def to_sink(self) -> "KafkaSinkMessage[K, V]":
        """Convert to a sink message, keeping key, value, topic,
        headers."""
        return KafkaSinkMessage(
            key=self.key,
            value=self.value,
            topic=self.topic,
            headers=self.headers,
        )

    def _with_key(self, key: K2) -> "KafkaSourceMessage[K2, V]":
        return KafkaSourceMessage(
            key=key,
            value=self.value,
            topic=self.topic,
            headers=self.headers,
            latency=self.latency,
            offset=self.offset,
            partition=self.partition,
            timestamp=self.timestamp,
        )

    def _with_value(self, value: V2) -> "KafkaSourceMessage[K, V2]":
        return KafkaSourceMessage(
            key=self.key,
            value=value,
            topic=self.topic,
            headers=self.headers,
            latency=self.latency,
            offset=self.offset,
            partition=self.partition,
            timestamp=self.timestamp,
        )

    def _with_key_and_value(
        self, key: K2, value: V2
    ) -> "KafkaSourceMessage[K2, V2]":
        return self._with_key(key)._with_value(value)


@dataclass(frozen=True)
class KafkaError(Generic[K, V]):
    """Error from a :class:`KafkaSource`.

    Appears on the ``errs`` stream of ``kafka.operators.input``; route
    it to a dead-letter sink or :func:`bytewax_tpu_torch.operators.raises`:

    >>> from bytewax_tpu_torch.connectors.kafka import (
    ...     KafkaError, KafkaSourceMessage,
    ... )
    >>> err = KafkaError(
    ...     error="broker transport failure",
    ...     msg=KafkaSourceMessage(key=None, value=None, topic="events"),
    ... )
    >>> err.msg.topic
    'events'
    """

    error: object
    """Underlying `confluent_kafka.KafkaError`."""

    msg: KafkaSourceMessage[K, V]
    """Message attached to that error."""


@dataclass(frozen=True)
class KafkaSinkMessage(Generic[K, V]):
    """Message to be written to Kafka.

    >>> from bytewax_tpu_torch.connectors.kafka import KafkaSinkMessage
    >>> msg = KafkaSinkMessage(key=None, value=b"payload", topic="out")
    >>> msg.value
    b'payload'
    """

    key: K
    value: V
    topic: Optional[str] = None
    headers: List[Tuple[str, bytes]] = field(default_factory=list)
    partition: Optional[int] = None
    timestamp: int = 0

    def _with_key(self, key: K2) -> "KafkaSinkMessage[K2, V]":
        return KafkaSinkMessage(
            key=key,
            value=self.value,
            topic=self.topic,
            headers=self.headers,
            partition=self.partition,
            timestamp=self.timestamp,
        )

    def _with_value(self, value: V2) -> "KafkaSinkMessage[K, V2]":
        return KafkaSinkMessage(
            key=self.key,
            value=value,
            topic=self.topic,
            headers=self.headers,
            partition=self.partition,
            timestamp=self.timestamp,
        )

    def _with_key_and_value(
        self, key: K2, value: V2
    ) -> "KafkaSinkMessage[K2, V2]":
        return self._with_key(key)._with_value(value)


_RawSourceItem = Union[
    KafkaSourceMessage[Optional[bytes], Optional[bytes]],
    KafkaError[Optional[bytes], Optional[bytes]],
]


class _KafkaSourcePartition(
    StatefulSourcePartition[_RawSourceItem, Optional[int]]
):
    def __init__(
        self,
        step_id: str,
        config: dict,
        topic: str,
        part_idx: int,
        starting_offset: int,
        resume_state: Optional[int],
        batch_size: int,
        on_error: str,
        columnar: bool = False,
    ):
        ck = _require_confluent()
        self._offset = starting_offset if resume_state is None else resume_state
        config.update({"stats_cb": self._process_stats})
        consumer = ck.Consumer(config)
        # assign (not subscribe): the recovery system is the consumer
        # group; offsets resume from our snapshots.
        consumer.assign([ck.TopicPartition(topic, part_idx, self._offset)])
        self._consumer = consumer
        self._topic = topic
        self._part_idx = part_idx
        self._batch_size = batch_size
        self._eof = False
        #: Error policy: ``raise`` (transient codes become typed
        #: TransientSourceError the engine retries, the rest raise),
        #: ``route`` (KafkaError items flow downstream), ``dlq``
        #: (error frames become dead letters the engine drains).
        self._on_error = on_error
        self._columnar = columnar
        self._partition_eof_code = ck.KafkaError._PARTITION_EOF
        self._lag_gauge = _CONSUMER_LAG_GAUGE.labels(
            step_id, topic, str(part_idx)
        )
        #: Dead letters captured under ``on_error="dlq"``; drained by
        #: the engine after every poll (``drain_dead_letters``).
        self._dead: List[dict] = []
        #: A transient error deferred to the NEXT poll so the rows
        #: consumed before it in the same poll flow (and their
        #: offsets snapshot) first — the same ordering trick as the
        #: partition-EOF marker.
        self._pending_error: Optional[BaseException] = None
        #: Messages consumed in the same poll AFTER a deferred
        #: transient error: the consumer's position already moved
        #: past them, so they re-enter via the retry poll instead of
        #: being lost.
        self._pending_msgs: List[Any] = []

    def _process_stats(self, json_stats: str) -> None:
        stats = json.loads(json_stats)
        part = (
            stats.get("topics", {})
            .get(self._topic, {})
            .get("partitions", {})
            .get(str(self._part_idx))
        )
        if part is not None and self._offset > 0:
            self._lag_gauge.set(part["ls_offset"] - self._offset)

    def _columnar_batch(self, msgs) -> Optional[Any]:
        """One ``ColumnarBatch`` from a clean poll — raw ``key``/
        ``value`` byte columns plus an int64 ``ts`` column of broker
        timestamps in microseconds since epoch (the engine's numeric-
        ts convention, so source-lag accounting and event-time clocks
        read it directly) — or ``None`` when any message carries an
        error, a null key/value, or a key/value ending in a NUL byte:
        those polls take the itemized path unchanged (error routing
        and ``None`` fields are per-row concerns the columnar format
        can't represent losslessly, and numpy ``S`` columns strip
        trailing NULs — silently corrupting e.g. fixed-width binary
        payloads — so NUL-tailed bytes stay itemized too)."""
        cut = None
        for i, msg in enumerate(msgs):
            error = msg.error()
            if error is not None:
                if error.code() == self._partition_eof_code:
                    cut = i
                    break
                return None
            key, value = msg.key(), msg.value()
            if key is None or value is None:
                return None
            if key[-1:] == b"\x00" or value[-1:] == b"\x00":
                return None
        if cut is not None:
            # Emit the rows before the EOF marker; StopIteration on
            # the next poll (same ordering as the itemized path).
            self._eof = True
            msgs = msgs[:cut]
        if not msgs:
            return []
        cols: Dict[str, Any] = {
            "key": np.array([m.key() for m in msgs]),
            "value": np.array([m.value() for m in msgs]),
        }
        stamps = [m.timestamp() for m in msgs]
        if all(s is not None and s[0] != 0 for s in stamps):
            # Timestamp type 0 = TIMESTAMP_NOT_AVAILABLE; a batch
            # without trustworthy stamps just omits the column (lag
            # accounting skips it).
            cols["ts"] = np.array(
                [s[1] for s in stamps], dtype=np.int64
            ) * np.int64(1000)
        self._offset = msgs[-1].offset() + 1
        return ColumnarBatch(cols)

    def next_batch(self) -> Any:
        if self._pending_error is not None:
            # The rows polled alongside this error already flowed
            # (and their offsets snapshot); now the engine's retry
            # ladder sees the failure at a clean poll boundary.
            ex, self._pending_error = self._pending_error, None
            raise ex
        if self._eof:
            raise StopIteration()
        if self._pending_msgs:
            msgs, self._pending_msgs = self._pending_msgs, []
        else:
            try:
                msgs = self._consumer.consume(self._batch_size, 0.001)
            except Exception as ex:  # noqa: BLE001
                if is_transient_kafka_error(_kafka_error_of(ex)):
                    msg = (
                        f"transient Kafka poll failure on "
                        f"{self._topic}[{self._part_idx}]: {ex}"
                    )
                    raise TransientSourceError(msg) from ex
                raise
        if self._columnar:
            out = self._columnar_batch(msgs)
            if out is not None:
                return out
        batch: List[_RawSourceItem] = []
        last_offset = None
        for i, msg in enumerate(msgs):
            error = msg.error()
            if error is not None:
                if error.code() == self._partition_eof_code:
                    # Emit this batch first; EOF on the next poll.
                    self._eof = True
                    break
                if self._on_error != "route" and (
                    is_transient_kafka_error(error)
                ):
                    # Transient codes take the retry ladder under BOTH
                    # the raise and dlq policies: a down broker is a
                    # condition to back off from (and eventually
                    # quarantine/escalate), not a poison record — a
                    # dlq'd transport failure would flood the DLQ with
                    # unactionable rows while io_retries_count never
                    # moved.  ("route" keeps its legacy contract:
                    # every error frame flows as a KafkaError item.)
                    err = (
                        f"error consuming from Kafka topic "
                        f"{self._topic!r}: {error}"
                    )
                    # With rows gathered before the error, the raise
                    # defers to the NEXT poll so they flow (and their
                    # offsets snapshot) first; an empty-handed poll
                    # raises NOW — returning [] would read as a
                    # healthy probe and reset the engine's
                    # consecutive-failure ladder, so a persistently-
                    # down broker could never reach quarantine or
                    # escalation.  Messages the consumer already
                    # handed over after the error re-enter via the
                    # retry poll.
                    tse = TransientSourceError(err)
                    self._pending_msgs = list(msgs[i + 1 :])
                    if batch:
                        self._pending_error = tse
                        break
                    raise tse
                if self._on_error == "dlq":
                    # Dead-letter the (non-transient) error frame with
                    # provenance and keep the partition flowing; the
                    # engine drains these right after the poll, into
                    # the epoch whose snapshots cover this poll's
                    # offsets.
                    self._dead.append(
                        {
                            "error": str(error),
                            "code": error.code(),
                            "topic": msg.topic() or self._topic,
                            "partition": msg.partition(),
                            "offset": msg.offset(),
                            "payload": None,
                        }
                    )
                elif self._on_error == "raise":
                    err = (
                        f"error consuming from Kafka topic "
                        f"{self._topic!r}: {error}"
                    )
                    raise RuntimeError(err)
                else:  # "route": KafkaError items flow downstream
                    batch.append(
                        KafkaError(
                            error,
                            KafkaSourceMessage(
                                key=msg.key(),
                                value=msg.value(),
                                topic=msg.topic(),
                                headers=msg.headers() or [],
                                latency=msg.latency(),
                                offset=msg.offset(),
                                partition=msg.partition(),
                                timestamp=msg.timestamp(),
                            ),
                        )
                    )
                off = msg.offset()
                if off is not None and off >= 0:
                    last_offset = off
                continue
            batch.append(
                KafkaSourceMessage(
                    key=msg.key(),
                    value=msg.value(),
                    topic=msg.topic(),
                    headers=msg.headers() or [],
                    latency=msg.latency(),
                    offset=msg.offset(),
                    partition=msg.partition(),
                    timestamp=msg.timestamp(),
                )
            )
            last_offset = msg.offset()
        if last_offset is not None:
            # Resume from the message after the last one read.
            self._offset = last_offset + 1
        return batch

    def drain_dead_letters(self) -> List[dict]:
        """Poison records captured under ``on_error="dlq"`` since the
        last drain (the engine calls this after every poll)."""
        dead, self._dead = self._dead, []
        return dead

    def snapshot(self) -> Optional[int]:
        return self._offset

    def close(self) -> None:
        self._consumer.close()


class KafkaSource(FixedPartitionedSource[_RawSourceItem, Optional[int]]):
    """Use a set of Kafka topics as an input source.

    Kafka partitions are the unit of parallelism; offsets are
    snapshotted into the recovery system (exactly-once capable).
    Messages enter the dataflow as :class:`KafkaSourceMessage` (or
    :class:`KafkaError` when ``raise_on_errors=False``).

    ``columnar=True`` is the batch-native mode (docs/performance.md
    "Columnar ingest"): each clean poll enters the dataflow as one
    :class:`~bytewax_tpu_torch.inputs.ColumnarBatch` with raw ``key``/
    ``value`` byte columns and an int64 ``ts`` column (broker
    timestamps, microseconds since epoch) instead of per-message
    dataclasses — no per-row Python on the hot path, and source-lag
    accounting reads the ``ts`` column directly.  Polls carrying
    errors or null keys/values fall back to itemized
    :class:`KafkaSourceMessage`/:class:`KafkaError` batches (the
    protocol allows mixing), so error routing is unchanged; resume
    offsets are identical in both modes.  The
    :mod:`~bytewax_tpu_torch.connectors.kafka.operators` namespace
    deserializes per message and therefore uses itemized mode.

    Connector-edge resilience (docs/recovery.md): transient
    poll-error codes (:data:`TRANSIENT_KAFKA_CODES`, or librdkafka's
    own ``retriable()`` verdict) raise a typed
    :class:`~bytewax_tpu_torch.errors.TransientSourceError` that the engine
    retries at the poll boundary with backoff — and, under
    ``BYTEWAX_TPU_QUARANTINE=1``, quarantines the one failing
    partition after the retry budget while the others keep flowing.
    ``on_error`` picks the non-transient error policy: ``"raise"``
    (default), ``"route"`` (:class:`KafkaError` items flow
    downstream, the legacy ``raise_on_errors=False`` — this mode
    routes EVERY error frame, transient included, preserving the
    legacy stream contract), or ``"dlq"`` (non-transient error
    frames are captured into the engine's dead-letter queue with
    topic/partition/offset provenance and the partition keeps
    flowing; transient frames still take the retry ladder).
    """

    def __init__(
        self,
        brokers: Iterable[str],
        topics: Iterable[str],
        tail: bool = True,
        starting_offset: int = OFFSET_BEGINNING,
        add_config: Optional[Dict[str, str]] = None,
        batch_size: int = 1000,
        raise_on_errors: bool = True,
        columnar: bool = False,
        on_error: Optional[str] = None,
    ):
        if isinstance(brokers, str):
            msg = "pass brokers as a list of addresses, not a single string"
            raise TypeError(msg)
        if isinstance(topics, str):
            msg = "pass topics as a list of names, not a single string"
            raise TypeError(msg)
        if on_error not in (None, "raise", "route", "dlq"):
            msg = (
                f"on_error must be 'raise', 'route', or 'dlq'; "
                f"got {on_error!r}"
            )
            raise ValueError(msg)
        _require_confluent()
        self._brokers = brokers
        self._topics = topics
        self._tail = tail
        self._starting_offset = starting_offset
        self._add_config = dict(add_config or {})
        self._batch_size = batch_size
        # on_error supersedes the legacy raise_on_errors flag; absent,
        # the flag maps onto the equivalent policy.
        self._on_error = on_error or (
            "raise" if raise_on_errors else "route"
        )
        self._columnar = columnar

    def list_parts(self) -> List[str]:
        """Each Kafka partition of each topic is an input partition."""
        from confluent_kafka.admin import AdminClient

        config = {"bootstrap.servers": ",".join(self._brokers)}
        config.update(self._add_config)
        client = AdminClient(config)
        client.poll(0)  # start auth callbacks
        parts = []
        cluster_meta = client.list_topics()
        for topic in self._topics:
            topic_meta = cluster_meta.topics.get(topic)
            if topic_meta is None or not topic_meta.partitions:
                msg = f"no partitions for topic {topic!r}"
                raise RuntimeError(msg)
            for i in topic_meta.partitions.keys():
                parts.append(f"{i}-{topic}")
        return parts

    def build_part(
        self, step_id: str, for_part: str, resume_state: Optional[int]
    ) -> _KafkaSourcePartition:
        idx, topic = for_part.split("-", 1)
        if topic not in self._topics:
            msg = "can't resume from a different set of Kafka topics"
            raise ValueError(msg)
        config = {
            # The recovery system is the consumer group.
            "group.id": "BYTEWAX_IGNORED",
            "enable.auto.commit": "false",
            "bootstrap.servers": ",".join(self._brokers),
            "enable.partition.eof": str(not self._tail),
            "statistics.interval.ms": 1000,
        }
        config.update(self._add_config)
        return _KafkaSourcePartition(
            step_id,
            config,
            topic,
            int(idx),
            self._starting_offset,
            resume_state,
            self._batch_size,
            self._on_error,
            self._columnar,
        )


class _KafkaSinkPartition(
    StatelessSinkPartition[KafkaSinkMessage[Optional[bytes], Optional[bytes]]]
):
    def __init__(self, producer, topic: Optional[str]):
        self._producer = producer
        self._topic = topic

    def write_batch(
        self, items: List[KafkaSinkMessage[Optional[bytes], Optional[bytes]]]
    ) -> None:
        for item in items:
            topic = item.topic if item.topic is not None else self._topic
            if topic is None:
                msg = f"no topic to produce to for {item}"
                raise RuntimeError(msg)
            try:
                self._producer.produce(
                    topic,
                    item.value,
                    item.key,
                    headers=item.headers,
                )
            except BufferError:
                # librdkafka's local produce queue is full: drain
                # deliveries once, then retry this item; a second
                # refusal is a transient sink fault the engine
                # retries at the write boundary with backoff.
                self._producer.poll(0.1)
                try:
                    self._producer.produce(
                        topic,
                        item.value,
                        item.key,
                        headers=item.headers,
                    )
                except BufferError as ex:
                    msg = (
                        "Kafka produce queue stayed full after a "
                        "delivery drain (broker slow or down)"
                    )
                    raise TransientSinkError(msg) from ex
            except Exception as ex:  # noqa: BLE001
                if is_transient_kafka_error(_kafka_error_of(ex)):
                    msg = f"transient Kafka produce failure: {ex}"
                    raise TransientSinkError(msg) from ex
                raise
            self._producer.poll(0)
        self._producer.flush()

    def close(self) -> None:
        self._producer.flush()


class KafkaSink(
    DynamicSink[KafkaSinkMessage[Optional[bytes], Optional[bytes]]]
):
    """Use a single Kafka topic as an output sink; workers are the
    unit of parallelism.  At-least-once: messages from the resume
    epoch are duplicated right after resume.

    Transient produce failures (a full local queue that a delivery
    drain doesn't clear, or a retriable broker code —
    :func:`is_transient_kafka_error`) raise
    :class:`~bytewax_tpu_torch.errors.TransientSinkError`, which the engine
    retries at the write boundary before the epoch commit
    (docs/recovery.md "Connector-edge resilience"); a retried batch
    may re-produce its head, consistent with the sink's
    at-least-once contract."""

    def __init__(
        self,
        brokers: Iterable[str],
        topic: Optional[str],
        add_config: Optional[Dict[str, str]] = None,
    ):
        _require_confluent()
        self._brokers = brokers
        self._topic = topic
        self._add_config = dict(add_config or {})

    def build(
        self, step_id: str, worker_index: int, worker_count: int
    ) -> _KafkaSinkPartition:
        from confluent_kafka import Producer

        config = {"bootstrap.servers": ",".join(self._brokers)}
        config.update(self._add_config)
        return _KafkaSinkPartition(Producer(config), self._topic)

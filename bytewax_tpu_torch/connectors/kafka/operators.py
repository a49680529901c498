"""Operators for the Kafka source and sink.

API parity with the reference
(upstream bytewax ``pysrc/bytewax/connectors/kafka/operators.py``):
``kop.input`` returns split ok/error streams; serde operators
(de)serialize keys/values with a
:class:`~bytewax_tpu_torch.connectors.kafka.serde.SchemaSerializer` /
``SchemaDeserializer``.

```python
import bytewax_tpu_torch.connectors.kafka.operators as kop
```
"""

from dataclasses import dataclass
from typing import Dict, Generic, List, Optional, TypeVar, Union

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.connectors.kafka import (
    OFFSET_BEGINNING,
    KafkaError,
    KafkaSink,
    KafkaSinkMessage,
    KafkaSource,
    KafkaSourceMessage,
)
from bytewax_tpu_torch.connectors.kafka.serde import (
    SchemaDeserializer,
    SchemaSerializer,
)
from bytewax_tpu_torch.dataflow import Dataflow, Stream, operator

X = TypeVar("X")
E = TypeVar("E")
K = TypeVar("K")
V = TypeVar("V")
K2 = TypeVar("K2")
V2 = TypeVar("V2")

__all__ = [
    "KafkaOpOut",
    "deserialize",
    "deserialize_key",
    "deserialize_value",
    "input",
    "output",
    "serialize",
    "serialize_key",
    "serialize_value",
]


@dataclass(frozen=True)
class KafkaOpOut(Generic[X, E]):
    """Split ok/error streams from Kafka operators."""

    oks: Stream[X]
    """Successfully processed items."""

    errs: Stream[E]
    """Errors."""


@operator
def _kafka_error_split(
    step_id: str,
    up: Stream[Union[KafkaSourceMessage, KafkaError]],
) -> KafkaOpOut[KafkaSourceMessage, KafkaError]:
    branch_out = op.branch(
        "branch", up, lambda msg: isinstance(msg, KafkaSourceMessage)
    )
    return KafkaOpOut(branch_out.trues, branch_out.falses)


@operator
def input(  # noqa: A001
    step_id: str,
    flow: Dataflow,
    *,
    brokers: List[str],
    topics: List[str],
    tail: bool = True,
    starting_offset: int = OFFSET_BEGINNING,
    add_config: Optional[Dict[str, str]] = None,
    batch_size: int = 1000,
) -> KafkaOpOut[KafkaSourceMessage, KafkaError]:
    """Consume from Kafka; returns ok and error streams.

    Partitions are the unit of parallelism; exactly-once capable.
    """
    return op.input(
        "kafka_input",
        flow,
        KafkaSource(
            brokers,
            topics,
            tail,
            starting_offset,
            add_config,
            batch_size,
            # Errors are split into the errs stream, not raised.
            raise_on_errors=False,
        ),
    ).then(_kafka_error_split, "split_err")


@operator
def _to_sink(
    step_id: str,
    up: Stream[Union[KafkaSourceMessage, KafkaSinkMessage]],
) -> Stream[KafkaSinkMessage]:
    def shim_mapper(msg):
        if isinstance(msg, KafkaSourceMessage):
            return msg.to_sink()
        return msg

    return op.map("map", up, shim_mapper)


@operator
def output(
    step_id: str,
    up: Stream[Union[KafkaSourceMessage, KafkaSinkMessage]],
    *,
    brokers: List[str],
    topic: str,
    add_config: Optional[Dict[str, str]] = None,
) -> None:
    """Produce to Kafka as an output sink; workers are the unit of
    parallelism, at-least-once delivery."""
    return _to_sink("to_sink", up).then(
        op.output,
        "kafka_output",
        KafkaSink(brokers, topic, add_config),
    )


@operator
def deserialize_key(
    step_id: str,
    up: Stream[KafkaSourceMessage[bytes, V]],
    deserializer: SchemaDeserializer[bytes, K2],
) -> KafkaOpOut[KafkaSourceMessage[K2, V], KafkaError]:
    """Deserialize message keys; failures go to the error stream."""

    def shim_mapper(msg):
        try:
            return msg._with_key(deserializer.de(msg.key))
        except Exception as ex:  # noqa: BLE001
            return KafkaError(ex, msg)

    return op.map("map", up, shim_mapper).then(
        _kafka_error_split, "split"
    )


@operator
def deserialize_value(
    step_id: str,
    up: Stream[KafkaSourceMessage[K, bytes]],
    deserializer: SchemaDeserializer[bytes, V2],
) -> KafkaOpOut[KafkaSourceMessage[K, V2], KafkaError]:
    """Deserialize message values; failures go to the error stream."""

    def shim_mapper(msg):
        try:
            return msg._with_value(deserializer.de(msg.value))
        except Exception as ex:  # noqa: BLE001
            return KafkaError(ex, msg)

    return op.map("map", up, shim_mapper).then(
        _kafka_error_split, "split"
    )


@operator
def deserialize(
    step_id: str,
    up: Stream[KafkaSourceMessage[bytes, bytes]],
    *,
    key_deserializer: SchemaDeserializer[bytes, K2],
    val_deserializer: SchemaDeserializer[bytes, V2],
) -> KafkaOpOut[KafkaSourceMessage[K2, V2], KafkaError]:
    """Deserialize both keys and values; a failure in either sends
    the message to the error stream."""

    def shim_mapper(msg):
        try:
            key = key_deserializer.de(msg.key)
        except Exception as ex:  # noqa: BLE001
            return KafkaError(ex, msg)
        try:
            return msg._with_key_and_value(key, val_deserializer.de(msg.value))
        except Exception as ex:  # noqa: BLE001
            return KafkaError(ex, msg)

    return op.map("map", up, shim_mapper).then(
        _kafka_error_split, "split"
    )


@operator
def serialize_key(
    step_id: str,
    up: Stream[Union[KafkaSourceMessage[K, V], KafkaSinkMessage[K, V]]],
    serializer: SchemaSerializer[K, bytes],
) -> Stream[KafkaSinkMessage[bytes, V]]:
    """Serialize message keys; errors raise and crash the dataflow."""

    def shim_mapper(msg):
        if isinstance(msg, KafkaSourceMessage):
            msg = msg.to_sink()
        return msg._with_key(serializer.ser(msg.key))

    return op.map("map", up, shim_mapper)


@operator
def serialize_value(
    step_id: str,
    up: Stream[Union[KafkaSourceMessage[K, V], KafkaSinkMessage[K, V]]],
    serializer: SchemaSerializer[V, bytes],
) -> Stream[KafkaSinkMessage[K, bytes]]:
    """Serialize message values; errors raise and crash the dataflow."""

    def shim_mapper(msg):
        if isinstance(msg, KafkaSourceMessage):
            msg = msg.to_sink()
        return msg._with_value(serializer.ser(msg.value))

    return op.map("map", up, shim_mapper)


@operator
def serialize(
    step_id: str,
    up: Stream[Union[KafkaSourceMessage[K, V], KafkaSinkMessage[K, V]]],
    *,
    key_serializer: SchemaSerializer[K, bytes],
    val_serializer: SchemaSerializer[V, bytes],
) -> Stream[KafkaSinkMessage[bytes, bytes]]:
    """Serialize both keys and values; errors raise and crash the
    dataflow."""

    def shim_mapper(msg):
        if isinstance(msg, KafkaSourceMessage):
            msg = msg.to_sink()
        return msg._with_key_and_value(
            key_serializer.ser(msg.key), val_serializer.ser(msg.value)
        )

    return op.map("map", up, shim_mapper)

"""The torch port's Kafka connector (``bytewax_tpu_torch.connectors.kafka``),
held to the cases of ``tests/test_kafka.py`` that run without a broker:
the message dataclasses, the optional-dependency gating, the Confluent
wire format and schema registry client, and the cases over the
in-process broker that stands in for ``confluent_kafka``
(``connectors/kafka/inmem.py``).

Only the port's broker is ever installed: ``inmem.installed()`` puts the
port's fake ``confluent_kafka`` modules into ``sys.modules``, and both
packages' ``KafkaSource``/``KafkaSink`` reach that one broker through
``ck.Consumer(config)``/``Producer(config)``.  Each case that runs a
flow runs it through both packages against the same broker and
compares the outputs.  The live-broker round trip stays gated on
``TEST_KAFKA_BROKER``, as in the JAX package.
"""

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

from bytewax_tpu_torch.connectors.kafka import KafkaSinkMessage, KafkaSourceMessage
from bytewax_tpu_torch.utils import force_platform

HAS_CONFLUENT = True
try:
    import confluent_kafka  # noqa: F401
except ImportError:
    HAS_CONFLUENT = False

BROKER = os.environ.get("TEST_KAFKA_BROKER")
PKGS = ("bytewax_tpu", "bytewax_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    saved = os.environ.get("BYTEWAX_TPU_PLATFORM")
    force_platform("cpu")
    yield
    if saved is None:
        os.environ.pop("BYTEWAX_TPU_PLATFORM", None)
    else:
        os.environ["BYTEWAX_TPU_PLATFORM"] = saved


def _pkg(name):
    """One package's flow surface and Kafka modules."""
    testing = importlib.import_module(f"{name}.testing")
    return SimpleNamespace(
        op=importlib.import_module(f"{name}.operators"),
        Dataflow=importlib.import_module(f"{name}.dataflow").Dataflow,
        TestingSink=testing.TestingSink,
        TestingSource=testing.TestingSource,
        run_main=testing.run_main,
        kafka=importlib.import_module(f"{name}.connectors.kafka"),
        kop=importlib.import_module(f"{name}.connectors.kafka.operators"),
        ColumnarBatch=importlib.import_module(f"{name}.inputs").ColumnarBatch,
    )


def _fields(msg):
    """A message or error item of either package as plain values."""
    if type(msg).__name__ == "KafkaError":
        return ("error", str(msg.error), _fields(msg.msg))
    return (msg.key, msg.value, msg.topic, msg.partition, msg.offset, msg.timestamp)


def test_source_message_to_sink():
    src = KafkaSourceMessage(key=b"k", value=b"v", topic="t", offset=3, partition=0)
    sink = src.to_sink()
    assert sink == KafkaSinkMessage(key=b"k", value=b"v", topic="t")


def test_message_with_key_value():
    src = KafkaSourceMessage(key=b"k", value=b"v", offset=7)
    changed = src._with_key_and_value("K", "V")
    assert changed.key == "K"
    assert changed.value == "V"
    assert changed.offset == 7


@pytest.mark.skipif(HAS_CONFLUENT, reason="confluent_kafka installed")
def test_source_requires_confluent():
    from bytewax_tpu_torch.connectors.kafka import KafkaSink, KafkaSource

    with pytest.raises(ImportError, match="confluent_kafka"):
        KafkaSource(["localhost:9092"], ["topic"])
    with pytest.raises(ImportError, match="confluent_kafka"):
        KafkaSink(["localhost:9092"], "topic")


def test_error_split_operator_graph(fake_kafka):
    """``kop.input`` builds its split graph without polling: with the
    in-process broker standing in for ``confluent_kafka`` the graph
    builds here, and both packages give the same steps."""
    steps = {}
    for name in PKGS:
        p = _pkg(name)
        flow = p.Dataflow("split_graph")
        kin = p.kop.input("inp", flow, brokers=["inmem://graph"], topics=["t"], tail=False)
        assert type(kin).__name__ == "KafkaOpOut"
        steps[name] = sorted(s.step_id for s in flow.substeps)
        assert kin.oks.stream_id != kin.errs.stream_id
    assert steps["bytewax_tpu"] == steps["bytewax_tpu_torch"]


def test_serde_avro_gated():
    from bytewax_tpu_torch.connectors.kafka.serde import PlainAvroSerializer

    try:
        import fastavro  # noqa: F401

        has_fastavro = True
    except ImportError:
        has_fastavro = False

    schema = {"type": "record", "name": "T", "fields": [{"name": "x", "type": "long"}]}
    if has_fastavro:
        from bytewax_tpu_torch.connectors.kafka.serde import PlainAvroDeserializer

        ser = PlainAvroSerializer(schema)
        de = PlainAvroDeserializer(schema)
        assert de.de(ser.ser({"x": 42})) == {"x": 42}
    else:
        with pytest.raises(ImportError, match="fastavro"):
            PlainAvroSerializer(schema)


@pytest.mark.skipif(not (HAS_CONFLUENT and BROKER), reason="needs TEST_KAFKA_BROKER")
def test_kafka_roundtrip_live():
    import uuid

    from confluent_kafka.admin import AdminClient, NewTopic

    import bytewax_tpu_torch.operators as op
    from bytewax_tpu_torch.connectors.kafka import KafkaSink, KafkaSource
    from bytewax_tpu_torch.dataflow import Dataflow
    from bytewax_tpu_torch.testing import TestingSink, TestingSource, run_main

    topic = f"pytest_{uuid.uuid4()}"
    admin = AdminClient({"bootstrap.servers": BROKER})
    admin.create_topics([NewTopic(topic, 3)])[topic].result()
    try:
        flow = Dataflow("producer")
        s = op.input("inp", flow, TestingSource([KafkaSinkMessage(key=None, value=b"x", topic=topic)]))
        op.output("out", s, KafkaSink([BROKER], None))
        run_main(flow)

        out = []
        flow2 = Dataflow("consumer")
        s2 = op.input("inp", flow2, KafkaSource([BROKER], [topic], tail=False))
        op.output("out", s2, TestingSink(out))
        run_main(flow2)
        assert [m.value for m in out] == [b"x"]
    finally:
        admin.delete_topics([topic])


def test_confluent_wire_format_roundtrip():
    from bytewax_tpu.connectors.kafka import serde as ref
    from bytewax_tpu_torch.connectors.kafka.serde import confluent_wire_decode, confluent_wire_encode

    framed = confluent_wire_encode(100002, b"\x02\x04payload")
    assert framed == ref.confluent_wire_encode(100002, b"\x02\x04payload")
    assert framed[0] == 0  # magic byte
    schema_id, payload = confluent_wire_decode(framed)
    assert (schema_id, payload) == (100002, b"\x02\x04payload")
    with pytest.raises(ValueError, match="magic"):
        confluent_wire_decode(b"\x01\x00\x00\x00\x01x")
    with pytest.raises(ValueError, match="short"):
        confluent_wire_decode(b"\x00\x00")


def test_schema_registry_client_rest():
    # A minimal Confluent-compatible registry on a local HTTP server;
    # the client must fetch by id, by subject, and register.
    import http.server
    import json
    import threading

    from bytewax_tpu_torch.connectors.kafka.serde import SchemaRegistryClient

    schema = {"type": "record", "name": "r", "fields": []}

    class _Handler(http.server.BaseHTTPRequestHandler):
        def _reply(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/schemas/ids/7":
                self._reply({"schema": json.dumps(schema)})
            elif self.path == "/subjects/sensor-key/versions/latest":
                self._reply({"id": 7, "schema": json.dumps(schema)})
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            length = int(self.headers["Content-Length"])
            json.loads(self.rfile.read(length))  # validate body shape
            self._reply({"id": 9})

        def log_message(self, *args):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        client = SchemaRegistryClient(f"http://127.0.0.1:{srv.server_address[1]}")
        assert client.schema_for_id(7) == schema
        assert client.latest_for_subject("sensor-key") == (7, schema)
        assert client.register("aggregated-value", schema) == 9
        # Cached: a second id fetch must not hit the server.
        srv.shutdown()
        assert client.schema_for_id(7) == schema
    finally:
        srv.shutdown()
        srv.server_close()


# -- the in-process broker ---------------------------------------------------


@pytest.fixture
def fake_kafka():
    """The port's in-process broker installed as ``confluent_kafka``;
    both packages' connectors reach it."""
    from bytewax_tpu_torch.connectors.kafka import inmem

    inmem.reset()
    with inmem.installed():
        yield inmem
    inmem.reset()


def test_inmem_partition_discovery(fake_kafka):
    broker = fake_kafka.broker_for("inmem://disc")
    broker.create_topic("events", partitions=3)
    broker.create_topic("audit", partitions=1)
    for name in PKGS:
        kafka = _pkg(name).kafka
        src = kafka.KafkaSource(["inmem://disc"], ["events", "audit"], tail=False)
        assert sorted(src.list_parts()) == ["0-audit", "0-events", "1-events", "2-events"]
        with pytest.raises(RuntimeError, match="no partitions"):
            kafka.KafkaSource(["inmem://disc"], ["missing"]).list_parts()


def test_inmem_source_flow_and_lag_gauge(fake_kafka):
    broker = fake_kafka.broker_for("inmem://flow")
    broker.create_topic("events", partitions=2)
    for i in range(10):
        broker.produce("events", value=f"v{i}".encode(), key=f"k{i}".encode())

    outs = {}
    for name in PKGS:
        p = _pkg(name)
        out = []
        flow = p.Dataflow("kafka_in")
        s = p.op.input("inp", flow, p.kafka.KafkaSource(["inmem://flow"], ["events"], tail=False))
        p.op.output("out", s, p.TestingSink(out))
        p.run_main(flow)
        outs[name] = sorted(_fields(m) for m in out)

        assert len(out) == 10
        assert {m.value for m in out} == {f"v{i}".encode() for i in range(10)}
        # Offsets are per-partition and contiguous from 0.
        by_part = {}
        for m in out:
            by_part.setdefault(m.partition, []).append(m.offset)
        for offs in by_part.values():
            assert offs == list(range(len(offs)))
        # The stats callback drove the lag gauge for a caught-up consumer.
        for part in by_part:
            lag = p.kafka._CONSUMER_LAG_GAUGE.labels("kafka_in.inp", "events", str(part))._value.get()
            assert lag == 0
    assert outs["bytewax_tpu_torch"] == outs["bytewax_tpu"]


def test_inmem_lag_gauge_reports_backlog(fake_kafka):
    """A consumer resuming mid-log reports a nonzero lag through the
    stats callback (the stats fire before the read, so the gauge shows
    the pre-batch backlog)."""
    broker = fake_kafka.broker_for("inmem://lag")
    broker.create_topic("t", partitions=1)
    for i in range(10):
        broker.produce("t", value=str(i).encode(), partition=0)

    for name in PKGS:
        kafka = _pkg(name).kafka
        src = kafka.KafkaSource(["inmem://lag"], ["t"], tail=False)
        part = src.build_part("lag_step", "0-t", resume_state=4)
        try:
            vals = [m.value for m in part.next_batch()]
            assert len(vals) == 6
            lag = kafka._CONSUMER_LAG_GAUGE.labels("lag_step", "t", "0")._value.get()
            assert lag == 6  # 10 on the log, position 4 at stats time
        finally:
            part.close()


def test_inmem_offset_resume(fake_kafka):
    broker = fake_kafka.broker_for("inmem://resume")
    broker.create_topic("t", partitions=1)
    for i in range(8):
        broker.produce("t", value=str(i).encode(), partition=0)

    for name in PKGS:
        src = _pkg(name).kafka.KafkaSource(["inmem://resume"], ["t"], tail=False)
        part = src.build_part("s", "0-t", resume_state=5)
        try:
            vals = [m.value for m in part.next_batch()]
            assert vals == [b"5", b"6", b"7"]
            # Snapshot points past the last consumed message.
            assert part.snapshot() == 8
            with pytest.raises(StopIteration):
                part.next_batch() and part.next_batch()
        finally:
            part.close()


def test_inmem_sink_source_roundtrip(fake_kafka):
    """Each package produces through its ``KafkaSink`` into a topic of
    its own and reads it back through its ``KafkaSource``: the same
    messages land on the same partitions at the same offsets, and the
    port's source reads the JAX package's topic alike."""
    broker = fake_kafka.broker_for("inmem://rt")
    logs, outs = {}, {}
    for name in PKGS:
        p = _pkg(name)
        topic = f"out_{name}"
        broker.create_topic(topic, partitions=2)
        msgs = [p.kafka.KafkaSinkMessage(key=f"k{i}".encode(), value=f"v{i}".encode()) for i in range(6)]
        flow = p.Dataflow("producer")
        s = p.op.input("inp", flow, p.TestingSource(msgs))
        p.op.output("out", s, p.kafka.KafkaSink(["inmem://rt"], topic))
        p.run_main(flow)

        out = []
        flow2 = p.Dataflow("consumer")
        s2 = p.op.input("inp", flow2, p.kafka.KafkaSource(["inmem://rt"], [topic], tail=False))
        p.op.output("out", s2, p.TestingSink(out))
        p.run_main(flow2)
        assert {(m.key, m.value) for m in out} == {(m.key, m.value) for m in msgs}
        outs[name] = sorted((m.key, m.value, m.partition, m.offset) for m in out)
        logs[name] = [[(m.key(), m.value()) for m in broker.log(topic, i)] for i in range(2)]
    assert outs["bytewax_tpu_torch"] == outs["bytewax_tpu"]
    assert logs["bytewax_tpu_torch"] == logs["bytewax_tpu"]

    p = _pkg("bytewax_tpu_torch")
    out = []
    flow = p.Dataflow("cross_consumer")
    s = p.op.input("inp", flow, p.kafka.KafkaSource(["inmem://rt"], ["out_bytewax_tpu"], tail=False))
    p.op.output("out", s, p.TestingSink(out))
    p.run_main(flow)
    assert sorted((m.key, m.value, m.partition, m.offset) for m in out) == outs["bytewax_tpu"]


def test_inmem_error_routing(fake_kafka):
    broker = fake_kafka.broker_for("inmem://err")
    broker.create_topic("t", partitions=1)
    broker.produce("t", value=b"ok", partition=0)
    broker.inject_error("t", 0, code=-195, reason="broker transport failure")
    broker.produce("t", value=b"after", partition=0)
    broker2 = fake_kafka.broker_for("inmem://err-fatal")
    broker2.create_topic("t", partitions=1)
    broker2.produce("t", value=b"ok", partition=0)
    broker2.inject_error("t", 0, code=1, reason="offset out of range")

    outs = {}
    for name in PKGS:
        p = _pkg(name)
        # raise_on_errors=False: the error rides the stream as KafkaError.
        out = []
        flow = p.Dataflow("tolerant")
        src = p.kafka.KafkaSource(["inmem://err"], ["t"], tail=False, raise_on_errors=False)
        s = p.op.input("inp", flow, src)
        p.op.output("out", s, p.TestingSink(out))
        p.run_main(flow)
        kinds = [type(m).__name__ for m in out]
        assert kinds == ["KafkaSourceMessage", "KafkaError", "KafkaSourceMessage"]
        assert "transport failure" in str(out[1].error)

        # raise_on_errors=True (default): a transient broker error is
        # retried at the poll boundary and every message still lands.
        out2 = []
        flow2 = p.Dataflow("strict")
        s2 = p.op.input("inp2", flow2, p.kafka.KafkaSource(["inmem://err"], ["t"], tail=False))
        p.op.output("out", s2, p.TestingSink(out2))
        p.run_main(flow2)
        assert [m.value for m in out2] == [b"ok", b"after"]
        outs[name] = ([_fields(m) for m in out], [_fields(m) for m in out2])

        # A non-transient broker error fails the step with it.
        flow3 = p.Dataflow("strict_fatal")
        s3 = p.op.input("inp3", flow3, p.kafka.KafkaSource(["inmem://err-fatal"], ["t"], tail=False))
        p.op.output("out", s3, p.TestingSink([]))
        with pytest.raises(RuntimeError, match="error consuming"):
            p.run_main(flow3)
    assert outs["bytewax_tpu_torch"] == outs["bytewax_tpu"]


def test_inmem_operators_input_split(fake_kafka):
    """``kop.input`` splits oks and errors over the real transport
    surface."""
    broker = fake_kafka.broker_for("inmem://ops")
    broker.create_topic("t", partitions=1)
    broker.produce("t", value=b"x", key=b"a", partition=0)
    broker.inject_error("t", 0, code=-1, reason="boom")

    outs = {}
    for name in PKGS:
        p = _pkg(name)
        oks, errs = [], []
        flow = p.Dataflow("split")
        kin = p.kop.input("inp", flow, brokers=["inmem://ops"], topics=["t"], tail=False)
        p.op.output("oks", kin.oks, p.TestingSink(oks))
        p.op.output("errs", kin.errs, p.TestingSink(errs))
        p.run_main(flow)
        assert [m.value for m in oks] == [b"x"]
        assert len(errs) == 1 and "boom" in str(errs[0].error)
        outs[name] = ([_fields(m) for m in oks], [_fields(m) for m in errs])
    assert outs["bytewax_tpu_torch"] == outs["bytewax_tpu"]


def _cols(batch):
    return {name: np.asarray(col).tolist() for name, col in batch.cols.items()}


def test_inmem_source_columnar(fake_kafka):
    """``columnar=True`` emits key/value/ts columns off a clean poll,
    keeps resume offsets exact, and falls back to the itemized path when
    a message has a null field; both packages give the same columns."""
    broker = fake_kafka.broker_for("inmem://col")
    broker.create_topic("t", partitions=1)
    for i in range(6):
        broker.produce("t", value=f"v{i}".encode(), key=f"k{i}".encode(), partition=0)
    broker.produce("t", value=b"tombstone", key=None, partition=0)

    got = {}
    for name in PKGS:
        p = _pkg(name)
        src = p.kafka.KafkaSource(["inmem://col"], ["t"], tail=False, columnar=True, batch_size=4)
        part = src.build_part("s", "0-t", resume_state=2)
        try:
            batch = part.next_batch()
            assert isinstance(batch, p.ColumnarBatch)
            assert batch.cols["key"].tolist() == [b"k2", b"k3", b"k4", b"k5"]
            assert batch.cols["value"].tolist() == [b"v2", b"v3", b"v4", b"v5"]
            if "ts" in batch.cols:
                assert np.issubdtype(batch.cols["ts"].dtype, np.integer)
            # Snapshot points past the last consumed message, as the
            # itemized reader's.
            assert part.snapshot() == 6
            fallback = part.next_batch()
            assert not isinstance(fallback, p.ColumnarBatch)  # itemized fallback
            assert [m.value for m in fallback] == [b"tombstone"]
            assert part.snapshot() == 7
            got[name] = (_cols(batch), [_fields(m) for m in fallback])
        finally:
            part.close()
    assert got["bytewax_tpu_torch"] == got["bytewax_tpu"]


def test_inmem_source_columnar_nul_bytes_fall_back(fake_kafka):
    """Payloads ending in NUL bytes take the itemized path: numpy ``S``
    columns drop trailing NULs, so the columnar format would corrupt
    e.g. fixed-width binary encodings."""
    broker = fake_kafka.broker_for("inmem://nul")
    broker.create_topic("t", partitions=1)
    broker.produce("t", value=b"abc\x00", key=b"k0", partition=0)
    broker.produce("t", value=b"v1", key=b"k1", partition=0)

    got = {}
    for name in PKGS:
        p = _pkg(name)
        src = p.kafka.KafkaSource(["inmem://nul"], ["t"], tail=False, columnar=True)
        part = src.build_part("s", "0-t", resume_state=None)
        try:
            batch = part.next_batch()
            assert not isinstance(batch, p.ColumnarBatch)  # itemized fallback
            assert [m.value for m in batch] == [b"abc\x00", b"v1"]
            got[name] = [_fields(m) for m in batch]
        finally:
            part.close()
    assert got["bytewax_tpu_torch"] == got["bytewax_tpu"]


def test_inmem_columnar_flow_folds_like_the_reference(fake_kafka, monkeypatch):
    """The columnar source feeding a keyed aggregation on the device
    tier (the CPU here): the value column decoded to float32 with numpy,
    then ``xla.stats_final``, through both packages on the same
    messages."""
    monkeypatch.setenv("BYTEWAX_TPU_SHARD", "0")  # the JAX package on one device
    broker = fake_kafka.broker_for("inmem://fold")
    broker.create_topic("temps", partitions=3)
    rng = np.random.RandomState(3)
    stations = [f"st{i:02d}" for i in range(23)]
    for i in range(1500):
        deci = int(rng.randint(-999, 1000))
        broker.produce("temps", key=stations[i % 23].encode(), value=f"{deci / 10:.1f}".encode())

    outs = {}
    for name in PKGS:
        p = _pkg(name)
        xla = importlib.import_module(f"{name}.xla")
        arrays = importlib.import_module(f"{name}.engine.arrays")

        def decode(batch, arrays=arrays):
            cols = {"key": batch.cols["key"].astype("U"), "value": batch.cols["value"].astype(np.float32)}
            return arrays.ArrayBatch(cols)

        out = []
        flow = p.Dataflow("kafka_fold")
        s = p.op.input("inp", flow, p.kafka.KafkaSource(["inmem://fold"], ["temps"], tail=False, columnar=True))
        s = p.op.flat_map_batch("decode", s, decode)
        s = xla.stats_final("stats", s)
        p.op.output("out", s, p.TestingSink(out))
        p.run_main(flow)
        outs[name] = dict(out)
    port, ref = outs["bytewax_tpu_torch"], outs["bytewax_tpu"]
    assert sorted(port) == sorted(ref) == sorted(stations)
    for k, (mn, mean, mx, count) in ref.items():
        pmn, pmean, pmx, pcount = port[k]
        assert (pmn, pmx, pcount) == (mn, mx, count)
        assert pmean == pytest.approx(mean, rel=1e-5, abs=1e-5)

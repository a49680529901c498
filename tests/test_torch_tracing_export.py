"""The torch port's tracing exporter (``tracing.py``) held against the
JAX package: a stub OTLP/HTTP collector on the loopback receives the
``ExportTraceServiceRequest`` documents of both packages' built-in
exporters, and the two packages' spans must agree in service name,
span names, attributes, ancestry and sampling (the cases of
``tests/test_tracing_export.py``).  The one difference is the
instrumentation scope's name, which is each package's own.
"""

import http.server
import json
import threading

import pytest

from tests.test_torch_both import (  # noqa: F401
    BOTH,
    both,
    fresh_faults,
    port_on_cpu,
    unsharded,
)


class _Collector:
    """Minimal OTLP/HTTP collector: records every POST /v1/traces."""

    def __init__(self):
        self.requests = []
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers["Content-Length"])
                outer.requests.append((self.path, json.loads(self.rfile.read(length))))
                body = b"{}"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._srv = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def spans(self):
        out = []
        for _path, doc in self.requests:
            for rs in doc["resourceSpans"]:
                service = next(
                    a["value"]["stringValue"]
                    for a in rs["resource"]["attributes"]
                    if a["key"] == "service.name"
                )
                for ss in rs["scopeSpans"]:
                    for sp in ss["spans"]:
                        out.append((service, sp))
        return out

    def scopes(self):
        return {
            ss["scope"]["name"]
            for _path, doc in self.requests
            for rs in doc["resourceSpans"]
            for ss in rs["scopeSpans"]
        }

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


def _traced(m, run):
    """Runs ``run(m, collector)`` against a collector of its own and
    returns the collector; the package's tracer is restored after."""
    c = _Collector()
    prev = m.tracing._tracer
    try:
        run(m, c)
    finally:
        c.close()
        if m.tracing._tracer is not None and m.tracing._tracer is not prev:
            m.tracing._tracer.shutdown()
        m.tracing._tracer = prev
    return c


def _attrs(sp):
    return {a["key"]: a["value"]["stringValue"] for a in sp.get("attributes", [])}


def _tree(spans):
    """Spans as (name, attributes, parent's name) sorted: the shape
    of the traces without their ids and times."""
    by_id = {sp["spanId"]: sp for _s, sp in spans}
    out = []
    for svc, sp in spans:
        parent = by_id.get(sp.get("parentSpanId"))
        if sp.get("parentSpanId"):
            assert parent is not None and parent["traceId"] == sp["traceId"]
        out.append((svc, sp["name"], sorted(_attrs(sp).items()),
                    parent["name"] if parent else None))
    return sorted(out)


def test_otlp_http_export_service_and_attrs():
    def run(m, c):
        guard = m.tracing.setup_tracing(
            m.tracing.OtlpTracingConfig(service_name="svc-under-test", url=c.url)
        )
        assert m.tracing.spans_active()
        with m.tracing.span("epoch_close", epoch=3):
            with m.tracing.span("operator", step_id="df.map"):
                pass
        guard.shutdown()

    cs = [_traced(m, run) for m in BOTH]
    trees = [_tree(c.spans()) for c in cs]
    assert trees[1] == trees[0]
    assert [c.scopes() for c in cs] == [{"bytewax_tpu"}, {"bytewax_tpu_torch"}]
    got = cs[1].spans()
    by_name = {sp["name"]: sp for _svc, sp in got}
    assert set(by_name) == {"epoch_close", "operator"}
    assert {svc for svc, _sp in got} == {"svc-under-test"}
    assert _attrs(by_name["epoch_close"])["epoch"] == "3"
    assert _attrs(by_name["operator"])["step_id"] == "df.map"
    root, child = by_name["epoch_close"], by_name["operator"]
    assert child["traceId"] == root["traceId"]
    assert child["parentSpanId"] == root["spanId"]
    assert "parentSpanId" not in root
    assert int(root["endTimeUnixNano"]) >= int(root["startTimeUnixNano"])


def test_jaeger_config_otlp_http():
    def run(m, c):
        guard = m.tracing.setup_tracing(
            m.tracing.JaegerConfig(service_name="jaeger-svc", endpoint=c.url)
        )
        with m.tracing.span("flush"):
            pass
        guard.shutdown()

    cs = [_traced(m, run) for m in BOTH]
    for c in cs:
        got = c.spans()
        assert {svc for svc, _sp in got} == {"jaeger-svc"}
        assert [sp["name"] for _svc, sp in got] == ["flush"]
        assert c.requests[0][0] == "/v1/traces"


def test_sampling_ratio_zero_drops_all():
    def run(m, c):
        guard = m.tracing.setup_tracing(
            m.tracing.OtlpTracingConfig(service_name="svc", url=c.url, sampling_ratio=0.0)
        )
        for _ in range(20):
            with m.tracing.span("never"):
                pass
        guard.shutdown()

    assert [_traced(m, run).spans() for m in BOTH] == [[], []]


def test_sampling_is_per_trace():
    def run(m, c):
        guard = m.tracing.setup_tracing(
            m.tracing.OtlpTracingConfig(service_name="svc", url=c.url, sampling_ratio=0.5)
        )
        for _ in range(40):
            with m.tracing.span("root"):
                with m.tracing.span("child"):
                    pass
        guard.shutdown()

    for m in BOTH:
        got = _traced(m, run).spans()
        roots = [sp for _s, sp in got if sp["name"] == "root"]
        children = [sp for _s, sp in got if sp["name"] == "child"]
        assert len(roots) == len(children)
        root_traces = {sp["traceId"] for sp in roots}
        assert all(sp["traceId"] in root_traces for sp in children)
        assert 5 <= len(roots) <= 35


def test_dataflow_emits_operator_spans():
    outs = {}

    def run(m, c):
        guard = m.tracing.setup_tracing(
            m.tracing.OtlpTracingConfig(service_name="df-svc", url=c.url)
        )
        out = outs[m.label] = []
        flow = m.Dataflow("traced")
        s = m.op.input("inp", flow, m.TestingSource([1, 2, 3]))
        s = m.op.map("double", s, lambda x: x * 2)
        m.op.output("out", s, m.TestingSink(out))
        m.run_main(flow)
        guard.shutdown()

    names, step_ids = [], []
    for m in BOTH:
        spans = _traced(m, run).spans()
        names.append({sp["name"] for _svc, sp in spans})
        step_ids.append({
            _attrs(sp).get("step_id") for _svc, sp in spans if sp["name"] == "operator"
        })
    assert outs["torch"] == outs["jax"] == [2, 4, 6]
    assert names[1] == names[0]
    assert {"epoch_close", "operator"} <= names[1]
    assert step_ids[1] == step_ids[0]
    assert any(s and "double" in s for s in step_ids[1])


def test_grpc_url_without_sdk_raises_clearly():
    try:
        import opentelemetry.sdk  # noqa: F401

        pytest.skip("opentelemetry-sdk installed")
    except ImportError:
        pass

    def case(m):
        with pytest.raises(ImportError, match="http") as info:
            m.tracing.setup_tracing(
                m.tracing.OtlpTracingConfig(service_name="svc", url="grpc://127.0.0.1:4317")
            )
        return str(info.value)

    want, got = both(case)
    assert got.replace("bytewax_tpu_torch", "bytewax_tpu") == want

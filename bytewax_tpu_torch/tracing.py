"""Logging and tracing configuration.

Surface parity with the reference (upstream bytewax ``src/tracing/``):
``setup_tracing(tracing_config, log_level)`` returns a guard that
keeps exporters alive.  The default backend logs spans via
:mod:`logging`; :class:`OtlpTracingConfig` / :class:`JaegerConfig`
export spans to a collector.

Export transports, in preference order:

- the ``opentelemetry`` SDK when installed (gRPC OTLP / the Jaeger
  thrift agent — optional dependencies);
- with the SDK absent, a built-in OTLP/HTTP+JSON exporter (pure
  stdlib) for ``http(s)://`` endpoints:
  real ``ExportTraceServiceRequest`` JSON POSTed to
  ``/v1/traces``, batched on a background flush with head sampling by
  ``sampling_ratio`` — any OTLP-ingesting collector (an OpenTelemetry
  Collector, Jaeger ≥1.35, Tempo, ...) accepts it.  This is what runs
  in environments without the optional SDK, and what the stub-collector
  tests pin (``tests/test_tracing_export.py``).
"""

import contextlib
import contextvars
import json as _json
import logging
import random
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

__all__ = [
    "BytewaxTracer",
    "JaegerConfig",
    "OtlpTracingConfig",
    "TracingConfig",
    "setup_tracing",
    "span",
    "spans_active",
]

logger = logging.getLogger("bytewax_tpu_torch")


@dataclass
class TracingConfig:
    """Base config class for tracing backends; logs spans locally."""


@dataclass
class OtlpTracingConfig(TracingConfig):
    """Send traces to an OTLP-over-gRPC collector.

    :arg service_name: Service name to report.
    :arg url: Collector endpoint; defaults to grpc://127.0.0.1:4317.
    :arg sampling_ratio: Fraction of traces to sample, 0.0..1.0.
    """

    service_name: str
    url: str = "grpc://127.0.0.1:4317"
    sampling_ratio: float = 1.0


@dataclass
class JaegerConfig(TracingConfig):
    """Send traces to a Jaeger agent.

    :arg service_name: Service name to report.
    :arg endpoint: Agent address; defaults to 127.0.0.1:6831.
    :arg sampling_ratio: Fraction of traces to sample, 0.0..1.0.
    """

    service_name: str
    endpoint: str = "127.0.0.1:6831"
    sampling_ratio: float = 1.0


class BytewaxTracer:
    """Guard returned by :func:`setup_tracing`; keeps the exporter
    alive until dropped."""

    def __init__(
        self, config: Optional[TracingConfig], provider=None, inline=None
    ):
        self._config = config
        self._provider = provider
        self._inline = inline

    def shutdown(self) -> None:
        if self._provider is not None:
            self._provider.shutdown()
            self._provider = None
        if self._inline is not None:
            self._inline.shutdown()
            self._inline = None


#: (trace_id, span_id, sampled) ancestry of the active inline span.
_span_stack: contextvars.ContextVar[Tuple] = contextvars.ContextVar(
    "bytewax_tpu_span_stack", default=()
)


class _InlineOtlpExporter:
    """Pure-stdlib OTLP/HTTP+JSON span exporter.

    Spans batch in memory and POST as one
    ``ExportTraceServiceRequest`` JSON document per flush (size- or
    shutdown-triggered, plus a background timer) to the collector's
    ``/v1/traces``.  Head sampling: the root span of each trace draws
    against ``sampling_ratio`` and its descendants inherit the
    decision, so traces arrive whole or not at all.  Export failures
    are logged at DEBUG and never disturb the dataflow.
    """

    BATCH = 64
    FLUSH_S = 2.0
    #: Buffer cap: beyond this, oldest spans drop (export is
    #: best-effort; a wedged collector must not grow memory).
    MAX_BUFFERED = 4096

    def __init__(self, service_name: str, url: str, ratio: float):
        # Bare collector endpoints (no path, or just "/") get the
        # standard OTLP traces path appended; explicit paths are kept.
        rest = url.split("://", 1)[1] if "://" in url else url
        _host, slash, path = rest.partition("/")
        if not slash or not path:
            url = url.rstrip("/") + "/v1/traces"
        self.url = url
        self.service_name = service_name
        self.ratio = float(ratio)
        self._buf: List[dict] = []
        self._lock = threading.Lock()
        self._rng = random.Random()
        self._closed = False
        self._flushing = False
        self._warned = False
        self._timer: Optional[threading.Timer] = None
        self._arm_timer()

    def _arm_timer(self) -> None:
        if self._closed:
            return
        self._timer = threading.Timer(self.FLUSH_S, self._on_timer)
        self._timer.daemon = True
        self._timer.start()

    def _on_timer(self) -> None:
        self.flush()
        self._arm_timer()

    def sample_root(self) -> bool:
        return self._rng.random() < self.ratio

    def on_span_end(self, span: dict) -> None:
        with self._lock:
            self._buf.append(span)
            if len(self._buf) > self.MAX_BUFFERED:
                # Oldest-first drop: a slow/wedged collector bounds
                # memory, not the pipeline.
                dropped = len(self._buf) - self.MAX_BUFFERED
                del self._buf[:dropped]
                logger.debug(
                    "OTLP buffer full; dropped %d oldest spans", dropped
                )
            full = len(self._buf) >= self.BATCH
            kick = full and not self._flushing
            if kick:
                self._flushing = True
        if kick:
            # Export off the span-ending thread: a slow collector
            # must never stall the dataflow hot loop.
            threading.Thread(
                target=self._flush_async, daemon=True
            ).start()

    def _flush_async(self) -> None:
        try:
            self.flush()
        finally:
            with self._lock:
                self._flushing = False

    def _payload(self, spans: List[dict]) -> bytes:
        doc = {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            {
                                "key": "service.name",
                                "value": {
                                    "stringValue": self.service_name
                                },
                            }
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "bytewax_tpu_torch"},
                            "spans": spans,
                        }
                    ],
                }
            ]
        }
        return _json.dumps(doc).encode("utf-8")

    def flush(self) -> None:
        with self._lock:
            spans, self._buf = self._buf, []
        if not spans:
            return
        req = urllib.request.Request(
            self.url,
            data=self._payload(spans),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
        except Exception as ex:  # noqa: BLE001 — telemetry must not kill flows
            # First failure is VISIBLE (a misconfigured collector
            # must not silently eat all telemetry); repeats at DEBUG.
            log = logger.debug if self._warned else logger.warning
            self._warned = True
            log("OTLP export to %s failed: %s", self.url, ex)

    def shutdown(self) -> None:
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()
        self.flush()


_tracer: Optional[BytewaxTracer] = None


def setup_tracing(
    tracing_config: Optional[TracingConfig] = None,
    log_level: Optional[str] = None,
) -> BytewaxTracer:
    """Set up logging and tracing; call once, keep the returned guard
    alive for the duration of the dataflow.

    :arg tracing_config: Backend config; ``None`` logs locally.
    :arg log_level: One of DEBUG/INFO/WARN/ERROR; defaults to ERROR
        (reference default: ``src/tracing/mod.rs``).
    """
    global _tracer
    level = getattr(logging, (log_level or "ERROR").upper(), logging.ERROR)
    logging.basicConfig()
    logger.setLevel(level)

    provider = None
    inline = None
    if isinstance(tracing_config, (OtlpTracingConfig, JaegerConfig)):
        if isinstance(tracing_config, OtlpTracingConfig):
            endpoint = tracing_config.url
        else:
            endpoint = tracing_config.endpoint
        # Transport selection is by protocol, deterministically: an
        # http(s):// endpoint speaks OTLP/HTTP (the built-in
        # exporter; for Jaeger: the collector's native OTLP
        # ingestion, Jaeger ≥1.35) — EXCEPT the registered OTLP/gRPC
        # port 4317 with no path, the ecosystem's conventional
        # spelling for a gRPC endpoint (OTEL_EXPORTER_OTLP_ENDPOINT),
        # which routes to the SDK's gRPC exporter.  grpc:// is the
        # config default.
        is_http = endpoint.startswith(("http://", "https://"))
        if is_http:
            rest = endpoint.split("://", 1)[1]
            hostport, _slash, path = rest.partition("/")
            if hostport.endswith(":4317") and not path:
                is_http = False
        if is_http:
            inline = _InlineOtlpExporter(
                tracing_config.service_name,
                endpoint,
                tracing_config.sampling_ratio,
            )
            _tracer = BytewaxTracer(tracing_config, None, inline)
            return _tracer
        try:
            from opentelemetry import trace as ot_trace
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import BatchSpanProcessor

            if isinstance(tracing_config, OtlpTracingConfig):
                from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                    OTLPSpanExporter,
                )
            else:
                from opentelemetry.exporter.jaeger.thrift import (
                    JaegerExporter,
                )
        except ImportError as ex:
            msg = (
                "exporting traces over gRPC/thrift requires the "
                "`opentelemetry-sdk` package (plus the matching "
                "exporter package); install them, or point the config "
                "at an http(s):// OTLP endpoint to use the built-in "
                "OTLP/HTTP exporter"
            )
            raise ImportError(msg) from ex
        resource = Resource.create(
            {"service.name": tracing_config.service_name}
        )
        provider = TracerProvider(resource=resource)
        if isinstance(tracing_config, OtlpTracingConfig):
            exporter = OTLPSpanExporter(endpoint=tracing_config.url)
        else:
            host, _, port = tracing_config.endpoint.partition(":")
            exporter = JaegerExporter(
                agent_host_name=host, agent_port=int(port or 6831)
            )
        provider.add_span_processor(BatchSpanProcessor(exporter))
        ot_trace.set_tracer_provider(provider)

    _tracer = BytewaxTracer(tracing_config, provider, inline)
    return _tracer


def spans_active() -> bool:
    """Whether spans currently go anywhere (an exporting backend is
    configured, or local DEBUG logging is on) — callers on hot paths
    check this once instead of paying the span plumbing per call."""
    if _tracer is not None and (
        _tracer._provider is not None or _tracer._inline is not None
    ):
        return True
    return logger.isEnabledFor(logging.DEBUG)


@contextlib.contextmanager
def _inline_span(exporter: _InlineOtlpExporter, name: str, attrs) -> Iterator[None]:
    stack = _span_stack.get()
    if stack:
        trace_id, parent_id, sampled = stack[-1]
    else:
        trace_id = f"{random.getrandbits(128):032x}"
        parent_id = None
        sampled = exporter.sample_root()
    span_id = f"{random.getrandbits(64):016x}"
    token = _span_stack.set(stack + ((trace_id, span_id, sampled),))
    start_ns = time.time_ns()
    try:
        yield
    finally:
        end_ns = time.time_ns()
        _span_stack.reset(token)
        if sampled:
            rec = {
                "traceId": trace_id,
                "spanId": span_id,
                "name": name,
                "kind": 1,
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(end_ns),
                "attributes": [
                    {"key": k, "value": {"stringValue": str(v)}}
                    for k, v in attrs.items()
                ],
            }
            if parent_id is not None:
                rec["parentSpanId"] = parent_id
            exporter.on_span_end(rec)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Trace a span: exported via the configured backend, or logged at
    DEBUG locally.

    >>> from bytewax_tpu_torch.tracing import span
    >>> with span("compute", step_id="flow.map"):
    ...     total = sum(range(10))
    >>> total
    45
    """
    if _tracer is not None and _tracer._provider is not None:
        from opentelemetry import trace as ot_trace

        tracer = ot_trace.get_tracer("bytewax_tpu_torch")
        with tracer.start_as_current_span(name, attributes=attrs):
            yield
        return
    if _tracer is not None and _tracer._inline is not None:
        with _inline_span(_tracer._inline, name, attrs):
            yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        logger.debug(
            "span %s %s took %.6fs", name, attrs, time.perf_counter() - start
        )

"""Dataflow API webserver.

Reference parity (upstream bytewax ``src/webserver/mod.rs``): when
``BYTEWAX_DATAFLOW_API_ENABLED`` is set, the engine serves

- ``GET /dataflow`` — the graph rendered as JSON (also dumped to
  ``dataflow.json`` on startup, like the reference),
- ``GET /metrics`` — Prometheus text exposition (engine + user
  metrics share one Python registry here, so no merge step is
  needed), and
- ``GET /status`` — a live JSON snapshot of the engine (current
  epoch, per-step queue depths, the epoch ledger, the flight-recorder
  tail, and — in clustered runs — the per-process summaries collected
  by the epoch-close gsync piggyback, so any process's ``/status``
  shows the whole cluster),
- ``GET /graph`` — the lowered dataflow topology (steps, edges, the
  host/device/collective tier per step) annotated with the flow-map's
  live per-step/per-edge telemetry (docs/observability.md "Flow
  map"); in clustered runs every process's rates/lags merge in via
  the same epoch-close gsync piggyback as ``/status``,
- ``GET /healthz`` — liveness (the server answering at all) +
  readiness (HTTP 200 once run startup — mesh handshake, the "fcfg"
  agreement round, any rescale migration, runtime builds — finished;
  503 before that; connection refused while starting up or sleeping
  out a restart backoff; 503 with ``"state": "draining"`` once a
  graceful stop is requested, so probes stop routing new work to a
  winding-down cluster).  Wire it to k8s liveness/readiness probes
  (docs/deployment.md),
- ``POST /stop`` — request a cooperative drain-to-stop
  (docs/recovery.md "Graceful drain-to-stop"): the flow commits the
  in-flight epoch at the next close and exits with a typed
  ``GracefulStop`` status; any one process's ``/stop`` stops the
  whole cluster via the epoch-close sync round,
- ``POST /reconfigure`` — request a live cluster membership change
  (docs/recovery.md "Live partial rescale"): body
  ``{"addresses": [...], "workers_per_process": N?}`` records the
  pending target; once EVERY process carries the same target the
  change agrees at an epoch close and each process rebuilds (or
  retires) at the run-startup re-entry point without leaving the
  process.  Same loopback-only guard as ``/stop``
  (``BYTEWAX_TPU_ALLOW_REMOTE_STOP``),
- ``POST /model`` — request a hot swap of an ``op.infer`` step's
  broadcast params (docs/inference.md): body
  ``{"params": <pytree of numbers/nested lists>, "step_id": "..."?}``
  records the pending update; it commits on every worker at the next
  cluster-agreed epoch close (the params never cross the mesh — post
  the same body to every process).  Same loopback-only guard as
  ``/stop``, and
- ``GET /stacks`` — a ``faulthandler``-style plain-text dump of every
  thread's current Python stack (main loop, pipeline workers, comm),
  for diagnosing a hung barrier without attaching py-spy.

Bind host comes from ``BYTEWAX_DATAFLOW_API_HOST`` (default
``127.0.0.1`` — the status plane is operational introspection, not a
public surface; opt into ``0.0.0.0`` explicitly).  Port comes from
``BYTEWAX_DATAFLOW_API_PORT`` (default 3030), offset by the process's
rank among cluster processes sharing its host, so co-located
processes (localhost testing) don't collide while one-process-per-
host deployments keep the configured port on every pod.
"""

import json
import logging
import os
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

__all__ = ["maybe_start_server", "thread_stacks"]

logger = logging.getLogger("bytewax_tpu_torch")

_DEFAULT_PORT = 3030
_DEFAULT_HOST = "127.0.0.1"


def thread_stacks() -> str:
    """A ``faulthandler``-style dump of every thread's current Python
    stack — the main run loop, pipeline workers, the comm layer —
    so a hung barrier is diagnosable over HTTP without py-spy."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(
            f"Thread {names.get(tid, '<unknown>')} (ident {tid}):\n"
            + "".join(traceback.format_stack(frame))
        )
    return "\n".join(out)


class _Handler(BaseHTTPRequestHandler):
    flow_json: str = "{}"
    status_fn: Optional[Callable[[], dict]] = None
    graph_fn: Optional[Callable[[], dict]] = None
    health_fn: Optional[Callable[[], dict]] = None
    stop_fn: Optional[Callable[[], None]] = None
    reconfigure_fn: Optional[Callable[[list, Optional[int]], None]] = None
    model_fn: Optional[Callable[..., str]] = None

    def _respond_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:  # noqa: N802
        if self.path == "/stop" and type(self).stop_fn is not None:
            # Cooperative drain-to-stop (docs/recovery.md): flag the
            # run loop and acknowledge; the flow stops at the next
            # epoch close, so the response races the exit
            # deliberately — the caller polls /healthz (``draining``)
            # or waits for the process to finish.
            try:
                type(self).stop_fn()
                self._respond_json(200, {"stopping": True})
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                self._respond_json(
                    500, {"stopping": False, "error": str(ex)}
                )
            return
        if (
            self.path == "/reconfigure"
            and type(self).reconfigure_fn is not None
        ):
            # Live membership change (docs/recovery.md "Live partial
            # rescale"): record the pending target; the run loop
            # proposes it on the next epoch-close sync round and the
            # move happens once every process carries the same
            # target.  Body: {"addresses": [...],
            # "workers_per_process": N?}.
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                addresses = req.get("addresses")
                if not isinstance(addresses, list):
                    msg = "body must carry an 'addresses' list"
                    raise ValueError(msg)
                wpp = req.get("workers_per_process")
                type(self).reconfigure_fn(
                    [str(a) for a in addresses],
                    int(wpp) if wpp is not None else None,
                )
                self._respond_json(200, {"reconfiguring": True})
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                self._respond_json(
                    400, {"reconfiguring": False, "error": str(ex)}
                )
            return
        if self.path == "/model" and type(self).model_fn is not None:
            # Broadcast-params hot swap (docs/inference.md): record
            # the pending update; it commits on every worker at the
            # next cluster-agreed epoch close.  Body:
            # {"params": <pytree of numbers/nested lists>,
            #  "step_id": "..."?}.
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if "params" not in req:
                    msg = "body must carry a 'params' pytree"
                    raise ValueError(msg)
                step_id = req.get("step_id")
                digest = type(self).model_fn(
                    req["params"],
                    str(step_id) if step_id is not None else None,
                )
                self._respond_json(
                    200, {"accepted": True, "digest": digest}
                )
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                self._respond_json(
                    400, {"accepted": False, "error": str(ex)}
                )
            return
        self.send_response(404)
        self.end_headers()

    def do_GET(self) -> None:  # noqa: N802
        code = 200
        if self.path == "/dataflow":
            body = self.flow_json.encode()
            ctype = "application/json"
        elif self.path == "/metrics":
            from bytewax_tpu_torch._metrics import generate_python_metrics

            body = generate_python_metrics().encode()
            ctype = "text/plain; version=0.0.4"
        elif self.path == "/status":
            from bytewax_tpu_torch.engine.flight import _json_safe

            fn = type(self).status_fn
            try:
                status = fn() if fn is not None else {}
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                status = {"error": str(ex)}
            # JSON-safe by construction: engine snapshots carry numpy
            # scalars/arrays and datetime64 values straight out of the
            # runtimes.
            body = json.dumps(_json_safe(status)).encode()
            ctype = "application/json"
        elif self.path == "/graph":
            from bytewax_tpu_torch.engine.flight import _json_safe

            fn = type(self).graph_fn
            try:
                graph = fn() if fn is not None else {}
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                graph = {"error": str(ex)}
            body = json.dumps(_json_safe(graph)).encode()
            ctype = "application/json"
        elif self.path == "/healthz":
            fn = type(self).health_fn
            try:
                health = fn() if fn is not None else {"ready": True}
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                health = {"ready": False, "error": str(ex)}
            health = {"live": True, **health}
            # k8s readiness probes read the status code, not the body.
            code = 200 if health.get("ready") else 503
            body = json.dumps(health).encode()
            ctype = "application/json"
        elif self.path == "/stacks":
            try:
                body = thread_stacks().encode()
            except Exception as ex:  # noqa: BLE001 - never 500 the plane
                body = f"could not collect stacks: {ex}".encode()
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args) -> None:  # silence request logs
        pass


class _ApiServer:
    def __init__(self, server: ThreadingHTTPServer, thread: threading.Thread):
        self._server = server
        self._thread = thread
        #: The bound port (configured port may be 0 = ephemeral).
        self.port = server.server_address[1]

    def shutdown(self) -> None:
        self._server.shutdown()
        self._thread.join(timeout=5)
        self._server.server_close()


def maybe_start_server(
    flow,
    status_fn: Optional[Callable[[], dict]] = None,
    port_offset: int = 0,
    health_fn: Optional[Callable[[], dict]] = None,
    stop_fn: Optional[Callable[[], None]] = None,
    reconfigure_fn: Optional[
        Callable[[list, Optional[int]], None]
    ] = None,
    graph_fn: Optional[Callable[[], dict]] = None,
    model_fn: Optional[Callable[..., str]] = None,
) -> Optional[_ApiServer]:
    """Start the API server if ``BYTEWAX_DATAFLOW_API_ENABLED`` is
    set (to anything but ``0``); returns a handle to shut it down,
    else ``None``.

    ``status_fn`` is a zero-arg callable (supplied by the engine
    driver) returning the live ``/status`` document; ``health_fn``
    returns the ``/healthz`` readiness payload (at minimum a
    ``ready`` bool — absent means always-ready); ``stop_fn`` arms
    ``POST /stop`` (a cooperative drain-to-stop request — 404 when
    absent); ``reconfigure_fn`` arms ``POST /reconfigure`` (a live
    membership-change request, docs/recovery.md "Live partial
    rescale" — same loopback guard as ``/stop``); ``graph_fn``
    returns the annotated topology for ``GET /graph`` (empty document
    when absent); ``model_fn`` arms ``POST /model`` (a broadcast-
    params hot-swap request, docs/inference.md — same loopback guard
    as ``/stop``); ``port_offset`` is this process's rank among
    co-located cluster processes."""
    from bytewax_tpu_torch.engine.flight import _truthy

    if not _truthy("BYTEWAX_DATAFLOW_API_ENABLED"):
        return None
    from bytewax_tpu_torch.visualize import to_json

    flow_json = to_json(flow)
    # Reference also dumps the graph to disk at startup
    # (src/run.rs:36-57).  Dump failures must be visible: a read-only
    # CWD silently losing the graph is a debugging dead end.
    dump_path = os.path.abspath("dataflow.json")
    try:
        with open(dump_path, "w") as f:
            f.write(flow_json)
    except OSError as ex:
        logger.warning(
            "could not dump dataflow graph to %s (errno %s: %s); "
            "GET /dataflow still serves it",
            dump_path,
            ex.errno,
            ex.strerror or ex,
        )

    host = os.environ.get("BYTEWAX_DATAFLOW_API_HOST", _DEFAULT_HOST)
    port = (
        int(os.environ.get("BYTEWAX_DATAFLOW_API_PORT", _DEFAULT_PORT))
        + port_offset
    )
    if (
        stop_fn is not None
        or reconfigure_fn is not None
        or model_fn is not None
    ) and host not in (
        "127.0.0.1",
        "localhost",
        "::1",
    ):
        # POST /stop, /reconfigure and /model are the plane's
        # mutating endpoints and carry no auth: off loopback (the
        # probe-wiring 0.0.0.0 case) they would let any network peer
        # drain, resize — or re-model — the whole cluster.  Serve
        # them there only behind the explicit opt-in knob; the
        # read-only endpoints stay up either way.
        if os.environ.get(
            "BYTEWAX_TPU_ALLOW_REMOTE_STOP", "0"
        ) in ("", "0"):
            logger.warning(
                "POST /stop, /reconfigure and /model disabled on "
                "non-loopback bind %s; set "
                "BYTEWAX_TPU_ALLOW_REMOTE_STOP=1 to accept remote "
                "control requests (docs/deployment.md)",
                host,
            )
            stop_fn = None
            reconfigure_fn = None
            model_fn = None
    handler = type(
        "_BoundHandler",
        (_Handler,),
        {
            "flow_json": flow_json,
            "status_fn": staticmethod(status_fn),
            "graph_fn": staticmethod(graph_fn),
            "health_fn": staticmethod(health_fn),
            "stop_fn": staticmethod(stop_fn),
            "reconfigure_fn": staticmethod(reconfigure_fn),
            "model_fn": staticmethod(model_fn),
        },
    )
    try:
        server = ThreadingHTTPServer((host, port), handler)
    except OSError as ex:
        # An observability server must never take down the data
        # plane: a taken port (another process, co-located ranks with
        # mixed host spellings in the address list) degrades to
        # metrics-less running, loudly.
        logger.warning(
            "could not bind dataflow API server on %s:%d (errno %s: "
            "%s); continuing without /dataflow, /metrics, /status",
            host,
            port,
            ex.errno,
            ex.strerror or ex,
        )
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return _ApiServer(server, thread)

"""Engine + custom metrics via Prometheus.

Metric-name parity with the reference
(upstream bytewax ``src/metrics/mod.rs``, ``src/operators.rs:154-167``):
``item_inp_count`` / ``item_out_count`` counters labeled
``{step_id, worker_index}`` and ``*_duration_seconds`` histograms with
the same explicit buckets.  User dataflows can register their own
metrics on the default ``prometheus_client`` registry; the dataflow
API server exposes everything at ``GET /metrics``.

The engine's own families live in :data:`ENGINE_REGISTRY`, a registry
of their own, so that this package and the JAX package it was ported
from can be imported into one process (as the parity tests do) without
registering one metric name twice.
"""

import functools
from typing import Dict, Tuple

import prometheus_client
from prometheus_client import REGISTRY, CollectorRegistry
from prometheus_client.exposition import generate_latest

#: The registry every engine metric family below is registered on.
ENGINE_REGISTRY = CollectorRegistry()
Counter = functools.partial(prometheus_client.Counter, registry=ENGINE_REGISTRY)
Gauge = functools.partial(prometheus_client.Gauge, registry=ENGINE_REGISTRY)
Histogram = functools.partial(
    prometheus_client.Histogram, registry=ENGINE_REGISTRY
)

__all__ = [
    "DURATION_BUCKETS",
    "ENGINE_REGISTRY",
    "DURATION_HISTOGRAMS",
    "autoscale_actions_count",
    "barrier_wait_seconds",
    "comm_bytes",
    "comm_fenced_frames",
    "comm_frames",
    "device_transfer_bytes",
    "dlq_records_count",
    "epoch_close_duration_seconds",
    "epoch_phase_seconds",
    "fault_injected_count",
    "generate_python_metrics",
    "gsync_round_count",
    "infer_params_generation",
    "infer_rows_count",
    "io_retries_count",
    "item_inp_count",
    "item_out_count",
    "quarantined_partitions",
    "pipeline_depth",
    "pipeline_flush_stall_seconds",
    "rescale_duration_seconds",
    "rescale_migrated_keys",
    "snapshot_lag_epochs",
    "source_lag_seconds",
    "state_evictions_count",
    "state_resident_keys",
    "state_spill_bytes",
    "step_demotion_count",
    "step_device_bytes",
    "step_rows_count",
    "step_watermark_lag_seconds",
    "wire_bytes_count",
    "wire_codec_seconds",
    "worker_restart_count",
]

#: Explicit histogram buckets, matching the reference
#: (``src/metrics/mod.rs:37-41``).
DURATION_BUCKETS = (
    0.0005,
    0.005,
    0.01,
    0.025,
    0.05,
    0.075,
    0.1,
    0.25,
    0.5,
    0.75,
    1.0,
    2.5,
    5.0,
    7.5,
    10.0,
)

item_inp_count = Counter(
    "bytewax_item_inp_count",
    "Number of items routed into a step",
    ["step_id", "worker_index"],
)

item_out_count = Counter(
    "bytewax_item_out_count",
    "Number of items emitted by a step",
    ["step_id", "worker_index"],
)

def _duration(name: str, doc: str) -> prometheus_client.Histogram:
    return Histogram(
        f"bytewax_{name}_duration_seconds",
        doc,
        ["step_id", "worker_index"],
        buckets=DURATION_BUCKETS,
    )


#: ``with_timer!``-parity histograms around every user-code call site
#: (reference inventory: ``src/operators.rs:154-167``, ``:599-631``,
#: ``src/inputs.rs:287-307``, ``src/outputs.rs:261-277``), keyed by
#: the reference's metric stem.
DURATION_HISTOGRAMS: Dict[str, prometheus_client.Histogram] = {
    "flat_map_batch": _duration(
        "flat_map_batch", "Time running a flat_map_batch mapper"
    ),
    "inp_part_next_batch": _duration(
        "inp_part_next_batch", "Time running a source partition's next_batch"
    ),
    "out_part_write_batch": _duration(
        "out_part_write_batch", "Time running a sink partition's write_batch"
    ),
    "snapshot": _duration(
        "snapshot", "Time snapshotting state at epoch close"
    ),
    "stateful_batch_on_batch": _duration(
        "stateful_batch_on_batch",
        "Time running stateful logic on_batch (or the device fold)",
    ),
    "stateful_batch_on_notify": _duration(
        "stateful_batch_on_notify", "Time running stateful logic on_notify"
    ),
    "stateful_batch_on_eof": _duration(
        "stateful_batch_on_eof", "Time running stateful logic on_eof"
    ),
    "stateful_batch_notify_at": _duration(
        "stateful_batch_notify_at", "Time running stateful logic notify_at"
    ),
    "stateful_batch_flush": _duration(
        "stateful_batch_flush",
        "Time in the global-mesh exchange flush at epoch close",
    ),
}


# -- engine flight-recorder families ------------------------------------
#
# The reference instruments only user-code call sites; these cover the
# parts this reproduction adds — the device tier and the clustered
# epoch protocol (fed by ``bytewax_tpu_torch/engine/flight.py``).

epoch_phase_seconds = Counter(
    "bytewax_epoch_phase_seconds",
    "Per-epoch time attribution (the epoch ledger, "
    "docs/observability.md): cumulative seconds spent in each engine "
    "phase, exclusive of nested phases.  step_id is '*' for "
    "process-wide phases (barrier, gsync, snapshot, commit)",
    ["phase", "step_id"],
)

source_lag_seconds = Gauge(
    "bytewax_source_lag_seconds",
    "Source lag accounting: kind=event_time is wall-clock now minus "
    "the freshest event timestamp a source batch carried at ingest "
    "(the watermark trails it by the configured wait); "
    "kind=processing is one delivery's ingest-to-emit latency "
    "through a device-tier step's dispatch pipeline",
    ["step_id", "kind"],
)

epoch_close_duration_seconds = Histogram(
    "bytewax_epoch_close_duration_seconds",
    "Time closing an epoch (pre-close flushes + snapshots + commit)",
    buckets=DURATION_BUCKETS,
)

barrier_wait_seconds = Histogram(
    "bytewax_barrier_wait_seconds",
    "Time from entering the cluster epoch barrier (hold) to the "
    "close broadcast taking effect on this process",
    buckets=DURATION_BUCKETS,
)

gsync_round_count = Counter(
    "bytewax_gsync_round_count",
    "Control-plane global_sync rounds completed (global-mesh "
    "exchange metadata + the epoch-close telemetry piggyback)",
)

device_transfer_bytes = Counter(
    "bytewax_device_transfer_bytes",
    "Host<->device bytes moved by the engine's device tier",
    ["direction"],  # h2d | d2h
)

pipeline_depth = Gauge(
    "bytewax_pipeline_depth",
    "Configured asynchronous device-dispatch pipeline depth per "
    "device-tier step (1 = synchronous lock-step dispatch)",
    ["step_id"],
)

pipeline_flush_stall_seconds = Counter(
    "bytewax_pipeline_flush_stall_seconds",
    "Seconds the host thread blocked at a pipeline drain point "
    "(window close, epoch close, snapshot, EOF, demotion) waiting "
    "for in-flight device work",
    ["step_id"],
)

comm_frames = Counter(
    "bytewax_comm_frames",
    "Cluster-mesh frames shipped per peer (includes heartbeats)",
    ["peer", "direction"],  # direction: tx | rx
)

comm_bytes = Counter(
    "bytewax_comm_bytes",
    "Cluster-mesh bytes shipped per peer (framed payload bytes; see "
    "bytewax_wire_bytes_count for the codec split)",
    ["peer", "direction"],
)

wire_bytes_count = Counter(
    "bytewax_wire_bytes_count",
    "Cluster-mesh payload bytes per wire codec (docs/performance.md "
    "'Columnar exchange'): codec=columnar is the zero-copy record-"
    "batch framing, codec=pickle the whole-frame fallback "
    "(control frames, item lists, object-dtype payloads, or "
    "BYTEWAX_TPU_WIRE=pickle)",
    ["codec", "direction"],  # direction: tx | rx
)

wire_codec_seconds = Counter(
    "bytewax_wire_codec_seconds",
    "Cumulative seconds spent encoding/decoding cluster-mesh "
    "payloads, per codec",
    ["codec", "op"],  # op: encode | decode
)


# -- robustness / chaos families ----------------------------------------
#
# Fed by the fault injector (``engine/faults.py``), the comm
# generation fence, the supervisor restart loop, and device-tier
# demotion (``engine/driver.py``).

fault_injected_count = Counter(
    "bytewax_fault_injected_count",
    "Faults fired by the chaos injector, per site and kind",
    ["site", "kind"],
)

comm_fenced_frames = Counter(
    "bytewax_comm_fenced_frames",
    "Cluster-mesh frames discarded because they were tagged with a "
    "dead restart generation",
)

worker_restart_count = Counter(
    "bytewax_worker_restart_count",
    "Supervised worker restarts after a restartable fault "
    "(peer death, epoch stall, injected crash)",
)

snapshot_lag_epochs = Gauge(
    "bytewax_snapshot_lag_epochs",
    "Closed epochs whose snapshot commit is still pending on the "
    "asynchronous checkpoint committer lane — the replay window a "
    "crash right now would incur (0 synchronous; at most 1 with "
    "BYTEWAX_TPU_CKPT_ASYNC=1; /healthz degrades above 1)",
)

rescale_migrated_keys = Counter(
    "bytewax_rescale_migrated_keys",
    "Distinct keyed-snapshot state keys re-routed by a "
    "rescale-on-resume migration at run startup (recovery store "
    "written by N workers, cluster relaunched with M)",
)

rescale_duration_seconds = Histogram(
    "bytewax_rescale_duration_seconds",
    "Wall time of one rescale-on-resume store migration (the "
    "all-partition route rewrite, run before any epoch processing)",
    buckets=DURATION_BUCKETS,
)

step_demotion_count = Counter(
    "bytewax_step_demotion_count",
    "Stateful steps demoted from the device tier to the host tier "
    "after consecutive device faults",
    ["step_id"],
)

infer_rows_count = Counter(
    "bytewax_infer_rows_count",
    "Rows scored by each op.infer step (both tiers; incremented on "
    "the main thread when a scoring phase finalizes)",
    ["step_id"],
)

infer_params_generation = Gauge(
    "bytewax_infer_params_generation",
    "Broadcast-params generation live in each op.infer step "
    "(0 = the build-time params; each committed hot-swap increments)",
    ["step_id"],
)

autoscale_actions_count = Counter(
    "bytewax_autoscale_actions_count",
    "Actions taken by the outer cluster supervisor "
    "(python -m bytewax_tpu_torch.supervise): action=grow|shrink is a "
    "coordinated graceful stop + relaunch at a new size acting on "
    "rescale_hint; action=relaunch is a hard-dead child process "
    "respawned in place",
    ["action"],
)


# -- connector-edge resilience families ---------------------------------
#
# Fed by the I/O retry ladder, the dead-letter queue, and partition
# quarantine in ``engine/driver.py`` (docs/recovery.md
# "Connector-edge resilience").

io_retries_count = Counter(
    "bytewax_io_retries_count",
    "Transient connector-edge I/O failures retried in place "
    "(kind=source: a source partition's next_batch re-polled after "
    "backoff; kind=sink: a sink partition's write_batch re-invoked "
    "before the epoch commit)",
    ["step_id", "kind"],
)

dlq_records_count = Counter(
    "bytewax_dlq_records_count",
    "Poison records captured into the dead-letter queue instead of "
    "killing the run (connectors with on_error='dlq'; persisted "
    "under BYTEWAX_TPU_DLQ_DIR)",
    ["step_id"],
)

quarantined_partitions = Gauge(
    "bytewax_quarantined_partitions",
    "Source partitions currently parked by quarantine "
    "(BYTEWAX_TPU_QUARANTINE=1: retry budget exhausted; frozen at "
    "the last good offset and re-probed on a backoff schedule while "
    "the rest of the dataflow keeps flowing)",
    ["step_id"],
)


# -- key-state residency families ---------------------------------------
#
# Fed by the tiered residency manager (``engine/residency.py``): with
# BYTEWAX_TPU_STATE_BUDGET set, each device-tier step keeps at most
# that many keys resident on device, evicting cold keys to host RAM
# and spilling truly cold keys to BYTEWAX_TPU_SPILL_DIR.

state_resident_keys = Gauge(
    "bytewax_state_resident_keys",
    "Device-resident keys per stateful step (sampled at the "
    "residency manager's drain points; bounded by "
    "BYTEWAX_TPU_STATE_BUDGET when set)",
    ["step_id"],
)

state_evictions_count = Counter(
    "bytewax_state_evictions_count",
    "Keys evicted from the device tier per step and destination "
    "tier (host = RAM snapshot cache, disk = spill store)",
    ["step_id", "tier"],
)

state_spill_bytes = Counter(
    "bytewax_state_spill_bytes",
    "Serialized bytes written to the disk spill store per step",
    ["step_id"],
)


# -- flow-map families ---------------------------------------------------
#
# Fed by the live flow map (``engine/flowmap.py``, docs/observability.md
# "Flow map"): per-step rows sealed once per epoch close (never a
# per-batch labeled inc), watermark lag and device footprint sampled at
# the close drain point.

step_rows_count = Counter(
    "bytewax_step_rows_count",
    "Rows through each step per direction (direction=in is rows "
    "delivered into the step, direction=out rows it emitted), "
    "accumulated per batch on the main thread and sealed into the "
    "family once per epoch close by the flow map",
    ["step_id", "direction"],  # direction: in | out
)

step_watermark_lag_seconds = Gauge(
    "bytewax_step_watermark_lag_seconds",
    "Per-step watermark lag: how far the step's event-time watermark "
    "trails wall clock (device window states sampled at the epoch-"
    "close drain point; constant between events by construction)",
    ["step_id"],
)

step_device_bytes = Gauge(
    "bytewax_step_device_bytes",
    "Device-resident state bytes per stateful step (slot-table "
    "column buffers, sampled at the epoch-close drain point; see "
    "bytewax_state_resident_keys for the key count under a "
    "residency budget)",
    ["step_id"],
)


def generate_python_metrics() -> str:
    """Generate Prometheus text exposition for the default registry
    (user metrics) and the engine's own."""
    return (
        generate_latest(REGISTRY) + generate_latest(ENGINE_REGISTRY)
    ).decode("utf-8")

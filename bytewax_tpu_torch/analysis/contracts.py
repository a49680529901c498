"""Pinned engine-contract inventories, consumed by the analysis rules.

These tables are the single written-down home of the invariants
``docs/contracts.md`` describes: which modules may touch
the raw cluster-send primitives, which control-frame kinds may ride
the mesh, which fault sites exist, which driver methods are the
globally-ordered protocol points, and which methods are the per-batch
hot path that must never reach a cluster collective.

``tests/test_torch_comm_invariants.py`` pins the values below (so editing
this file alone cannot silently relax a contract), and the rules in
:mod:`bytewax_tpu_torch.analysis.rules` enforce them against the real AST.
Extending an inventory is a deliberate act: update the table here,
update the pinning test, and re-check ``docs/contracts.md``.
"""

from typing import Dict, FrozenSet, Tuple

# ---------------------------------------------------------------------------
# BTX-SEND — the cluster send surface
# ---------------------------------------------------------------------------

#: Fully-qualified name of the cluster mesh class; constructing it is
#: itself a restricted act (a second mesh would bypass the epoch
#: barrier's counting entirely).
COMM_CLASS = "bytewax_tpu_torch.engine.comm.Comm"

#: Modules allowed to use each send primitive.  ``Comm`` construction
#: and the raw ``send``/``broadcast`` calls belong to the driver/comm
#: pair only; the routed surfaces (``ship_deliver``/``ship_route``)
#: are driver-internal.
SEND_ALLOWED: Dict[str, FrozenSet[str]] = {
    "comm_construct": frozenset(
        {"bytewax_tpu_torch.engine.comm", "bytewax_tpu_torch.engine.driver"}
    ),
    "raw_send": frozenset(
        {"bytewax_tpu_torch.engine.comm", "bytewax_tpu_torch.engine.driver"}
    ),
    "ship": frozenset({"bytewax_tpu_torch.engine.driver"}),
}

#: Raw-send method names on a Comm-typed receiver.
RAW_SEND_METHODS = frozenset({"send", "broadcast"})

#: The driver's routed send surfaces.  ``ship_flush`` drains the
#: per-peer route accumulator onto the wire — a send surface like the
#: other two (it counts frames into the barrier's quiescence math),
#: but ALSO a drain-only operation (see BTX-DRAIN below): callable
#: from the pinned drain points only, never from a per-batch path.
SHIP_METHODS = frozenset({"ship_deliver", "ship_route", "ship_flush"})

#: The columnar wire codec (``engine/wire.py``; docs/performance.md
#: "Columnar exchange"): pure encode/decode plus the route
#: accumulator — no sockets, no frames of its own.  Only the comm/
#: driver pair — and, since the overlapped-collectives PR, the
#: global-mesh collective tier (``engine/sharded_state.py``, whose
#: quantized partial-aggregate frames ride the existing gsync
#: payload and are encoded/decoded by this codec; docs/performance.md
#: "Overlapped collectives") — may call into it (resolved calls into
#: the module from anywhere else are a BTX-SEND finding): payload
#: encoding is part of the send surface, and another caller framing
#: its own payloads would be a covert channel around the counted
#: ship surfaces.
WIRE_MODULE = "bytewax_tpu_torch.engine.wire"
WIRE_ALLOWED_MODULES = frozenset(
    {
        "bytewax_tpu_torch.engine.comm",
        "bytewax_tpu_torch.engine.driver",
        "bytewax_tpu_torch.engine.sharded_state",
        "bytewax_tpu_torch.engine.wire",
    }
)

# ---------------------------------------------------------------------------
# BTX-FRAMES — the control-frame kind inventory
# ---------------------------------------------------------------------------

#: Every control-frame kind the clustered driver may put on the mesh.
#: Data frames must stay counted (``deliver``/``route``) and
#: everything else must be legal at the protocol point it arrives at,
#: or the count-matched epoch barrier / gsync ordering silently
#: breaks.  (The comm layer's heartbeat frame ``_HB`` is swallowed
#: before delivery and never reaches ``_handle_ctrl``; it is not a
#: control frame.)
CONTROL_FRAMES = frozenset(
    {
        "deliver",
        "route",
        "report_msg",
        "hold",
        "eof_step",
        "close_epoch",
        "gsync",
        "abort",
    }
)

#: The frame dispatcher whose AST defines the handled-kind inventory.
FRAME_DISPATCHER = "_handle_ctrl"

# ---------------------------------------------------------------------------
# BTX-GSYNC — collectives only at globally-ordered points
# ---------------------------------------------------------------------------

#: The control-plane sync primitives (methods of the driver).  A call
#: to either — through any alias — is a cluster-collective seed.
GSYNC_PRIMITIVES = frozenset({"global_sync", "next_gsync_tag"})

#: Modules sanctioned to call the gsync primitives directly (today:
#: the driver's own protocol points and the global-mesh exchange
#: tier).  A new collective tier must be added here explicitly after
#: re-checking the ordering contract.
GSYNC_CALLER_MODULES = frozenset(
    {"bytewax_tpu_torch.engine.driver", "bytewax_tpu_torch.engine.sharded_state"}
)

#: Cross-process ``torch.distributed`` calls (dotted paths; a call by
#: one of these names from a submodule of ``torch.distributed``, such
#: as ``distributed_c10d``, counts too).  Every one
#: blocks until each process of the group enters it, so a direct use
#: outside LOCAL_COLLECTIVE_MODULES seeds the reachability check
#: exactly like a gsync call.  The group-forming calls are collective
#: as well: ``init_process_group`` joins the world and ``new_group``
#: must be entered by every rank in the same order.
TORCH_COLLECTIVES = frozenset(
    {
        "torch.distributed.all_to_all_single",
        "torch.distributed.all_to_all",
        "torch.distributed.all_gather_object",
        "torch.distributed.all_gather",
        "torch.distributed.all_gather_into_tensor",
        "torch.distributed.all_reduce",
        "torch.distributed.reduce",
        "torch.distributed.reduce_scatter",
        "torch.distributed.reduce_scatter_tensor",
        "torch.distributed.broadcast",
        "torch.distributed.broadcast_object_list",
        "torch.distributed.gather",
        "torch.distributed.gather_object",
        "torch.distributed.scatter",
        "torch.distributed.scatter_object_list",
        "torch.distributed.barrier",
        "torch.distributed.monitored_barrier",
        "torch.distributed.send",
        "torch.distributed.recv",
        "torch.distributed.isend",
        "torch.distributed.irecv",
        "torch.distributed.batch_isend_irecv",
        "torch.distributed.init_process_group",
        "torch.distributed.new_group",
    }
)

#: This package's own entry points into the cross-process collectives
#: (dotted paths): the one all-to-all of the cluster-wide exchange and
#: the world join.  A call to one seeds the reachability check by its
#: resolved path, so a per-batch path that reaches one is flagged even
#: where the scan does not hold ``parallel/`` (a lone file checked
#: with the CLI); on the whole tree their bodies' TORCH_COLLECTIVES
#: calls seed it as well.
CLUSTER_COLLECTIVE_ENTRIES = frozenset(
    {
        "bytewax_tpu_torch.parallel.exchange.all_to_all_procs",
        "bytewax_tpu_torch.parallel.exchange.exchange_procs",
        "bytewax_tpu_torch.parallel.mesh.init_world",
    }
)

#: Modules whose collectives run over THIS process's devices only and
#: so cannot deadlock cluster peers.  Empty in this package: the
#: per-process sharded tier moves rows between its devices with plain
#: copies and runs no ``torch.distributed`` call, while
#: ``parallel/exchange.py`` (``all_to_all_procs``) and
#: ``parallel/mesh.py`` (``init_world``) hold the cluster-spanning
#: calls and must seed the reachability check.
LOCAL_COLLECTIVE_MODULES: FrozenSet[str] = frozenset()

#: Globally-ordered protocol points in the driver (module, qualname):
#: run startup (mesh handshake + the unconditional "fcfg" round),
#: epoch close, and the EOF ladder.  The reachability walk does not
#: descend into these — collectives under them are sanctioned.
ORDERED_ENTRY_POINTS: FrozenSet[Tuple[str, str]] = frozenset(
    {
        ("bytewax_tpu_torch.engine.driver", "_Driver.run"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._close_epoch"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._close_epoch_inner"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._apply_eof_step"),
        ("bytewax_tpu_torch.engine.driver", "_Driver.global_sync"),
    }
)

#: Operator hooks invoked ONLY from the ordered points above (the
#: close_epoch broadcast / EOF ladder serialize them): any method
#: with one of these names is treated as an ordered point too.
ORDERED_METHOD_NAMES = frozenset({"pre_close", "on_upstream_eof"})

#: Per-batch / per-key hot-path surfaces: any function DEFINITION
#: with one of these names is a root the reachability walk starts
#: from.  A cluster collective reachable from one of these deadlocks
#: the mesh (peers not in the same delivery never enter it).
PER_BATCH_METHOD_NAMES = frozenset(
    {
        "process",
        "drain",
        "advance",
        "poll",
        "emit",
        "route",
        "ship_deliver",
        "ship_route",
        "_pump",
        "_handle_ctrl",
        "_split_remote",
        "_split_remote_columnar",
        "_dispatch_device",
        "_process_device",
        "on_batch",
        "on_batch_columnar",
        "on_batch_items",
        "on_notify",
        "update",
        "update_batch",
        "update_items",
        "update_grouped",
        "next_batch",
        "write_batch",
        "recv_ready",
        "send",
        "broadcast",
    }
)

# ---------------------------------------------------------------------------
# BTX-FAULT — the chaos-injection site inventory
# ---------------------------------------------------------------------------

#: Fully-qualified name of the injector's one entry point.
FAULT_FIRE = "bytewax_tpu_torch.engine.faults.fire"

#: The injector module itself (may originate no traffic).
FAULTS_MODULE = "bytewax_tpu_torch.engine.faults"

#: Every site the engine threads a ``fire()`` call through.  Must
#: equal ``faults.SITES`` (the rule cross-checks the module's AST).
#: ``rescale_migrate`` is the rescale-on-resume migration
#: (``recovery_store.RecoveryStore.rescale``): fired inside the
#: all-partition transaction before any row moves, legal only at run
#: startup — the one globally-ordered re-entry point.
#: ``source_poll``/``sink_write`` are the connector-edge sites
#: (docs/recovery.md "Connector-edge resilience"): fired in the
#: driver immediately before a source partition's ``next_batch`` / a
#: sink partition's ``write_batch``, before any offset advances or
#: byte lands, so an injected transient error is retry-safe; their
#: ``kind=error`` raises the typed transient I/O errors the retry
#: ladder absorbs.  Both are process-local — no comm frames, no new
#: send surface.
#: ``snapshot_seal`` is the asynchronous-checkpoint seal point
#: (docs/recovery.md "Asynchronous incremental checkpoints"): fired
#: at the epoch-close drain point AFTER the consistent delta is
#: sealed in memory but BEFORE it is handed to anything durable
#: (inline write or the committer lane), so an injected crash there
#: proves the crash-between-seal-and-commit window replays exactly
#: the sealed epoch.  ``params_swap`` fires at the agreed epoch close
#: before any infer runtime installs a pending broadcast-params
#: update and before the pending target is consumed, so an injected
#: crash restarts with the target intact and the swap commits exactly
#: once at the next agreed close (docs/inference.md).
FAULT_SITES = (
    "comm.send",
    "comm.recv",
    "device_dispatch",
    "residency_restore",
    "source_poll",
    "sink_write",
    "snapshot.write",
    "snapshot.commit",
    "snapshot_seal",
    "rescale_migrate",
    "params_swap",
    "barrier",
)

#: Sites on the device-dispatch path whose injected fault is a
#: retryable :class:`DeviceFault`: the fire must precede any
#: device-state mutation in the firing function (the fire-before-
#: mutate component below applies to each of these, not just
#: ``device_dispatch``).
FAULT_DEVICE_SITES = frozenset(
    {"device_dispatch", "residency_restore"}
)

#: Calls that mutate device-tier state on the dispatch path.  In any
#: function that fires the ``device_dispatch`` site, the fire must
#: precede the first of these — a :class:`DeviceFault` is only
#: retryable because no device state has mutated yet.  The dispatch
#: pipeline's entry points (``engine/pipeline.py``) count as mutators:
#: entering the pipeline runs/finalizes device phases, so the fire
#: must precede them too.
DEVICE_MUTATORS = frozenset(
    {
        "_process_device",
        "_process_accel",
        "_process_window_accel",
        "_process_scan_accel",
        "update",
        "update_batch",
        "update_items",
        "update_grouped",
        "on_batch",
        "on_batch_columnar",
        "on_batch_items",
        "load",
        "load_many",
        # engine/residency.py tier-movement surfaces (both rewrite
        # the slot tables).
        "extract_keys",
        "inject_keys",
        # engine/pipeline.py dispatch-pipeline entry points.
        "make_room",
        "push",
        "submit",
    }
)

#: The dispatch-pipeline module; BTX-FAULT's reachability component
#: walks the call graph through it, so fire-before-mutate is proven
#: across the pipeline indirection, not just lexically.
PIPELINE_MODULE = "bytewax_tpu_torch.engine.pipeline"

#: Bound on the fire-before-mutate call-graph walk (calls lexically
#: before a ``device_dispatch`` fire may not REACH a mutator within
#: this many edges; the engine's real chains are ≤3 deep).
FAULT_REACH_DEPTH = 6

# ---------------------------------------------------------------------------
# BTX-SNAPSHOT — cross-tier snapshot interchange
# ---------------------------------------------------------------------------

#: Factory functions whose returned classes form the device-tier
#: dispatch table (what ``_StatefulBatchRt.__init__`` installs).
#: Every class they can return must implement
#: ``demotion_snapshots()`` so device→host demotion stays closed
#: under new tiers — except classes marked ``global_exchange = True``
#: (the collective tier never demotes; it unwinds to the supervisor).
DEVICE_STATE_FACTORY_NAMES = frozenset(
    {"make_agg_state", "make_scan_state", "make_state"}
)

#: The method every demotable device-tier state class must provide.
DEMOTION_METHOD = "demotion_snapshots"

#: Class attribute marking the collective (never-demoting) tier.
GLOBAL_EXCHANGE_ATTR = "global_exchange"

#: The tiered-residency surface (engine/residency.py).  A class
#: reachable from the dispatch-table factories that implements the
#: eviction half must implement the restore half — an extracted key
#: with no way back is stranded state — and the collective
#: ``global_exchange = True`` tier must implement NEITHER: a
#: per-process eviction there would desynchronize the collective
#: step shapes across the cluster.
RESIDENCY_EXTRACT = "extract_keys"
RESIDENCY_INJECT = "inject_keys"

# ---------------------------------------------------------------------------
# BTX-DRAIN — drain-only operations happen only at drain points
# ---------------------------------------------------------------------------

#: The dispatch-pipeline class; constructing it (or holding it in an
#: attribute) marks a receiver as pipeline-denoting for the drain and
#: thread rules.
PIPELINE_CLASS = "bytewax_tpu_torch.engine.pipeline.DevicePipeline"

#: Thread-submission surfaces on a pipeline-denoting receiver: the
#: first argument is a callable that will run on the worker lane.
PIPELINE_SUBMIT_METHODS = frozenset({"push", "submit"})

#: Drain-only operations, by method name.  Calls to these are legal
#: only from a pinned drain point: they read or hand off state the
#: pipeline worker owns between submit and finalize (residency tier
#: movement, demotion snapshots, residency-managed snapshot reads,
#: pipeline drain/teardown wrappers, epoch-close entry).  Their own
#: DEFINITIONS are drain machinery and are not descended into.
DRAIN_ONLY_METHODS = frozenset(
    {
        # engine/residency.py tier movement (restore-before-dispatch
        # and eviction both quiesce the pipeline first).
        "evict_to_budget",
        "prepare",
        "prepare_entries",
        "extract_keys",
        "inject_keys",
        # cross-tier demotion reads worker-owned fold structures.
        "demotion_snapshots",
        # the driver-side pipeline drain/teardown wrappers.
        "pipeline_flush",
        "pipeline_shutdown",
        "_pipe_shutdown",
        # epoch-close entry (snapshots + the close sync ladder).
        "_close_epoch",
        "_close_epoch_inner",
        # checkpoint seal + committer-lane fence/teardown
        # (docs/recovery.md "Asynchronous incremental checkpoints"):
        # the seal reads every step's epoch_snaps (worker-owned
        # between submit and finalize), the fence blocks on the
        # committer lane, and the shutdown tears its worker down.
        "_ckpt_seal",
        "_ckpt_fence",
        "_ckpt_shutdown",
        # the route-accumulator flush (engine/wire.py): frames ship
        # and count ONLY at poll boundaries / drain points, so the
        # count-matched barrier sees exactly what left the process.
        "ship_flush",
        # broadcast-params hot swap (docs/inference.md): the agreed
        # install mutates the very params tree in-flight device
        # phases read, so it may run only with every pipeline
        # quiesced — i.e. from the epoch-close agreement.
        "_apply_params_swap",
        "install_params",
    }
)

#: Calls with these names on a *pipeline-denoting receiver* are
#: drain-only too (the raw DevicePipeline drain/teardown surface;
#: name-only matching would over-fire on file/DLQ/global-tier
#: ``flush``).
PIPELINE_DRAIN_METHODS = frozenset({"flush", "shutdown", "drop_pending"})

#: Drain-only names scoped to the residency manager: a call counts
#: only when it may resolve into ``engine/residency.py`` (or does
#: not resolve at all).  A device tier reading its OWN snapshots
#: inside its deferred device phase (the windower's due-window
#: fetch) is the pipeline worker's job, not a drain violation.
DRAIN_RESIDENCY_SCOPED = frozenset({"snapshots_for"})
RESIDENCY_MODULE = "bytewax_tpu_torch.engine.residency"

#: The pinned drain points (module, qualname): window close/notify,
#: epoch close, snapshot, the EOF ladder, demotion, and the
#: gsync-bearing startup paths.  The reachability walk from per-batch
#: roots does not descend into these; a drain-only operation
#: reachable OUTSIDE them is a finding.  ``pre_close`` /
#: ``on_upstream_eof`` / ``epoch_snaps`` are drain points by name
#: (see DRAIN_POINT_METHOD_NAMES) — operator hooks the close
#: broadcast / EOF ladder serialize.
DRAIN_POINTS: FrozenSet[Tuple[str, str]] = frozenset(
    {
        ("bytewax_tpu_torch.engine.driver", "_StatefulBatchRt.advance"),
        ("bytewax_tpu_torch.engine.driver", "_StatefulBatchRt._demote"),
        ("bytewax_tpu_torch.engine.driver", "_InferRt._demote"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._close_epoch"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._close_epoch_inner"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._drain_pipelines"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._apply_eof_step"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._startup_rescale"),
        ("bytewax_tpu_torch.engine.driver", "_Driver.run"),
    }
)

#: Method names that are drain points wherever they appear: operator
#: hooks invoked only from the ordered close/EOF machinery, plus the
#: window-close/notify hooks — the driver flushes the pipeline
#: before every ``on_notify``/``on_eof`` pass (window close IS a
#: drain point), so their snapshot reads are post-flush by
#: construction.
DRAIN_POINT_METHOD_NAMES = frozenset(
    {
        "pre_close",
        "on_upstream_eof",
        "epoch_snaps",
        "on_notify",
        "on_eof",
    }
)

#: Functions whose direct gsync call is exempt from the
#: flush-before-sync ordering check, with the reason pinned here:
#: - GlobalAggState.flush: the collective tier never enters the
#:   per-delivery dispatch pipeline, and its only caller (pre_close)
#:   flushes every pipeline first — the driver also drains all ops
#:   before the pre_close pass at epoch close.  Since the depth-ladder
#:   PR its own exchange lane is bounded by ``DevicePipeline.push``'s
#:   ``make_room`` instead of a lexical ``fence()`` (depth 1 retires
#:   the previous round before the next seals — byte-identical to the
#:   old fence-first ordering; depth D allows D sealed rounds in
#:   flight, retired in order) — the resolver's flush walk can't see
#:   through that indirection, hence the pin stays, with the lane
#:   ordering re-checked here and full drains pinned at finalize /
#:   the run-ending closes via BTX-LANE.
#: - _Driver.run / _Driver._startup_rescale: run-startup rounds
#:   ("fcfg", "rescaled") fire before any delivery has been
#:   dispatched, so no pipeline can hold work yet.
GSYNC_PREFLUSHED: FrozenSet[Tuple[str, str]] = frozenset(
    {
        ("bytewax_tpu_torch.engine.sharded_state", "GlobalAggState.flush"),
        ("bytewax_tpu_torch.engine.driver", "_Driver.run"),
        ("bytewax_tpu_torch.engine.driver", "_Driver._startup_rescale"),
    }
)

#: Call names that count as "flushes the pipelines" for the
#: flush-before-sync component (directly, or via a call that
#: transitively reaches one of them / a pipeline-receiver flush).
PIPELINE_FLUSH_NAMES = frozenset(
    {"pipeline_flush", "_drain_pipelines"}
)

#: Bound on the flush-before-sync reachability walk (a call lexically
#: before a gsync must reach a pipeline flush within this many
#: edges).
DRAIN_REACH_DEPTH = 6

# ---------------------------------------------------------------------------
# BTX-THREAD — the pipeline worker lane never touches main-only state
# ---------------------------------------------------------------------------

#: Main-thread-only surfaces, by method/function name.  The worker
#: lane (any callable submitted through ``DevicePipeline.push`` /
#: ``submit``) must never transitively reach one: the send surface
#: and sync rounds (cluster protocol ordering), downstream emission
#: and the cluster routing/vocab split caches (stream order), the
#: recovery store (snapshot consistency), residency tier movement and
#: pipeline drains (the worker would race — or deadlock on — its own
#: lane).
MAIN_ONLY = frozenset(
    {
        # send surface / sync rounds
        "ship_deliver",
        "ship_route",
        "ship_flush",
        "send",
        "broadcast",
        "global_sync",
        "next_gsync_tag",
        # downstream emission + cluster routing / vocab split caches
        "emit",
        "route",
        "_flush",
        "_handle",
        "_emit_window_events",
        "_emit_scan",
        "_split_remote",
        "_split_remote_columnar",
        "_batch_dests",
        # recovery-store writes and resume reads
        "write_epoch",
        "write_ex_started",
        "rescale",
        "resume_state",
        "iter_resume_states",
        # residency tier movement + demotion
        "evict_to_budget",
        "prepare",
        "prepare_entries",
        "extract_keys",
        "inject_keys",
        "demotion_snapshots",
        # pipeline drains (a worker task flushing its own pipeline
        # deadlocks the lane) and epoch close
        "pipeline_flush",
        "pipeline_shutdown",
        "_pipe_shutdown",
        "_ckpt_shutdown",
        "flush",
        "shutdown",
        "drop_pending",
        "make_room",
        "push",
        "submit",
        "_close_epoch",
        "_close_epoch_inner",
    }
)

#: Modules whose functions are main-thread-only wholesale: reaching
#: ANY function defined in one of these from the worker lane is a
#: finding, whatever it is called.
MAIN_ONLY_MODULES = frozenset(
    {
        "bytewax_tpu_torch.engine.comm",
        "bytewax_tpu_torch.engine.recovery_store",
        "bytewax_tpu_torch.engine.residency",
        "bytewax_tpu_torch.engine.dlq",
        "bytewax_tpu_torch.engine.webserver",
    }
)

#: Ubiquitous Python collection/stdlib method names: when the
#: resolver's visible-name FALLBACK (unknown receiver) is the only
#: thing binding one of these to a project method, the edge is far
#: more likely a ``dict.get`` / ``list.append`` than the project
#: method — the worker-lane walk drops such edges instead of
#: reporting every ``self._cache.get(...)`` as a residency-module
#: touch.  A RESOLVED receiver (typed local/attribute, ``self``)
#: with one of these names still counts fully.
FALLBACK_BENIGN_METHODS = frozenset(
    {
        "get",
        "append",
        "extend",
        "pop",
        "popleft",
        "clear",
        "add",
        "discard",
        "setdefault",
        "keys",
        "values",
        "items",
        "copy",
        "close",
        "time",
        "tolist",
        "astype",
        "join",
        "split",
    }
)

#: Deliberately-shared append paths the worker lane MAY use: the
#: flight-ring / ledger recording surface is lock-free-append by
#: design (docs/observability.md) and the worker stamps its own
#: device-phase timings.  These names are exempt from the MAIN_ONLY
#: *name* check only — a call that resolves into a MAIN_ONLY_MODULES
#: module is flagged regardless of its name, so a recovery-store or
#: DLQ method named ``record``/``count`` can never hide behind the
#: waiver.
WORKER_SAFE = frozenset(
    {
        "note_phase",
        "note_source_lag",
        "note_pipeline_stall",
        "note_flush_depth",
        "record",
        "count",
    }
)

#: The asynchronous-checkpoint committer lane's narrow carve-out
#: (docs/recovery.md "Asynchronous incremental checkpoints").  The
#: recovery store is MAIN_ONLY for every other worker-lane root —
#: that is what keeps snapshot consistency single-threaded — but the
#: committer task's ENTIRE job is one ``RecoveryStore.write_epoch``
#: call over a delta the main thread sealed and froze before handoff
#: (at most one in flight; the next close fences the previous
#: commit, so the store handle is never used from two threads at
#: once).  The exemption is root-scoped: ONLY the root named here
#: may reach the store, ONLY via the method named in
#: SNAPSHOT_LANE_SAFE, ONLY into SNAPSHOT_LANE_MODULE — every other
#: MAIN_ONLY name/module check still applies to it, and every other
#: worker-lane root still sees the store as forbidden.
SNAPSHOT_LANE_ROOTS = frozenset(
    {
        "bytewax_tpu_torch.engine.driver:"
        "_Driver._ckpt_seal.<locals>.commit_task",
    }
)
SNAPSHOT_LANE_MODULE = "bytewax_tpu_torch.engine.recovery_store"
SNAPSHOT_LANE_SAFE = frozenset({"write_epoch"})

# ---------------------------------------------------------------------------
# BTX-LANE — the off-main-thread lane catalog
# ---------------------------------------------------------------------------

#: Every ordered off-main-thread lane in the engine — one entry per
#: ``DevicePipeline(...)`` construction site.  The rule proves, both
#: ways (staleness included):
#:
#: - ``constructor``: the (module, qualname) of the function holding
#:   the construction call.  Every construction site in the package
#:   must be cataloged here, and every entry must still construct.
#: - ``phase``: the ledger-phase string literal at the construction
#:   site (absent kwarg = the ``"device"`` default).  A mismatch
#:   silently mis-buckets worker seconds and breaks
#:   ``derive_rescale_hint``'s fraction signals.
#: - ``depth``: the max-in-flight bound as written at the site — an
#:   integer literal, or None when knob-driven
#:   (``BYTEWAX_TPU_PIPELINE_DEPTH`` for the dispatch pipeline, which
#:   caps at 2 under a residency budget;
#:   ``BYTEWAX_TPU_GSYNC_DEPTH`` for the collective exchange lane,
#:   whose site passes ``_gsync_depth() + 1`` so depth 1 keeps the
#:   original one-round-in-flight behavior).
#: - ``fence`` / ``shutdown``: the lane's drain and teardown
#:   functions, each of which must be call-graph-reachable from every
#:   pinned run-ending close in LANE_TEARDOWN_ROOTS — a lane nobody
#:   fences at teardown loses its in-flight round on a stop or
#:   reconfigure.
LANES: Dict[str, Dict[str, object]] = {
    "dispatch": {
        "constructor": (
            "bytewax_tpu_torch.engine.driver",
            "_StatefulBatchRt.__init__",
        ),
        "phase": "device",
        "depth": None,
        "fence": (
            "bytewax_tpu_torch.engine.driver",
            "_StatefulBatchRt.pipeline_flush",
        ),
        "shutdown": (
            "bytewax_tpu_torch.engine.driver",
            "_StatefulBatchRt._pipe_shutdown",
        ),
    },
    "collective": {
        "constructor": (
            "bytewax_tpu_torch.engine.sharded_state",
            "GlobalAggState.__init__",
        ),
        "phase": "collective_lane",
        "depth": None,
        "fence": (
            "bytewax_tpu_torch.engine.sharded_state",
            "GlobalAggState.fence",
        ),
        "shutdown": (
            "bytewax_tpu_torch.engine.sharded_state",
            "GlobalAggState.lane_shutdown",
        ),
    },
    "checkpoint": {
        "constructor": (
            "bytewax_tpu_torch.engine.driver",
            "_Driver.__init__",
        ),
        "phase": "snapshot_lane",
        "depth": 2,
        "fence": (
            "bytewax_tpu_torch.engine.driver",
            "_Driver._ckpt_fence",
        ),
        "shutdown": (
            "bytewax_tpu_torch.engine.driver",
            "_Driver._ckpt_shutdown",
        ),
    },
}

#: The pinned run-ending closes: every lane's fence AND shutdown must
#: be reachable from EACH of these over the call graph (plus the
#: ``getattr(obj, "name")``-literal dispatch edges the teardown paths
#: use), so no stop/reconfigure/demotion path can retire the runtime
#: with a lane still holding work.
LANE_TEARDOWN_ROOTS: FrozenSet[Tuple[str, str]] = frozenset(
    {
        # the run loop: the clean-exit fence, the startup-fault
        # unwind, and the finally-block teardown all live here.
        ("bytewax_tpu_torch.engine.driver", "_Driver.run"),
        # the stop/reconfigure agreed close (the run-ending close).
        ("bytewax_tpu_torch.engine.driver", "_Driver._close_epoch_inner"),
        # device-tier demotion: the host tier takes over mid-run.
        ("bytewax_tpu_torch.engine.driver", "_StatefulBatchRt._demote"),
        # infer-tier demotion (broadcast params → host numpy apply).
        ("bytewax_tpu_torch.engine.driver", "_InferRt._demote"),
    }
)

#: Sealed-task purity (BTX-LANE component d): attributes a lane task
#: may transitively READ even though per-batch main-thread code
#: writes them, each with the synchronization that makes it safe.
#: Everything else a sealed task reads must be a local sealed at
#: construction (that is the whole point of the seal) or an attribute
#: only ordered points touch.  Key format ``module:Class.attr``.
SEALED_CAPTURE_SAFE: Dict[str, str] = {}

# ---------------------------------------------------------------------------
# BTX-RACE — attribute-level worker/main shared-state inventory
# ---------------------------------------------------------------------------

#: Extra worker-side roots for the effect analysis: sealed device
#: phases handed BACK to the driver as closures and submitted later
#: through a variable the resolver cannot trace through return
#: values.  Pinned here so their effects still count as worker-lane
#: effects.  (The six ``DevicePipeline.push``/``submit`` roots are
#: discovered from the submit sites themselves — see
#: ``rules/thread.worker_lane_roots``.)
RACE_WORKER_CARVEOUTS: FrozenSet[str] = frozenset(
    {
        "bytewax_tpu_torch.engine.window_accel:"
        "DeviceWindowAggState._ingest.<locals>.device_phase",
        "bytewax_tpu_torch.engine.driver:"
        "_StatefulBatchRt._scan_batch.<locals>.batch_phase",
        "bytewax_tpu_torch.engine.driver:"
        "_InferRt._infer_batch.<locals>.batch_phase",
    }
)

#: Attributes legitimately touched by BOTH the worker lane and
#: per-batch main-thread code, each with a one-line justification of
#: the synchronization that makes the sharing safe.  Any other
#: attribute written on one side and read or written on the other is
#: a BTX-RACE finding with dual witness chains.  Key format
#: ``module:Class.attr`` (``module:<globals>.name`` for module
#: globals).
SHARED_STATE: Dict[str, str] = {
    "bytewax_tpu_torch.engine.arrays:KeyEncoder._ids": (
        "instance-per-owner: source/router encoders mutate on main, "
        "a device state's encoder mutates only inside its step's "
        "ordered lane (main touches it at drain points only); the "
        "attribute-level analysis is instance-insensitive"
    ),
    "bytewax_tpu_torch.engine.arrays:KeyEncoder._sorted": (
        "instance-per-owner: same ownership split as "
        "KeyEncoder._ids — no encoder instance is ever shared "
        "between the lane and per-batch main code"
    ),
    "bytewax_tpu_torch.engine.driver:_OpRt._m_timers": (
        "memoized tracing-timer handles: GIL-atomic dict get/set; a "
        "racy miss creates one duplicate handle and drops it, never "
        "corrupts"
    ),
    "bytewax_tpu_torch.engine.flight:FlightRecorder._ring": (
        "deliberately shared lock-free telemetry: deque.append is "
        "thread-safe and readers copy racily "
        "(docs/observability.md; the WORKER_SAFE append surface)"
    ),
    "bytewax_tpu_torch.engine.flight:FlightRecorder.counters": (
        "GIL-atomic dict adds, read racily by design (engine/flight "
        "thread-safety note; the WORKER_SAFE append surface)"
    ),
}

# ---------------------------------------------------------------------------
# BTX-KNOB — the BYTEWAX_TPU_* environment-knob catalog
# ---------------------------------------------------------------------------

#: Every engine knob: name -> (default-as-the-code-reads-it, doc file
#: under the repo root that describes it).  Every ``os.environ`` /
#: ``os.getenv`` read of a ``BYTEWAX_TPU_*`` name must be a string
#: literal found in this table (a computed name evades the catalog),
#: every entry must still be read somewhere in the package (a
#: removed knob must leave the catalog), and every entry's doc file
#: must mention it (doc drift is an analyzer finding).
#: ``docs/configuration.md`` lists the knobs this package shares with
#: the JAX package; the README's port section lists the port-only
#: ones.  The JAX package's ``BYTEWAX_TPU_PALLAS``,
#: ``BYTEWAX_TPU_COMPILE_CACHE`` and ``BYTEWAX_TPU_PAD_MIN_POW`` /
#: ``BYTEWAX_TPU_PAD_MAX_POW`` are not here: this package runs its
#: kernels eagerly, with no compile cache and no pad ladder.
#: ``BYTEWAX_TPU_VIRTUAL_DEVICES`` is this package's own (a mesh of a
#: repeated device, read by ``parallel.mesh.local_devices``).
KNOBS: Dict[str, Tuple[str, str]] = {
    "BYTEWAX_TPU_ACCEL": ("1", "docs/configuration.md"),
    "BYTEWAX_TPU_ALLOW_REMOTE_STOP": ("0", "docs/deployment.md"),
    "BYTEWAX_TPU_AUTOSCALE_COOLDOWN_S": ("30", "docs/deployment.md"),
    "BYTEWAX_TPU_AUTOSCALE_HYSTERESIS": ("3", "docs/deployment.md"),
    "BYTEWAX_TPU_AUTOSCALE_LIVE": ("1", "docs/deployment.md"),
    "BYTEWAX_TPU_AUTOSCALE_POLL_S": ("2", "docs/deployment.md"),
    "BYTEWAX_TPU_AUTOSCALE_STOP_TIMEOUT_S": (
        "60",
        "docs/deployment.md",
    ),
    "BYTEWAX_TPU_CKPT_ASYNC": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_CKPT_COMPACT_EVERY": ("", "docs/recovery.md"),
    "BYTEWAX_TPU_CKPT_DELTA": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_COORDINATOR": ("", "docs/deployment.md"),
    "BYTEWAX_TPU_DEMOTE_AFTER": ("3", "docs/recovery.md"),
    "BYTEWAX_TPU_DIAL_TIMEOUT_S": ("30", "docs/deployment.md"),
    "BYTEWAX_TPU_DISTRIBUTED": ("0", "docs/deployment.md"),
    "BYTEWAX_TPU_DLQ_DIR": ("", "docs/recovery.md"),
    "BYTEWAX_TPU_EPOCH_STALL_S": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_FAULTS": ("", "docs/recovery.md"),
    "BYTEWAX_TPU_FAULTS_KINDS": ("", "docs/configuration.md"),
    "BYTEWAX_TPU_FAULTS_MIN_GAP_S": ("1.0", "docs/recovery.md"),
    "BYTEWAX_TPU_FAULTS_RATE": ("0.01", "docs/recovery.md"),
    "BYTEWAX_TPU_FAULTS_SEED": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_FAULTS_SITES": ("", "docs/recovery.md"),
    "BYTEWAX_TPU_FAULT_DELAY_S": ("0.05", "docs/configuration.md"),
    "BYTEWAX_TPU_GC": ("epoch", "docs/configuration.md"),
    "BYTEWAX_TPU_GLOBAL_EXCHANGE": ("1", "docs/xla-tier.md"),
    "BYTEWAX_TPU_GLOBAL_EXCHANGE_DEBUG": (
        "0",
        "docs/configuration.md",
    ),
    "BYTEWAX_TPU_GSYNC_BASELINE_EVERY": ("8", "docs/recovery.md"),
    "BYTEWAX_TPU_GSYNC_DEPTH": ("1", "docs/performance.md"),
    "BYTEWAX_TPU_GSYNC_OVERLAP": ("0", "docs/performance.md"),
    "BYTEWAX_TPU_GSYNC_QUANT": ("off", "docs/performance.md"),
    "BYTEWAX_TPU_HB_S": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_HEARTBEAT_S": ("30", "docs/profiling.md"),
    "BYTEWAX_TPU_HOST_STATE_BUDGET": ("", "docs/state-residency.md"),
    "BYTEWAX_TPU_INFER_DEVICE": ("1", "docs/inference.md"),
    "BYTEWAX_TPU_INGEST_TARGET_ROWS": ("", "docs/performance.md"),
    "BYTEWAX_TPU_IO_BACKOFF_CAP_S": ("5", "docs/recovery.md"),
    "BYTEWAX_TPU_IO_BACKOFF_S": ("0.05", "docs/recovery.md"),
    "BYTEWAX_TPU_IO_RETRIES": ("3", "docs/recovery.md"),
    "BYTEWAX_TPU_MAX_RESTARTS": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_PIPELINE_DEPTH": ("2", "docs/performance.md"),
    "BYTEWAX_TPU_PLATFORM": ("", "docs/profiling.md"),
    "BYTEWAX_TPU_POSTMORTEM_DIR": ("", "docs/observability.md"),
    "BYTEWAX_TPU_QUARANTINE": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_QUARANTINE_REPROBE_S": ("30", "docs/recovery.md"),
    "BYTEWAX_TPU_RESCALE": ("0", "docs/recovery.md"),
    "BYTEWAX_TPU_RESTART_BACKOFF_S": ("0.5", "docs/recovery.md"),
    "BYTEWAX_TPU_RESTART_RESET_S": ("300", "docs/recovery.md"),
    "BYTEWAX_TPU_REUSEPORT": ("", "docs/configuration.md"),
    "BYTEWAX_TPU_RX_BUFFER_CAP": ("67108864", "docs/deployment.md"),
    "BYTEWAX_TPU_SHARD": ("auto", "docs/architecture.md"),
    "BYTEWAX_TPU_SPILL_DIR": ("", "docs/state-residency.md"),
    "BYTEWAX_TPU_STATE_BUDGET": ("", "docs/state-residency.md"),
    "BYTEWAX_TPU_TEXT_DEVICE": ("0", "docs/performance.md"),
    "BYTEWAX_TPU_TRACE_DIR": ("", "docs/observability.md"),
    "BYTEWAX_TPU_VIRTUAL_DEVICES": ("", "README.md"),
    "BYTEWAX_TPU_WIRE": ("columnar", "docs/performance.md"),
}

#: The knob name prefix the rule keys on.
KNOB_PREFIX = "BYTEWAX_TPU_"

#: Dotted paths that read the environment (resolved through module
#: bindings, so ``from os import environ; environ.get(...)`` is
#: seen).
ENV_READ_CALLS = frozenset({"os.environ.get", "os.getenv"})
ENV_MAPPING = "os.environ"

# ---------------------------------------------------------------------------
# BTX-BACKEND — standalone scripts choose the device tier's platform
# ---------------------------------------------------------------------------

#: Entry points that start the engine (and therefore pick the device
#: tier's device: ``cuda:0`` unless ``BYTEWAX_TPU_PLATFORM=cpu``).
RUN_ENTRY_POINTS = frozenset(
    {
        "bytewax_tpu_torch.engine.driver.run_main",
        "bytewax_tpu_torch.engine.driver.cluster_main",
        "bytewax_tpu_torch.testing.run_main",
        "bytewax_tpu_torch.testing.cluster_main",
        "bytewax_tpu_torch.run.cli_main",
    }
)

#: Bare call names treated as run entry points inside scripts.
RUN_ENTRY_NAMES = frozenset({"run_main", "cluster_main", "cli_main"})

#: Other calls that start the device tier's runtime: joining the
#: ``torch.distributed`` world, and any ``torch.cuda.*`` call (each
#: creates or binds a CUDA context) except the probes in
#: TORCH_CUDA_PROBES, which query the driver and create none.
RUNTIME_STARTERS = frozenset({"torch.distributed.init_process_group"})
TORCH_CUDA_PREFIX = "torch.cuda."
TORCH_CUDA_PROBES = frozenset(
    {"torch.cuda.is_available", "torch.cuda.device_count"}
)

#: Helpers that force a platform choice.
FORCE_HELPERS = frozenset(
    {
        "bytewax_tpu_torch.utils.force_platform",
        "bytewax_tpu_torch.utils.force_cpu_mesh",
    }
)
FORCE_HELPER_NAMES = frozenset({"force_platform", "force_cpu_mesh"})

#: Environment keys whose assignment (``os.environ[k] = ...``,
#: ``setdefault``) or removal (``pop``, ``del``) chooses the platform
#: before anything starts the device tier: the driver reads
#: ``BYTEWAX_TPU_PLATFORM`` (``cpu``; unset is the card).
FORCE_ENV_KEYS = frozenset({"BYTEWAX_TPU_PLATFORM"})

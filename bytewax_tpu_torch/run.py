"""Execute a dataflow from the command line.

Use it like:

```console
$ python -m bytewax_tpu_torch.run my_flow:flow
```

CLI/env-var parity with upstream bytewax (``pysrc/bytewax/run.py``):
Flask-style import strings (variable, or factory call with literal
args), ``-w/-i/-a/-r/-s/-b`` flags each with a ``BYTEWAX_*`` env-var
fallback, and k8s conventions (``BYTEWAX_POD_NAME`` /
``BYTEWAX_STATEFULSET_NAME`` → process id, ``BYTEWAX_HOSTFILE_PATH`` →
addresses).

Every process runs its device tier on ``cuda:0`` unless
``BYTEWAX_TPU_PLATFORM=cpu`` asks for the CPU; the processes of a
one-host cluster share that card, each with its own CUDA context.
Without a card and without that setting, a flow with a device-tier
step raises instead of running on the CPU.
"""

import argparse
import ast
import inspect
import logging
import os
import signal
import sys
from datetime import timedelta
from pathlib import Path
from typing import Any, List, Optional, Tuple

#: Signals caught before the engine finished importing: the heavy
#: import of torch and the engine (in ``_main``, after the arguments
#: are parsed) takes seconds, and a k8s SIGTERM landing in that window
#: must become a graceful stop, not a default kill.  The stdlib-only
#: early handler records the request; ``_install_stop_handlers``
#: converts it into ``request_stop()`` once the engine is imported.  A
#: second signal (the early handler restores default handling) stays
#: fatal, so a stuck startup is killable.
_EARLY_STOP_SIGNALS: List[int] = []


def _early_stop_handler(signum: int, _frame: Any) -> None:
    _EARLY_STOP_SIGNALS.append(signum)
    signal.signal(signum, signal.SIG_DFL)


if __name__ == "__main__":  # CLI execution only, never plain import
    for _sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(_sig, _early_stop_handler)
        except ValueError:  # not the main thread
            break

__all__ = ["cli_main"]

logger = logging.getLogger("bytewax_tpu_torch")


def _prepare_import(import_str: str) -> Tuple[str, str]:
    """Resolve a ``module:attr`` import string; bare ``.py`` paths are
    converted to module paths rooted at the CWD."""
    if ":" in import_str:
        module_str, _, dataflow_name = import_str.partition(":")
    else:
        module_str, dataflow_name = import_str, "flow"
    path = Path(module_str)
    if path.suffix == ".py" or path.is_file():
        path = path.resolve()
        module_name = path.stem
        search_path = str(path.parent)
        if search_path not in sys.path:
            sys.path.insert(0, search_path)
        return module_name, dataflow_name
    return module_str, dataflow_name


def _locate_dataflow(module_name: str, dataflow_name: str):
    """Import a module and find the Dataflow in it: a variable name or
    a zero-/literal-arg factory call (Flask-style)."""
    from bytewax_tpu_torch.dataflow import Dataflow

    __import__(module_name)
    module = sys.modules[module_name]

    try:
        expr = ast.parse(dataflow_name.strip(), mode="eval").body
    except SyntaxError:
        msg = (
            f"failed to parse {dataflow_name!r} as an attribute name "
            "or function call"
        )
        raise SyntaxError(msg) from None

    if isinstance(expr, ast.Name):
        name, args, kwargs = expr.id, [], {}
    elif isinstance(expr, ast.Call):
        if not isinstance(expr.func, ast.Name):
            msg = f"function reference must be a simple name: {dataflow_name!r}"
            raise TypeError(msg)
        name = expr.func.id
        try:
            args = [ast.literal_eval(arg) for arg in expr.args]
            kwargs = {
                str(kw.arg): ast.literal_eval(kw.value)
                for kw in expr.keywords
            }
        except ValueError:
            msg = f"failed to parse arguments as literal values: {dataflow_name!r}"
            raise ValueError(msg) from None
    else:
        msg = (
            f"failed to parse {dataflow_name!r} as an attribute name "
            "or function call"
        )
        raise ValueError(msg)

    try:
        attr = getattr(module, name)
    except AttributeError as ex:
        msg = f"failed to find attribute {name!r} in {module.__name__!r}"
        raise AttributeError(msg) from ex

    flow = attr(*args, **kwargs) if inspect.isfunction(attr) else attr
    if isinstance(flow, Dataflow):
        return flow
    msg = (
        "a valid dataflow was not obtained from "
        f"'{module.__name__}:{dataflow_name}'"
    )
    raise RuntimeError(msg)


class _EnvDefault(argparse.Action):
    """argparse action falling back to an environment variable."""

    def __init__(self, envvar, required=False, default=None, **kwargs):
        if envvar and envvar in os.environ:
            default = os.environ[envvar]
            if kwargs.get("type") is not None and isinstance(default, str):
                default = kwargs["type"](default)
            required = False
        super().__init__(default=default, required=required, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)


def _parse_timedelta(s: str) -> timedelta:
    return timedelta(seconds=float(s))


def _create_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m bytewax_tpu_torch.run",
        description="Run a bytewax_tpu_torch dataflow",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "import_str",
        type=str,
        help="Dataflow import string: <module>[:<variable_or_factory>], "
        "e.g. src.flow, src.flow:flow, or src.flow:get_flow('arg')",
    )
    scaling = parser.add_argument_group(
        "Scaling",
        "How many workers (logical key-shard lanes) to run",
    )
    scaling.add_argument(
        "-w",
        "--workers-per-process",
        type=int,
        default=None,
        help="Number of worker lanes for this process",
        action=_EnvDefault,
        envvar="BYTEWAX_WORKERS_PER_PROCESS",
    )
    scaling.add_argument(
        "-i",
        "--process-id",
        type=int,
        default=None,
        help="Process id in the cluster",
        action=_EnvDefault,
        envvar="BYTEWAX_PROCESS_ID",
    )
    scaling.add_argument(
        "-a",
        "--addresses",
        type=str,
        default=None,
        help="Addresses of all processes, separated by ';'",
        action=_EnvDefault,
        envvar="BYTEWAX_ADDRESSES",
    )
    recovery = parser.add_argument_group(
        "Recovery", "See the bytewax_tpu_torch.recovery module for more info"
    )
    recovery.add_argument(
        "-r",
        "--recovery-directory",
        type=Path,
        help="Directory of pre-initialized recovery partitions "
        "(see `python -m bytewax_tpu_torch.recovery`)",
        action=_EnvDefault,
        envvar="BYTEWAX_RECOVERY_DIRECTORY",
    )
    recovery.add_argument(
        "-s",
        "--snapshot-interval",
        type=_parse_timedelta,
        help="System time duration in seconds between state snapshots "
        "(the epoch interval)",
        action=_EnvDefault,
        envvar="BYTEWAX_SNAPSHOT_INTERVAL",
    )
    recovery.add_argument(
        "-b",
        "--backup-interval",
        type=_parse_timedelta,
        help="System time duration in seconds to keep superseded "
        "snapshots around; set to your backup cadence",
        action=_EnvDefault,
        envvar="BYTEWAX_RECOVERY_BACKUP_INTERVAL",
    )
    recovery.add_argument(
        "--rescale",
        action="store_true",
        default=os.environ.get("BYTEWAX_TPU_RESCALE", "0")
        not in ("", "0"),
        help="Enable rescale-on-resume: when the recovery store was "
        "written by a different worker count, migrate its keyed "
        "state to this cluster's routing at run startup instead of "
        "refusing with WorkerCountMismatchError "
        "(env: BYTEWAX_TPU_RESCALE=1)",
    )
    supervision = parser.add_argument_group(
        "Supervision",
        "Restart this worker in place after restartable faults "
        "(peer death, epoch stalls, snapshot hiccups), resuming from "
        "the last committed epoch",
    )
    supervision.add_argument(
        "--max-restarts",
        type=int,
        default=None,
        help="Supervised restarts before giving up (0 disables "
        "supervision)",
        action=_EnvDefault,
        envvar="BYTEWAX_TPU_MAX_RESTARTS",
    )
    supervision.add_argument(
        "--restart-backoff",
        type=float,
        default=None,
        help="Initial restart backoff in seconds (doubles per "
        "attempt, capped at 30s)",
        action=_EnvDefault,
        envvar="BYTEWAX_TPU_RESTART_BACKOFF_S",
    )
    autoscale = parser.add_argument_group(
        "Autoscaling",
        "Run under the outer cluster supervisor "
        "(python -m bytewax_tpu_torch.supervise): it spawns the cluster "
        "processes, relaunches hard-dead ones, and acts on the "
        "engine's rescale_hint by gracefully draining the cluster "
        "and relaunching it at a better size",
    )
    autoscale.add_argument(
        "--autoscale",
        type=str,
        default=None,
        metavar="MIN:MAX",
        help="Process-count bounds, e.g. 2:8; implies spawning and "
        "supervising the whole cluster from this command",
    )
    return parser


def _install_stop_handlers() -> None:
    """SIGTERM/SIGINT request a graceful drain-to-stop (the flow
    commits the in-flight epoch at the next close and exits with a
    GracefulStop status); a second signal restores default handling,
    so a stuck drain stays killable.  A signal already caught by the
    early import-window handler above is converted into the stop
    request here — the request then survives until the execution's
    first epoch close."""
    from bytewax_tpu_torch.engine.driver import request_stop

    if _EARLY_STOP_SIGNALS:
        request_stop("signal")

    def _handler(signum: int, _frame: Any) -> None:
        signal.signal(signum, signal.SIG_DFL)
        request_stop("signal")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except ValueError:  # not the main thread (embedded use)
            return


def _parse_args(argv=None) -> argparse.Namespace:
    parser = _create_arg_parser()
    args = parser.parse_args(argv)

    env = os.environ
    # k8s/helm conventions: pod ordinal becomes the process id, and a
    # hostfile provides the address list.
    if args.process_id is None:
        if "BYTEWAX_POD_NAME" in env and "BYTEWAX_STATEFULSET_NAME" in env:
            args.process_id = int(
                env["BYTEWAX_POD_NAME"].replace(
                    env["BYTEWAX_STATEFULSET_NAME"] + "-", ""
                )
            )
    if args.process_id is not None and args.addresses is None:
        if "BYTEWAX_HOSTFILE_PATH" in env:
            with open(env["BYTEWAX_HOSTFILE_PATH"]) as hostfile:
                args.addresses = ";".join(
                    addr.strip() for addr in hostfile if addr.strip()
                )
        else:
            parser.error("the addresses option is required if a process_id is passed")

    if args.recovery_directory is not None and (
        args.snapshot_interval is None or args.backup_interval is None
    ):
        parser.error(
            "when running with recovery, the `-s/--snapshot-interval` and "
            "`-b/--backup-interval` values must be set"
        )
    return args


def cli_main(
    flow,
    *,
    workers_per_process: Optional[int] = None,
    process_id: Optional[int] = None,
    addresses: Optional[str] = None,
    epoch_interval: Optional[timedelta] = None,
    recovery_config: Optional[Any] = None,
) -> Optional[Any]:
    """Dispatch to ``run_main`` or ``cluster_main`` based on args.
    Returns the entry point's completion status (``None`` on EOF, a
    typed ``GracefulStop`` after a cooperative drain-to-stop)."""
    from bytewax_tpu_torch.engine.driver import cluster_main, run_main

    if process_id is not None or (workers_per_process or 0) > 1 or addresses:
        addr_list = addresses.split(";") if addresses else []
        return cluster_main(
            flow,
            addr_list,
            process_id or 0,
            epoch_interval=epoch_interval,
            recovery_config=recovery_config,
            worker_count_per_proc=workers_per_process or 1,
        )
    return run_main(
        flow,
        epoch_interval=epoch_interval,
        recovery_config=recovery_config,
    )


def _main() -> None:
    args = _parse_args()
    # The supervisor reads these from the environment (it lives below
    # the entry-point signatures); the flags just provide CLI parity.
    if args.max_restarts is not None:
        os.environ["BYTEWAX_TPU_MAX_RESTARTS"] = str(args.max_restarts)
    if args.restart_backoff is not None:
        os.environ["BYTEWAX_TPU_RESTART_BACKOFF_S"] = str(
            args.restart_backoff
        )
    if args.rescale:
        os.environ["BYTEWAX_TPU_RESCALE"] = "1"
    if args.autoscale is not None:
        # Outer-supervisor mode: this process spawns and watches the
        # cluster instead of running the flow (the children import
        # the dataflow; the supervisor never imports torch).
        if _EARLY_STOP_SIGNALS:
            # Termination was requested while this module was still
            # importing: there is nothing to drain yet — honor it by
            # not launching the cluster at all.
            logger.warning(
                "termination requested during startup; not "
                "launching the autoscaler"
            )
            sys.exit(0)
        from bytewax_tpu_torch.supervise import autoscale_main

        sys.exit(
            autoscale_main(
                args.import_str,
                args.autoscale,
                workers_per_process=args.workers_per_process,
                recovery_directory=args.recovery_directory,
                snapshot_interval=args.snapshot_interval,
                backup_interval=args.backup_interval,
            )
        )
    from bytewax_tpu_torch.recovery import RecoveryConfig

    _install_stop_handlers()
    module_str, dataflow_name = _prepare_import(args.import_str)
    flow = _locate_dataflow(module_str, dataflow_name)
    recovery_config = None
    if args.recovery_directory is not None:
        recovery_config = RecoveryConfig(
            args.recovery_directory, backup_interval=args.backup_interval
        )
    status = cli_main(
        flow,
        workers_per_process=args.workers_per_process,
        process_id=args.process_id,
        addresses=args.addresses,
        epoch_interval=args.snapshot_interval,
        recovery_config=recovery_config,
    )
    if status is not None:
        logger.warning("graceful stop: %r", status)


if __name__ == "__main__":
    _main()

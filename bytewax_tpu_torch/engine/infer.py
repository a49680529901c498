"""Device-tier batched model scoring (``op.infer`` lowering).

The user supplies a torch ``apply_fn(params, x)`` over tensors plus a
params pytree (nested dicts, lists and tuples of arrays); the engine
runs it over each micro-batch's feature rows, on the device tier's
device and through the same dispatch pipeline
(:mod:`bytewax_tpu_torch.engine.pipeline`) every other device-tier
step uses.  The function runs eagerly: no ``torch.compile``, so no
first-call compile lands inside a run.  Scoring is stateless per row,
so there is no slot table: the one piece of state is the params pytree
itself, kept as a host numpy tree plus a device copy, and treated as
broadcast state:

* snapshot-covered — the params (plus generation/digest bookkeeping)
  round-trip through the recovery store under the single reserved key
  :data:`PARAMS_KEY`, in a host-format dict interchangeable between
  the device and host tiers, and with the JAX package's stores;
* demotable — repeated :class:`~bytewax_tpu_torch.errors.DeviceFault`
  drops the step to :class:`HostInferState`, a numpy apply over the
  same snapshot (``demotion_snapshots`` drains exactly the params row);
* hot-swappable — a pending update installs at an agreed epoch close
  (driver-side; see ``_Driver._apply_params_swap``), bumping the
  generation and digest recorded here.

Params shapes and dtypes are pinned at construction: a swap must match
the current tree structure and leaf shapes (leaves are cast to the
incumbent dtypes).
"""

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bytewax_tpu_torch.engine import flight as _flight
from bytewax_tpu_torch.engine.xla import NonNumericValues

__all__ = [
    "PARAMS_KEY",
    "InferAccelSpec",
    "DeviceInferState",
    "HostInferState",
    "normalize_params",
    "params_digest",
]

#: The one broadcast-state snapshot key an infer step writes.  A
#: reserved name (user keys flow through infer untouched, but never
#: into its snapshots) so resume can read it route-agnostically.
PARAMS_KEY = "_params"


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Structure-preserving map over dict/list/tuple pytrees."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any, out: Optional[List[Any]] = None) -> List[Any]:
    if out is None:
        out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            _tree_leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_leaves(v, out)
    else:
        out.append(tree)
    return out


def _treedef(tree: Any) -> Any:
    """Hashable structural summary (structure + leaf dtype/shape)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _treedef(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_treedef(v) for v in tree))
    a = np.asarray(tree)
    return ("leaf", str(a.dtype), a.shape)


def _cast_like(old: Any, new: Any) -> Any:
    """Cast ``new``'s leaves to ``old``'s dtypes; raise ``ValueError``
    on any structure or leaf-shape mismatch (the swap-compatibility
    check)."""
    if isinstance(old, dict):
        if not isinstance(new, dict) or set(old) != set(new):
            msg = f"params tree mismatch: {sorted(old)} vs new"
            raise ValueError(msg)
        return {k: _cast_like(old[k], new[k]) for k in old}
    if isinstance(old, (list, tuple)):
        if not isinstance(new, (list, tuple)) or len(new) != len(old):
            msg = "params tree mismatch: sequence arity differs"
            raise ValueError(msg)
        return type(old)(_cast_like(o, n) for o, n in zip(old, new))
    o = np.asarray(old)
    n = np.asarray(new)
    if o.shape != n.shape:
        msg = f"params leaf shape mismatch: {n.shape} vs {o.shape}"
        raise ValueError(msg)
    return np.asarray(n, dtype=o.dtype)


def _host_leaf(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def normalize_params(params: Any) -> Any:
    """Materialize every leaf as a host numpy array (snapshot form)."""
    return _tree_map(_host_leaf, params)


def params_digest(params: Any) -> str:
    """Content digest of a params pytree: structure + leaf bytes.
    Deterministic across processes (and the same as the JAX
    package's), so the cluster-wide swap agreement can compare digests
    instead of shipping params over the mesh.

    >>> import numpy as np
    >>> a = params_digest(normalize_params({"w": np.float32(1.0)}))
    >>> b = params_digest(normalize_params({"w": np.float32(2.0)}))
    >>> len(a), a == b
    (16, False)
    """
    h = hashlib.blake2b(digest_size=8)
    h.update(repr(_treedef(params)).encode())
    for leaf in _tree_leaves(params):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


def extract_features(items: Any) -> Tuple[List[str], np.ndarray]:
    """Keys + a float32 ``[N, F]`` feature matrix from one delivery.

    Accepts a columnar :class:`~bytewax_tpu_torch.engine.arrays.ArrayBatch`
    (the ``value`` column is one feature) or an itemized list of
    ``(key, value)`` rows where ``value`` is a numeric scalar or a
    fixed-width tuple/list of numerics.  Raises
    :class:`~bytewax_tpu_torch.engine.xla.NonNumericValues` otherwise:
    an infer step requires numeric features.
    """
    from bytewax_tpu_torch.engine.arrays import ArrayBatch
    from bytewax_tpu_torch.engine.scan_accel import _batch_keys

    if isinstance(items, ArrayBatch):
        keys = [str(k) for k in _batch_keys(items).tolist()]
        values = items._scaled_values()
        if values.dtype == object or values.dtype.kind in "USb":
            msg = "op.infer requires numeric feature values"
            raise NonNumericValues(msg)
        feats = np.asarray(values, dtype=np.float32).reshape(len(keys), -1)
        return keys, feats
    keys = []
    rows = []
    width = None
    for kv in items:
        try:
            key, value = kv
        except (TypeError, ValueError) as ex:
            msg = "op.infer requires (key, value) 2-tuples from upstream"
            raise NonNumericValues(msg) from ex
        row = list(value) if isinstance(value, (tuple, list)) else [value]
        if width is None:
            width = len(row)
        elif len(row) != width:
            msg = (
                "op.infer requires fixed-width feature rows; got "
                f"widths {width} and {len(row)}"
            )
            raise NonNumericValues(msg)
        keys.append(str(key))
        rows.append(row)
    try:
        feats = np.asarray(rows, dtype=np.float32)
    except (TypeError, ValueError) as ex:
        msg = "op.infer requires numeric feature values"
        raise NonNumericValues(msg) from ex
    if feats.ndim == 1:
        feats = feats.reshape(len(keys), -1)
    return keys, feats


def _out_columns(out: Any) -> Tuple[Any, ...]:
    """Normalize an apply output into per-row columns: a 1-d array is
    one column, a 2-d ``[N, K]`` array is K columns, a tuple/list is
    taken column-wise."""
    if isinstance(out, (tuple, list)):
        return tuple(out)
    if getattr(out, "ndim", 1) == 2:
        return tuple(out[:, j] for j in range(out.shape[1]))
    return (out,)


def assemble_items(
    keys: List[str], cols: Tuple[np.ndarray, ...]
) -> List[Tuple[str, Any]]:
    """Zip scored columns back into ``(key, out)`` items, in the
    incoming row order (scoring is stateless: no regrouping).  One
    output column emits bare scalars; several emit tuples."""
    if len(cols) == 1:
        return list(zip(keys, cols[0].tolist()))
    return list(zip(keys, zip(*(c.tolist() for c in cols))))


def _params_on(host: Any, device: torch.device) -> Any:
    """The params tree as tensors on ``device``."""
    return _tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), host)


def _columns_to_host(cols: Tuple[Any, ...]) -> Tuple[np.ndarray, ...]:
    """Output columns to host numpy, with one copy when they share a
    dtype and a device."""
    tensors = [torch.as_tensor(col) for col in cols]
    if len({(t.dtype, t.device) for t in tensors}) == 1:
        return tuple(torch.stack(tensors).cpu().numpy())
    return tuple(t.cpu().numpy() for t in tensors)


class _ParamsHolder:
    """Shared broadcast-params bookkeeping for both tiers: the host
    snapshot form, the generation counter, the content digest, and
    the epoch the last swap landed at."""

    def __init__(self, params: Any):
        self._host = normalize_params(params)
        self.generation = 0
        self.digest = params_digest(self._host)
        self.swap_epoch = 0

    def snapshot_state(self) -> Dict[str, Any]:
        """Host-format broadcast-state snapshot — the one row an
        infer step writes, interchangeable between tiers."""
        return {
            "generation": self.generation,
            "digest": self.digest,
            "swap_epoch": self.swap_epoch,
            "params": self._host,
        }

    def _load_snapshot(self, snap: Dict[str, Any]) -> None:
        self._host = normalize_params(snap["params"])
        self.generation = int(snap["generation"])
        self.digest = str(snap["digest"])
        self.swap_epoch = int(snap["swap_epoch"])

    def _swap_host(self, params: Any, digest: str, epoch: int) -> Any:
        """Validate + cast an incoming params tree against the
        incumbent; returns the cast tree or ``None`` on mismatch (the
        caller skips the swap deterministically — every process sees
        the same trees, so every process skips together)."""
        try:
            cast = _cast_like(self._host, normalize_params(params))
        except ValueError:
            return None
        self._host = cast
        self.generation += 1
        self.digest = digest
        self.swap_epoch = epoch
        return cast


class InferAccelSpec:
    """Annotation on a core ``stateful_batch``: lower the enclosing
    ``infer`` step to a device-tier batched forward pass."""

    def __init__(
        self,
        apply_fn: Callable[[Any, Any], Any],
        params: Any,
        host_apply: Optional[Callable[[Any, np.ndarray], Any]] = None,
    ):
        if not callable(apply_fn):
            msg = f"InferAccelSpec takes a callable apply_fn; got {apply_fn!r}"
            raise TypeError(msg)
        self.apply_fn = apply_fn
        self.params = normalize_params(params)
        self.host_apply = host_apply

    def make_state(self) -> "DeviceInferState":
        return DeviceInferState(self)

    def make_host_state(
        self, snap: Optional[Dict[str, Any]] = None
    ) -> "HostInferState":
        return HostInferState(self, snap)

    def __repr__(self) -> str:
        return f"InferAccelSpec({self.apply_fn!r})"


class DeviceInferState(_ParamsHolder):
    """Device-resident broadcast params and the forward pass for one
    lowered ``infer`` step, on ``device`` (default:
    :func:`bytewax_tpu_torch.utils.device`).

    ``score_rows`` copies each ``[N, F]`` feature matrix to the device
    and calls ``apply_fn(params, x)`` with the params as tensors there;
    a swap replaces the device copy.
    """

    def __init__(self, spec: InferAccelSpec, device: Optional[torch.device] = None):
        if device is None:
            from bytewax_tpu_torch.utils import device as _device

            device = _device()
        super().__init__(spec.params)
        self.spec = spec
        self.device = torch.device(device)
        self._params = _params_on(self._host, self.device)

    # -- scoring -----------------------------------------------------------

    def score_rows(self, feats: np.ndarray) -> Tuple[np.ndarray, ...]:
        """The forward pass over ``[N, F]`` float32 rows; returns host
        numpy output columns."""
        x = torch.from_numpy(np.ascontiguousarray(feats, dtype=np.float32)).to(self.device)
        _flight.note_transfer("h2d", x.nbytes)
        with torch.no_grad():
            out = self.spec.apply_fn(self._params, x)
        host = _columns_to_host(_out_columns(out))
        _flight.note_transfer("d2h", sum(col.nbytes for col in host))
        return host

    # -- broadcast-state lifecycle -----------------------------------------

    def install(self, params: Any, digest: str, epoch: int) -> bool:
        """Hot-swap the broadcast params (epoch-close only — the
        driver's ``install_params`` drain path is the sole caller)."""
        cast = self._swap_host(params, digest, epoch)
        if cast is None:
            return False
        self._params = _params_on(cast, self.device)
        return True

    def load_state(self, snap: Dict[str, Any]) -> None:
        """Resume-path restore: adopt a stored snapshot wholesale
        (exact params generation, not just the values)."""
        self._load_snapshot(snap)
        self._params = _params_on(self._host, self.device)

    def snapshots_for(self, keys: List[str]) -> List[Tuple[str, Any]]:
        return [
            (k, self.snapshot_state() if k == PARAMS_KEY else None)
            for k in keys
        ]

    def demotion_snapshots(self) -> List[Tuple[str, Any]]:
        """Full-state drain for device→host demotion: broadcast
        params are the entire state, one row."""
        return [(PARAMS_KEY, self.snapshot_state())]

    def flush(self) -> None:
        """Block until the device has run everything queued on it
        (scoring results are read back inside their own lane task)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class HostInferState(_ParamsHolder):
    """Host-tier apply over the same broadcast-state snapshot — the
    demotion target, and the whole tier when the accelerator is off
    (``BYTEWAX_TPU_ACCEL=0`` / ``BYTEWAX_TPU_INFER_DEVICE=0``).

    Scores through the user's ``host_apply`` numpy twin when given;
    otherwise calls ``apply_fn`` on CPU tensors (fine with the
    accelerator off; a real device fault wants ``host_apply``).
    """

    def __init__(
        self, spec: InferAccelSpec, snap: Optional[Dict[str, Any]] = None
    ):
        super().__init__(spec.params)
        self.spec = spec
        if snap is not None:
            self._load_snapshot(snap)

    def score_rows(self, feats: np.ndarray) -> Tuple[np.ndarray, ...]:
        feats = np.asarray(feats, dtype=np.float32)
        if self.spec.host_apply is not None:
            out = self.spec.host_apply(self._host, feats)
            return tuple(np.asarray(col) for col in _out_columns(out))
        params = _params_on(self._host, torch.device("cpu"))
        with torch.no_grad():
            out = self.spec.apply_fn(params, torch.from_numpy(feats))
        return _columns_to_host(_out_columns(out))

    def install(self, params: Any, digest: str, epoch: int) -> bool:
        return self._swap_host(params, digest, epoch) is not None

    def load_state(self, snap: Dict[str, Any]) -> None:
        self._load_snapshot(snap)

"""BTX-SEND — all data sends ride the sanctioned surfaces.

The epoch barrier's quiescence check counts frames per
``ship_deliver``/``ship_route`` call; a raw ``Comm.send`` /
``Comm.broadcast`` anywhere else puts uncounted traffic on the mesh
and silently breaks the count-matched close.  This rule resolves
receivers and aliases (``c = self.comm; c.send(...)`` is flagged —
the regex scan it replaced provably missed that shape) and restricts:

- ``Comm(...)`` construction to ``engine/comm.py`` + ``engine/driver.py``
- ``send``/``broadcast`` on a Comm-denoting receiver to the same pair
- ``ship_deliver``/``ship_route``/``ship_flush`` calls to
  ``engine/driver.py``
- resolved calls into the columnar wire codec (``engine/wire.py``) to
  the comm/driver pair — payload encoding is part of the send
  surface, and a third caller framing its own payloads would be a
  covert channel around the counted ship surfaces
"""

from typing import List

from bytewax_tpu_torch.analysis import contracts
from bytewax_tpu_torch.analysis.diagnostics import Diagnostic
from bytewax_tpu_torch.analysis.resolver import Project
from bytewax_tpu_torch.analysis.rules._util import comm_receiver_events

RULE_ID = "BTX-SEND"

_WHAT = {
    "comm_construct": (
        "Comm construction (a second mesh bypasses the epoch "
        "barrier's frame counting)"
    ),
    "raw_send": (
        "raw cluster send (route data through ship_deliver/"
        "ship_route and control metadata through driver.global_sync)"
    ),
    "ship": "routed-send surface call (driver-internal)",
}

_ALLOWED = {
    "comm_construct": contracts.SEND_ALLOWED["comm_construct"],
    "raw_send": contracts.SEND_ALLOWED["raw_send"],
    "ship": contracts.SEND_ALLOWED["ship"],
}


def _wire_calls(mod, fn):
    """Calls in ``fn`` that RESOLVE into the wire codec module —
    dotted paths (``_wire.encode``) and import-resolved names; the
    visible-name fallback is excluded so an unrelated ``x.decode()``
    / ``x.add()`` with an unknown receiver cannot false-fire."""
    prefix_dot = contracts.WIRE_MODULE + "."
    prefix_fn = contracts.WIRE_MODULE + ":"
    for call in fn.calls:
        if call.dotted is not None and call.dotted.startswith(prefix_dot):
            yield call.node
        elif not call.fallback and any(
            t.startswith(prefix_fn) for t in call.targets
        ):
            yield call.node


def check(project: Project) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for mod in project.modules.values():
        for fn in mod.functions.values():
            if fn.nested:
                continue  # enclosing body walk already covers these
            for kind, call in comm_receiver_events(project, mod, fn):
                if mod.name in _ALLOWED[kind]:
                    continue
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        call.lineno,
                        f"{_WHAT[kind]} in {fn.qualname}; allowed "
                        f"modules: "
                        f"{sorted(_ALLOWED[kind])}",
                    )
                )
            if mod.name in contracts.WIRE_ALLOWED_MODULES:
                continue
            for node in _wire_calls(mod, fn):
                out.append(
                    Diagnostic(
                        RULE_ID,
                        mod.rel,
                        node.lineno,
                        "wire-codec call (engine/wire.py is part of "
                        f"the send surface) in {fn.qualname}; "
                        "allowed modules: "
                        f"{sorted(contracts.WIRE_ALLOWED_MODULES)}",
                    )
                )
    return out

"""Render a dataflow graph as JSON or Mermaid.

Reference parity: upstream bytewax ``pysrc/bytewax/visualize.py``.
Used by the dataflow webserver's ``GET /dataflow``.

```console
$ python -m bytewax_tpu_torch.visualize my_flow:flow --format mermaid
```
"""

import argparse
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List

from bytewax_tpu_torch.dataflow import Dataflow, Operator, Stream

__all__ = [
    "RenderedDataflow",
    "RenderedOperator",
    "RenderedPort",
    "render_dataflow",
    "to_json",
    "to_mermaid",
    "to_plan",
    "to_plantuml",
    "to_rendered",
]


@dataclass(frozen=True)
class RenderedPort:
    """A port and the stream ids wired into/out of it."""

    port_name: str
    port_id: str
    from_port_ids: List[str]
    from_stream_ids: List[str]


@dataclass(frozen=True)
class RenderedOperator:
    """One operator node in the rendered tree."""

    op_type: str
    step_name: str
    step_id: str
    inp_ports: List[RenderedPort]
    out_ports: List[RenderedPort]
    substeps: List["RenderedOperator"]


@dataclass(frozen=True)
class RenderedDataflow:
    """Renderable facsimile of a dataflow."""

    flow_id: str
    substeps: List[RenderedOperator]


def _render_op(op: Operator) -> RenderedOperator:
    inp_ports = []
    for name, val in op.ups.items():
        streams = [val] if isinstance(val, Stream) else list(val)
        inp_ports.append(
            RenderedPort(
                port_name=name,
                port_id=f"{op.step_id}.{name}",
                from_port_ids=[s.stream_id for s in streams],
                from_stream_ids=[s.stream_id for s in streams],
            )
        )
    out_ports = [
        RenderedPort(
            port_name=name,
            port_id=s.stream_id,
            from_port_ids=[],
            from_stream_ids=[],
        )
        for name, s in op.downs.items()
    ]
    return RenderedOperator(
        op_type=op.name,
        step_name=op.step_name,
        step_id=op.step_id,
        inp_ports=inp_ports,
        out_ports=out_ports,
        substeps=[_render_op(sub) for sub in op.substeps],
    )


def render_dataflow(flow: Dataflow) -> RenderedDataflow:
    """Convert a dataflow into the renderable tree.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource
    >>> from bytewax_tpu_torch.visualize import render_dataflow
    >>> flow = Dataflow("viz")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> op.output("out", s, TestingSink([]))
    >>> rendered = render_dataflow(flow)
    >>> [sub.op_type for sub in rendered.substeps]
    ['input', 'output']
    """
    return RenderedDataflow(
        flow_id=flow.flow_id,
        substeps=[_render_op(op) for op in flow.substeps],
    )


def to_json(flow: Dataflow) -> str:
    """Render a dataflow as JSON (served by ``GET /dataflow``).

    >>> import json
    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource
    >>> from bytewax_tpu_torch.visualize import to_json
    >>> flow = Dataflow("viz")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> op.output("out", s, TestingSink([]))
    >>> json.loads(to_json(flow))["flow_id"]
    'viz'
    """
    return json.dumps(asdict(render_dataflow(flow)), indent=2)


def _owner_of(component_ids: List[str], stream_id: str) -> str:
    """Resolve the step that owns ``stream_id``: the longest component
    id that is a dotted prefix of it (a stream produced by a nested
    substep belongs to the innermost rendered component)."""
    best = ""
    for step_id in component_ids:
        if (
            stream_id == step_id or stream_id.startswith(step_id + ".")
        ) and len(step_id) > len(best):
            best = step_id
    return best or stream_id.rsplit(".", 1)[0]


def to_mermaid(flow: Dataflow) -> str:
    """Render the top level of a dataflow as a Mermaid graph.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource
    >>> from bytewax_tpu_torch.visualize import to_mermaid
    >>> flow = Dataflow("viz")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> op.output("out", s, TestingSink([]))
    >>> print(to_mermaid(flow))
    flowchart TD
    subgraph "viz (Dataflow)"
    viz.inp["input (viz.inp)"]
    viz.out["output (viz.out)"]
    viz.inp --> viz.out
    end
    """
    rendered = render_dataflow(flow)
    top_ids = [op.step_id for op in rendered.substeps]

    lines = ["flowchart TD", f'subgraph "{rendered.flow_id} (Dataflow)"']
    for op in rendered.substeps:
        lines.append(f'{op.step_id}["{op.op_type} ({op.step_id})"]')
        for port in op.inp_ports:
            for sid in port.from_stream_ids:
                lines.append(f"{_owner_of(top_ids, sid)} --> {op.step_id}")
    lines.append("end")
    return "\n".join(lines)


def to_plan(flow: Dataflow) -> Dict[str, Any]:
    """Render the flattened core-operator plan (engine's view),
    including XLA-tier lowering annotations.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource
    >>> from bytewax_tpu_torch.visualize import to_plan
    >>> flow = Dataflow("viz")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> op.output("out", s, TestingSink([]))
    >>> [step["op_type"] for step in to_plan(flow)["core_ops"]]
    ['input', 'output']
    """
    from bytewax_tpu_torch.engine.flatten import flatten

    plan = flatten(flow)
    return {
        "flow_id": flow.flow_id,
        "core_ops": [
            {
                "step_id": op.step_id,
                "op_type": op.name,
                "ups": {
                    name: [
                        s.stream_id
                        for s in ([v] if isinstance(v, Stream) else v)
                    ]
                    for name, v in op.ups.items()
                },
                "downs": {
                    name: s.stream_id for name, s in op.downs.items()
                },
                "accel": repr(op.conf["_accel"]) if "_accel" in op.conf else None,
            }
            for op in plan.ops
        ],
    }


def to_rendered(flow: Dataflow) -> RenderedDataflow:
    """Alias of :func:`render_dataflow` (reference API name,
    ``visualize.py:119``)."""
    return render_dataflow(flow)


def to_plantuml(flow: Dataflow, recursive: bool = False) -> str:
    """Render a dataflow as a PlantUML component diagram
    (reference parity: ``visualize.py:252``).

    :arg recursive: Also show nested substeps as nested components.

    >>> import bytewax_tpu_torch.operators as op
    >>> from bytewax_tpu_torch.dataflow import Dataflow
    >>> from bytewax_tpu_torch.testing import TestingSink, TestingSource
    >>> from bytewax_tpu_torch.visualize import to_plantuml
    >>> flow = Dataflow("viz")
    >>> s = op.input("inp", flow, TestingSource([1]))
    >>> op.output("out", s, TestingSink([]))
    >>> print(to_plantuml(flow))
    @startuml
    component "input (viz.inp)" as viz.inp
    component "output (viz.out)" as viz.out
    viz.inp --> viz.out
    @enduml
    """
    rendered = render_dataflow(flow)
    shown: List[RenderedOperator] = []

    def emit(op: RenderedOperator, depth: int) -> List[str]:
        shown.append(op)
        pad = "  " * depth
        lines = [f'{pad}component "{op.op_type} ({op.step_id})" as {op.step_id}']
        if recursive and op.substeps:
            lines[-1] += " {"
            for sub in op.substeps:
                lines.extend(emit(sub, depth + 1))
            lines.append(f"{pad}}}")
        return lines

    lines = ["@startuml"]
    for op in rendered.substeps:
        lines.extend(emit(op, 0))
    # Wire every shown component (nested included when recursive);
    # each edge source resolves to the innermost shown component that
    # produced the stream.
    shown_ids = [op.step_id for op in shown]
    for op in shown:
        for port in op.inp_ports:
            for sid in port.from_stream_ids:
                src = _owner_of(shown_ids, sid)
                if src != op.step_id:
                    lines.append(f"{src} --> {op.step_id}")
    lines.append("@enduml")
    return "\n".join(lines)


def _main() -> None:
    from bytewax_tpu_torch.run import _locate_dataflow, _prepare_import

    parser = argparse.ArgumentParser(
        prog="python -m bytewax_tpu_torch.visualize",
        description="Render a dataflow graph",
    )
    parser.add_argument("import_str", type=str)
    parser.add_argument(
        "--format",
        choices=["json", "mermaid", "plantuml", "plan"],
        default="mermaid",
    )
    parser.add_argument(
        "--recursive",
        action="store_true",
        help="show nested substeps (plantuml only)",
    )
    args = parser.parse_args()
    module_str, dataflow_name = _prepare_import(args.import_str)
    flow = _locate_dataflow(module_str, dataflow_name)
    if args.format == "json":
        print(to_json(flow))
    elif args.format == "plan":
        print(json.dumps(to_plan(flow), indent=2))
    elif args.format == "plantuml":
        print(to_plantuml(flow, recursive=args.recursive))
    else:
        print(to_mermaid(flow))


if __name__ == "__main__":
    _main()

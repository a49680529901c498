"""Word-count flow (reference: ``examples/wordcount.py``)."""

from typing import Callable, Optional

import bytewax_tpu_torch.operators as op
from bytewax_tpu_torch.dataflow import Dataflow
from bytewax_tpu_torch.ops.text import TOKEN_RE as _TOKEN_RE
from bytewax_tpu_torch.outputs import Sink

__all__ = ["wordcount_flow"]


def wordcount_flow(
    source,
    sink: Sink,
    tokenizer: Optional[Callable[[str], list]] = None,
) -> Dataflow:
    """lines → lowercase → tokenize → count per word (emit at EOF).

    With the default tokenizer and a native toolchain, tokenization is
    one C pass per batch emitting dictionary-encoded ``(word_id, 1)``
    columns, and the count is a device scatter-add — no per-word
    Python objects anywhere.  A custom ``tokenizer`` (or no toolchain)
    runs the host-tier per-line path with identical output.
    """
    flow = Dataflow("wordcount")
    s = op.input("inp", flow, source)
    s = op.map("lower", s, str.lower)
    if tokenizer is None:
        from bytewax_tpu_torch.ops.text import native_tokenizer_available

        if native_tokenizer_available():
            from bytewax_tpu_torch.ops.text import WordTokenizer

            s = op.flat_map_batch("tokenize", s, WordTokenizer())
        else:
            s = op.flat_map("tokenize", s, _TOKEN_RE.findall)
    else:
        s = op.flat_map("tokenize", s, tokenizer)
    counts = op.count_final("count", s, lambda word: word)
    op.output("out", counts, sink)
    return flow

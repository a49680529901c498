"""BTX-GSYNC positive fixture: per-batch methods that reach a
collective imported from ``torch.distributed``'s defining submodule.

``FromImportShuffle.process`` calls ``all_to_all_single`` bound by
``from torch.distributed.distributed_c10d import ...``;
``ModuleShuffle.on_batch`` calls ``barrier`` through
``import torch.distributed.distributed_c10d as c10d``.  Both resolve
to a path longer than the cataloged ``torch.distributed.<name>``, and
both block every peer that did not see the same batch: the rule must
flag both chains.
"""

import torch
import torch.distributed.distributed_c10d as c10d
from torch.distributed.distributed_c10d import all_to_all_single


class FromImportShuffle:
    def _swap(self, send):
        recv = torch.empty_like(send)
        all_to_all_single(recv, send)
        return recv

    def process(self, port, entries):
        for _w, items in entries:
            self._swap(items)


class ModuleShuffle:
    def _fence(self):
        c10d.barrier()

    def on_batch(self, batch):
        self._fence()
        return batch

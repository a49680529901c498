"""BTX-GSYNC positive fixture: per-batch methods that reach a
cross-process ``torch.distributed`` collective.

``EagerShuffle.process`` reaches ``all_to_all_single`` through the
module-level ``import torch.distributed as dist``; ``LazyShuffle.
on_batch`` through an import inside its helper.  A process whose
peers did not receive the same delivery waits in the all-to-all
forever: the rule must flag both chains.
"""

import torch
import torch.distributed as dist


class EagerShuffle:
    def _swap(self, send):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return recv

    def process(self, port, entries):
        for _w, items in entries:
            self._swap(items)


class LazyShuffle:
    def _swap_lazily(self, send):
        import torch.distributed as tdist

        recv = torch.empty_like(send)
        tdist.all_to_all_single(recv, send)
        return recv

    def on_batch(self, batch):
        return self._swap_lazily(batch)

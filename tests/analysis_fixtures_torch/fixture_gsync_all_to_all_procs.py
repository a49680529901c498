"""BTX-GSYNC positive fixture: a per-batch path that enters the
cluster-wide exchange's all-to-all (``parallel/exchange.py``
``all_to_all_procs``) itself, instead of leaving it to the epoch
close's flush."""

from bytewax_tpu_torch.parallel.exchange import all_to_all_procs
from bytewax_tpu_torch.parallel.mesh import world


class RogueGlobalStep:
    def _ship_now(self, rows):
        return all_to_all_procs(world(), rows)

    def process(self, port, entries):
        for _w, items in entries:
            self._ship_now(items)

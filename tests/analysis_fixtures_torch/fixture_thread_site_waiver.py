"""BTX-THREAD site-waiver fixture: two worker-lane tasks reach a
method named ``emit`` that only computes columns.

Each ``emit`` call carries the site waiver, so ``QuietStep``'s task
is clean; ``LoudStep``'s task goes on past its waived call to a real
main-thread surface (``ship_flush``) in the same function, which must
still be reported.
"""

from bytewax_tpu_torch.engine.pipeline import DevicePipeline


class ColumnKind:
    def emit(self, pre, post):
        return [b - a for a, b in zip(pre, post)]

    def apply(self, pre, post):
        # bytewax: allow[BTX-THREAD] — emit computes columns and sends nothing
        return self.emit(pre, post)


class QuietStep:
    def __init__(self):
        self._pipe = DevicePipeline("quiet")
        self.kind = ColumnKind()

    def process(self, port, entries):
        def task():
            return self.kind.apply(entries, entries)

        def finalize(res):
            pass

        self._pipe.push(task, finalize)


class LoudStep:
    def __init__(self, driver):
        self._pipe = DevicePipeline("loud")
        self.kind = ColumnKind()
        self.driver = driver

    def _columns_then_ship(self, entries):
        # bytewax: allow[BTX-THREAD] — emit computes columns and sends nothing
        cols = self.kind.emit(entries, entries)
        self.driver.ship_flush()
        return cols

    def process(self, port, entries):
        def task():
            return self._columns_then_ship(entries)

        def finalize(res):
            pass

        self._pipe.push(task, finalize)

"""Waiver fixture: the same raw-send shape as fixture_send_alias,
suppressed by an inline ``# bytewax: allow[...]`` waiver — and a
string literal containing ``#`` that must NOT hide the call from the
analyzer (the old line-split comment stripping truncated here)."""


class WaivedOperator:
    def __init__(self, driver):
        self.comm = driver.comm

    def emergency_flush(self, w, items):
        # A sanctioned, documented exception would be waived like so:
        self.comm.send(w, ("deliver", 0, "up", (w, items)))  # bytewax: allow[BTX-SEND]

    def tagged_flush(self, w, items):
        tag = "#deliver"  # a '#' in a string is not a comment
        self.comm.send(w, (tag, items))  # bytewax: allow[BTX-SEND,BTX-FRAMES]

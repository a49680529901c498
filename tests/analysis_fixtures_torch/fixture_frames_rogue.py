"""BTX-FRAMES positive fixture: a frame kind outside the pinned
inventory, both handled and sent."""


class RogueDriver:
    def __init__(self, comm):
        self.comm = comm

    def _handle_ctrl(self, _src, msg):
        kind = msg[0]
        if kind == "deliver":
            pass
        elif kind == "rogue_frame":  # not in CONTROL_FRAMES
            pass

    def announce(self):
        self.comm.broadcast(("rogue_frame", 42))

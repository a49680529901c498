"""Feeds: how a traffic mix hands the generator's rows to the port.

A traffic file ``traffic/<mix>.json`` names its feed (``"feed"``) and
gives the feed's parameters; the harness loads ``feeds/<feed>.py`` by
that name.  A feed module has:

- ``GENERATOR``: the generator (``generators/<name>.py``) whose
  stream it hands over; a configuration that names another is refused;
- ``KEYS``: the parameters it reads; a traffic file that gives
  another, or lacks one, is refused;
- ``Feed(stream, traffic, workdir)``: its set-up (``workdir`` is a
  directory of its own under the run's ``TMPDIR``), with
  ``source(handed, seconds, max_blocks=None)``, the port's source for
  the warm-up (``max_blocks``) or the window (``seconds``), logging
  each ring entry it hands over in ``handed``, and ``close()``.
"""

"""One runner a kind of work (the ``runner`` of a traffic file): it
builds the program and the cell's inputs from the seed, drives the
measured window, and judges what the window produced against the
reference.  Each is ``Runner(cfg, mix, seed, device)`` with ``setup()``,
``window(seconds) -> dict``, ``end_to_end(window) -> dict``,
``release()`` and ``check() -> {name: value}``."""

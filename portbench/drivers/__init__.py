"""Drivers of the traffic kinds, one module per ``kind`` of a mix: each
gives ``Driver(config, traffic, seed, device)`` with ``setup``,
``window``, ``free_program`` and ``check``."""

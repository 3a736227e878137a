"""Drivers of the benchmark's cells, one module a family of configurations,
found by the configuration file's ``family`` key (``snn`` where it has
none; ``run.family_module``).  Each has ``run_cell(spec, seed, seconds,
trace, device, make_net=None, t_start=None) -> (line, numbers)`` and, for
``readings.py``, ``NUMBERS``, ``FAULTS``, ``CONTROL`` and ``plant(fault,
spec)``."""

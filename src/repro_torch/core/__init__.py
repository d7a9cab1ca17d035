"""The RoundPipe system of the port: the plan layer (copied from
``repro/core``: partition -> schedule -> transfer -> plan, and the simulator)
and the synchronous slot ring that executes a plan (``ring``, ``dispatch``)."""

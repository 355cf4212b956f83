"""Checkpointing and fault tolerance of the port (``repro.train``'s
``checkpoint`` and ``fault_tolerance``)."""

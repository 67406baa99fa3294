"""Parameter declarations of the port (counterpart of ``repro/parallel``)."""

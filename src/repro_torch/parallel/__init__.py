"""Parallel layouts of the port (counterpart of ``repro/parallel``): the
serving engine's lane ownership for now."""

"""Parallel layouts of the port (counterpart of ``repro/parallel``): the
sharding specs (``sharding``) and the mesh's collectives (``comm``)."""

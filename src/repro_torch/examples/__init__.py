"""The paper's examples on the port (counterparts of the reference's
``examples/``): ``python -m repro_torch.examples.<name>``."""

"""PyTorch/CUDA port of the CollaFuse reproduction.

The JAX package ``repro`` is the reference; every module here keeps the
reference's name and layout (``diffusion/schedule.py``, ``models/unet.py``,
``serve/engine.py``, ...) so each counterpart is easy to find.  This package
imports ``torch``, numpy and the standard library only: never ``jax`` and
never a module of ``repro``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a card they raise instead of carrying on on the CPU (see
:func:`repro_torch.device.resolve_device`).  The step kernels under
``kernels/`` are written by hand for Hopper and are built from this
package's sources at first use.
"""

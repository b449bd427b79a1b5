"""PyTorch/CUDA port of the ``repro`` package.

It mirrors ``repro``'s layout and imports neither JAX nor ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The reference package stays the yardstick: the
``tests/test_torch_*.py`` suite holds each module against it.
"""


class NotPortedError(NotImplementedError):
    """A component the reference has and the port does not have yet."""

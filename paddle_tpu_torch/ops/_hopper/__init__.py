"""Hand-written Hopper (sm_90a) kernels, the port of ``ops/_pallas``.

Sources live in ``csrc/``; :mod:`.build` compiles them with ``nvcc`` at first
use. Each kernel module holds the ctypes wrapper, the plain PyTorch version
the CPU path and the on-card comparison use, and a launch count.
"""


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch was refused (its entry returned a
    CUDA error code). Every wrapper's launch check raises it; the serving
    engine lets it, and any CUDA error, stop ``serve()`` instead of failing
    one request."""

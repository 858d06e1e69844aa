"""Hand-written Hopper (sm_90a) kernels, the port of ``ops/_pallas``.

Sources live in ``csrc/``; :mod:`.build` compiles them with ``nvcc`` at first
use. Each kernel module holds the ctypes wrapper, the plain PyTorch version
the CPU path and the on-card comparison use, and a launch count.
"""

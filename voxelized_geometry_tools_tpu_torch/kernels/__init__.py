"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources live in ``csrc/`` and are compiled with ``nvcc`` at first launch
(:mod:`.build`); importing this package builds nothing.
"""

from . import edt_bestfirst, edt_envelope, edt_windowed, probes  # noqa: F401

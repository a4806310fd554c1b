"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources live in ``csrc/`` and are compiled with ``nvcc`` at first launch
(:mod:`.build`); importing this package builds nothing.
"""

from . import (carve, edt_bestfirst, edt_combine,  # noqa: F401
               edt_envelope, edt_seed, edt_windowed, fusion_filter, probes,
               ray_setup, transform_product)

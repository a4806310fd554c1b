"""The native C++ CPU runtime (``vgt_native.cpp``), loaded with ctypes."""

from .loader import (available, probe_available, get_library,  # noqa: F401
                     edt_sdf, raycast, filter_grids, hardware_threads)

from . import backends, edt, render, sdf_query, voxelize  # noqa: F401

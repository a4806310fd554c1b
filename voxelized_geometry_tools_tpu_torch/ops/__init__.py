from . import edt, render, sdf_query  # noqa: F401

from . import fusion_pipeline  # noqa: F401

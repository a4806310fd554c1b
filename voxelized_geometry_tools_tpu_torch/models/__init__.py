from . import fusion_pipeline, online_mapper  # noqa: F401

"""The evaluation surface. ``get_embeddings``, ``masked_reconstruction_mse``
and ``predict_supervised`` (evaluation/embeddings.py) load on first use, so
that ``evaluation.export``, which a serving host imports to load an
artifact, brings in no model code."""

__all__ = ["get_embeddings", "masked_reconstruction_mse", "predict_supervised"]


def __getattr__(name):
    if name in __all__:
        from . import embeddings

        return getattr(embeddings, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

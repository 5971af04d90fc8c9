from .embeddings import get_embeddings, predict_supervised

__all__ = ["get_embeddings", "predict_supervised"]

from .embeddings import get_embeddings

__all__ = ["get_embeddings"]

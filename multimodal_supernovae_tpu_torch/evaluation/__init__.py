from .embeddings import get_embeddings, masked_reconstruction_mse, predict_supervised

__all__ = ["get_embeddings", "masked_reconstruction_mse", "predict_supervised"]

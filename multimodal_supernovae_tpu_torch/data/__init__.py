from .synthetic import make_synthetic_arrays

__all__ = ["make_synthetic_arrays"]

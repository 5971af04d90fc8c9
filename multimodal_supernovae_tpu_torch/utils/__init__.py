from .logging import MetricsLogger

__all__ = ["MetricsLogger"]

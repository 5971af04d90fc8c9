from .build import build, library_path, load_library

__all__ = ["build", "library_path", "load_library"]

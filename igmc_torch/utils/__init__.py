from .logging import ResultsDir, make_logger

__all__ = ["ResultsDir", "make_logger"]

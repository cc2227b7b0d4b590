from .logging import ResultsDir, make_logger
from .seeding import seed_everything

__all__ = ["ResultsDir", "make_logger", "seed_everything"]

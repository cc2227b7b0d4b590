"""Run helpers: results directories and logs (logging), seeding, the
liveness heartbeat (progress), spans and counters (spans), the PDF page
(pdf). The exports below load on first use: `logging` imports the
training package, whose modules import `spans` from here."""

_EXPORTS = {"ResultsDir": "logging", "make_logger": "logging",
            "seed_everything": "seeding"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)

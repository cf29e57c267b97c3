from .profiling import Timer, annotate, trace

__all__ = ["Timer", "annotate", "trace"]

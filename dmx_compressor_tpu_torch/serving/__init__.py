from .engine import ContinuousBatchingEngine, GenerationResult  # noqa: F401

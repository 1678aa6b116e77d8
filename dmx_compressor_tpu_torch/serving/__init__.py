from .engine import (  # noqa: F401
    ContinuousBatchingEngine,
    GenerationResult,
    Seq2SeqBatchingEngine,
)

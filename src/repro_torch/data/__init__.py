"""Token sources and the deterministic data pipeline of the port."""

from .pipeline import DataPipeline, MemmapCorpus, SyntheticLM  # noqa: F401

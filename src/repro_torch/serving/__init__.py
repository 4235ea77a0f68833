"""Serving layer of the port: the batched LM engine, and the
fault-tolerant DSE query service with its durable store."""
from .engine import DrainResult, Request, ServeEngine  # noqa: F401
from .dse_service import DSEService  # noqa: F401
from .store import DurableStore, Journal  # noqa: F401

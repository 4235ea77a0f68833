"""Serving layer of the port: the batched LM engine."""
from .engine import DrainResult, Request, ServeEngine  # noqa: F401

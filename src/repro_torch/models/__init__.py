"""Language-model stack of the port (dense family)."""

from .ops import count_term_layers, count_term_sums  # noqa: F401
from .ref import count_term_layers_ref, count_term_sums_ref  # noqa: F401

from .ops import rmsnorm  # noqa: F401
from .ref import rmsnorm_ref  # noqa: F401

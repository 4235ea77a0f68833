from .ops import flash_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401

from .ops import ssd_scan  # noqa: F401
from .ref import ssd_scan_ref  # noqa: F401

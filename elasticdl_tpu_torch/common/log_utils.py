"""Uniform logger factory (a copy of `elasticdl_tpu.common.log_utils`'s
`default_logger`, without the observability hooks the port has not taken
over yet).

`EDL_LOG_LEVEL` sets the level of the package's root logger.
"""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(name)s:%(lineno)d] %(message)s"
)

_ROOT = "elasticdl_tpu_torch"
_configured = False


def default_logger(name: str = _ROOT) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger(_ROOT)
        root.addHandler(handler)
        root.setLevel(os.environ.get("EDL_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(name)

"""The module-level ``LOGGER`` of the reference's utils/logger.py (the JAX
package's ``uniter_tpu/utils/logger.py``). The metric loggers arrive with
the training slice."""

import logging

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("__main__")

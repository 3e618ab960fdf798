"""Process-index-tagged logging.

Every record, from any library, carries a ``rank`` field through a
``logging.setLogRecordFactory`` hook. The rank is ``torch.distributed``'s
once a process group is initialised, else the ``PROCESS_ID``/``RANK``
environment variables (the reference's env contract), else ``?``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - [Rank %(rank)s] %(message)s"

_configured = False


def _current_rank() -> str:
    """Live ``torch.distributed`` rank when a group is up, else env, else '?'."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return str(dist.get_rank())
    except (ImportError, RuntimeError):
        pass
    return os.environ.get("PROCESS_ID", os.environ.get("RANK", "?"))


def setup_logging(level: int = logging.INFO, force: bool = False) -> None:
    """Install the rank-tagged record factory + root handler.

    Safe to call multiple times (idempotent unless ``force``).
    """
    global _configured
    if _configured and not force:
        return

    old_factory = logging.getLogRecordFactory()

    def record_factory(*args, **kwargs):
        record = old_factory(*args, **kwargs)
        if not hasattr(record, "rank"):
            record.rank = _current_rank()
        return record

    logging.setLogRecordFactory(record_factory)
    logging.basicConfig(level=level, format=_FORMAT, force=force)
    _configured = True


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Return a logger, ensuring rank-tagged logging is configured."""
    setup_logging()
    return logging.getLogger(name)

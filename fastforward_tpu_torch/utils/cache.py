"""Asset cache directories (`fastforward_tpu/utils/cache.py`)."""

import os
from pathlib import Path
from typing import Optional


def get_assets_path(kind: str, tag: str, cache_dir: Optional[str] = None) -> Path:
    """Return (and create) ``<cache>/<kind>/<tag>``: ``cache_dir``, else
    ``$FASTFORWARD_TPU_CACHE`` (the JAX package's variable), else
    ``~/.cache/fastforward_tpu_torch``."""
    base = Path(
        cache_dir
        or os.environ.get("FASTFORWARD_TPU_CACHE")
        or Path.home() / ".cache" / "fastforward_tpu_torch"
    )
    path = base / kind / tag
    path.mkdir(parents=True, exist_ok=True)
    return path

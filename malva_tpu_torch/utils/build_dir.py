"""Where the port builds what it compiles at first use.

Inside a checkout (the package's parent directory holds
``pyproject.toml``) a library of kind ``kind`` goes to ``build/<kind>/``
there, which git ignores.  Where that directory cannot be written, as for
an installed package, it goes to the user's cache directory:
``$XDG_CACHE_HOME/malva_tpu_torch/<kind>/``, else
``~/.cache/malva_tpu_torch/<kind>/``.
"""

from __future__ import annotations

import os
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]  # the package's parent directory


def _writable(path: Path) -> bool:
    """Whether ``path`` can be made or written: its nearest existing
    ancestor is a directory this process may write."""
    while not path.exists():
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def build_dir(kind: str) -> Path:
    local = _ROOT / "build" / kind
    if (_ROOT / "pyproject.toml").is_file() and _writable(local):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "malva_tpu_torch" / kind

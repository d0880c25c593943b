"""Process-level flags: the gflags tier of the three-tier config system.

Role parity: ``velox/flag_definitions/flags.cpp`` (process gflags like
``velox_memory_use_hugepages``, ``avx2``) — the tier BELOW per-query
QueryConfig (core/config.py) and per-connector session properties. Flags
are defined once with a type, default, and help string; values resolve
from the ``VELOX_TPU_<UPPER_NAME>`` environment variable at first read
and may be overridden programmatically (tests) via ``set_flag``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class _Flag:
    name: str
    default: Any
    parse: Callable[[str], Any]
    help: str
    value: Any = None
    resolved: bool = False


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.Lock()


def define_flag(name: str, default, help_: str, kind: type = str) -> None:
    """Register a process flag (idempotent for identical definitions)."""
    parse = {bool: _parse_bool, int: int, float: float, str: str}[kind]
    with _LOCK:
        if name in _REGISTRY:
            return
        _REGISTRY[name] = _Flag(name, default, parse, help_)


def get_flag(name: str):
    """Resolved flag value: explicit set_flag > env var > default."""
    f = _REGISTRY[name]
    if not f.resolved:
        with _LOCK:
            if not f.resolved:
                env = os.environ.get(f"VELOX_TPU_{name.upper()}")
                f.value = f.parse(env) if env is not None else f.default
                f.resolved = True
    return f.value


def set_flag(name: str, value) -> None:
    """Programmatic override (tests / embedders)."""
    f = _REGISTRY[name]
    with _LOCK:
        f.value = value
        f.resolved = True


def reset_flag(name: str) -> None:
    """Forget an override so the next read re-resolves from the env."""
    f = _REGISTRY[name]
    with _LOCK:
        f.value = None
        f.resolved = False


def all_flags() -> Dict[str, Any]:
    """{name: resolved value} for every registered flag (diagnostics)."""
    return {n: get_flag(n) for n in sorted(_REGISTRY)}


# ---------------------------------------------------------------------------
# Process flag definitions (parity: velox/flag_definitions/flags.cpp).
# ---------------------------------------------------------------------------

define_flag("dbgen_threads", 0,
            "native TPC-H generator threads (0 = hardware concurrency)",
            int)
define_flag("ssd_cache_dir", "",
            "SSD tier directory for the scan cache (empty = disabled "
            "unless the connector configures one)", str)
define_flag("scan_cache_bytes", 0,
            "device scan-cache budget in bytes (0 = connector default)",
            int)

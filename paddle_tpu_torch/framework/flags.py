"""Flag registry — the subset the serving slice reads.

Counterpart of `paddle_tpu/framework/flags.py` (:179-190): the same
flag names and defaults, the same `FLAGS_<name>` environment pickup at
import, and `get_flag`/`set_flags` with the reference's
semantics.  Only the three paged-KV flags are defined here; other flags
arrive with the modules that read them.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flag"]

_registry: Dict[str, dict] = {}


def define_flag(name: str, default: Any, help_str: str = ""):
    env_name = name if name.startswith("FLAGS_") else "FLAGS_" + name
    key = env_name[len("FLAGS_"):]
    value = default
    if env_name in os.environ:
        raw = os.environ[env_name]
        if isinstance(default, bool):
            value = raw.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(raw)
        elif isinstance(default, float):
            value = float(raw)
        else:
            value = raw
    _registry[key] = {"value": value, "default": default, "help": help_str}
    return value


def _norm(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def set_flags(flags: Dict[str, Any]):
    """set_flags({'FLAGS_kv_page_size': 8})"""
    for k, v in flags.items():
        key = _norm(k)
        if key not in _registry:
            _registry[key] = {"value": v, "default": None, "help": ""}
        else:
            _registry[key]["value"] = v


def get_flag(name: str, default=None):
    key = _norm(name)
    if key in _registry:
        return _registry[key]["value"]
    return default


# paged KV cache (inference/serving.py + ops.paged_attention): the
# serving tier's KV pool layout and precision
define_flag("kv_cache_dtype", "auto",
            "storage dtype of the serving paged KV pool: 'auto' (the "
            "model compute dtype), 'bfloat16', 'float16' or 'float32'. "
            "'int8' is recognised but not ported yet (raises)")
define_flag("kv_page_size", 16,
            "rows (token positions) per KV page in the serving paged "
            "pool; prefix sharing operates at page granularity")
define_flag("kv_pool_pages", 0,
            "total pages in the serving KV pool (page 0 is a reserved "
            "null page); 0 sizes the pool to dense-equivalent capacity "
            "(every slot fully backed)")

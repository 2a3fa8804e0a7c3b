"""Typed environment readers and process topology.

Port of the part of ``bagua_tpu/env.py`` the port reads: the registry of
declared ``BAGUA_*`` variables with typed ``env_str``/``env_int``/``env_bool``
readers, the default bucket size, the per-link codec policy, and rank /
world size / local rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class EnvVar:
    name: str
    type: str
    default: str
    doc: str


ENV_REGISTRY: Dict[str, EnvVar] = {}


def _declare(name: str, type: str, default: str, doc: str) -> None:
    ENV_REGISTRY[name] = EnvVar(name, type, default, doc)


_declare("BAGUA_DEFAULT_BUCKET_SIZE", "int", str(10 * 1024 ** 2),
         "Default communication bucket size in bytes (reference env.py:50-57).")
_declare("BAGUA_COMPRESS_INTRA", "str", "auto",
         "Per-link codec policy of the fast tier and the flat ring: `auto` "
         "(default) keeps it full precision; `off` forces full precision; a "
         "codec name (minmax_uint8|int8|fp8_e4m3|fp8_e5m2) makes the flat "
         "ring's hops carry that codec's payload.")
_declare("BAGUA_COMPRESS_INTER", "str", "auto",
         "Per-link codec policy of the cross-node tier of the hierarchical "
         "collectives: `auto` (default) defers to the algorithm family, "
         "`off` forces full precision.  A codec name is refused until the "
         "hierarchical forms are ported.")


def _raw(name: str) -> Optional[str]:
    """The ambient value of a declared variable (unset or '' -> None)."""
    if name not in ENV_REGISTRY:
        raise KeyError(f"{name} is not declared in env.ENV_REGISTRY")
    v = os.environ.get(name)
    return None if v in (None, "") else v


def env_str(name: str) -> str:
    v = _raw(name)
    return ENV_REGISTRY[name].default if v is None else v


def env_int(name: str) -> int:
    v = _raw(name)
    if v is None:
        return int(ENV_REGISTRY[name].default)
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


def env_bool(name: str) -> bool:
    """``"1"`` is on, anything else off, except for variables whose default
    is on, where only ``"0"`` turns them off."""
    v = _raw(name)
    spec = ENV_REGISTRY[name]
    if v is None:
        return spec.default == "1"
    return v != "0" if spec.default == "1" else v == "1"


def _int_env(name: str, default: int) -> int:
    """Unregistered int read (the launcher's RANK / WORLD_SIZE family)."""
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(
            f"environment variable {name} must be an integer, got {v!r}"
        ) from None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def get_rank() -> int:
    """Global rank: the process group's once it exists, else ``RANK``."""
    dist = _dist()
    return dist.get_rank() if dist else _int_env("RANK", 0)


def get_world_size() -> int:
    """Number of ranks: the process group's once it exists, else
    ``WORLD_SIZE``."""
    dist = _dist()
    return dist.get_world_size() if dist else _int_env("WORLD_SIZE", 1)


def get_local_rank() -> int:
    return _int_env("LOCAL_RANK", 0)


def get_default_bucket_size() -> int:
    """Default bucket size in bytes; 10 MiB like the reference."""
    return env_int("BAGUA_DEFAULT_BUCKET_SIZE")


def get_compress_intra() -> str:
    """Codec policy of the fast tier and the flat ring (``auto``; validated
    by :func:`bagua_tpu_torch.compression.codecs.validate_codec_policy`)."""
    return env_str("BAGUA_COMPRESS_INTRA")


def get_compress_inter() -> str:
    """Codec policy of the cross-node tier (``auto``: the family's own; the
    trainer refuses a codec name, as no hierarchical form is ported)."""
    return env_str("BAGUA_COMPRESS_INTER")


"""Typed environment readers and process topology.

Port of the part of ``bagua_tpu/env.py`` the port reads: the registry of
declared ``BAGUA_*`` variables with typed ``env_str``/``env_int``/``env_bool``
readers, the default bucket size, the overlap scheduler's gate and its ring
chunk targets (and their cap), the per-link codec policy, the stateful
codecs' knobs (top-k ratio, error-feedback residual), the flat-resident
layout, the gradient-health guard, async model average's staleness cap, the
fault-injection plan, and rank / world size / local rank / local world size.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class EnvVar:
    name: str
    type: str
    default: str
    doc: str
    choices: Tuple[str, ...] = ()


ENV_REGISTRY: Dict[str, EnvVar] = {}


def _declare(name: str, type: str, default: str, doc: str,
             choices: Tuple[str, ...] = ()) -> None:
    ENV_REGISTRY[name] = EnvVar(name, type, default, doc, choices)


_declare("BAGUA_DEFAULT_BUCKET_SIZE", "int", str(10 * 1024 ** 2),
         "Default communication bucket size in bytes (reference env.py:50-57).")
_declare("BAGUA_OVERLAP", "enum", "auto",
         "Overlap scheduler: launch each bucket's gradient collective from the "
         "backward, on a comm stream, as the bucket's gradient finalizes "
         "(`on`), keep the serialized step (`off`), or overlap where the "
         "family's measured record says so and there is something to "
         "overlap (`auto`: accumulation, or a ring chunk target set).",
         choices=("auto", "on", "off"))
_declare("BAGUA_OVERLAP_CHUNK_BYTES", "int", "0",
         "Target bytes a rank of one independent ring sub-collective under the "
         "overlap scheduler; 0 keeps one collective a bucket.")
_declare("BAGUA_OVERLAP_CHUNK_BYTES_INTRA", "int", "0",
         "Ring chunk target of the intra-node tier of the two-level "
         "collectives (and of the flat ring); 0 falls back to "
         "BAGUA_OVERLAP_CHUNK_BYTES.")
_declare("BAGUA_OVERLAP_CHUNK_BYTES_INTER", "int", "0",
         "Ring chunk target of the inter-node tier of the two-level "
         "collectives (size it above the intra-node one: a chunk that "
         "amortizes a fast hop is too small for a slow one); 0 falls back "
         "to BAGUA_OVERLAP_CHUNK_BYTES.")
_declare("BAGUA_MAX_RING_CHUNKS", "int", "32",
         "Cap on the independent sub-collectives of one chunked ring "
         "collective (each is 2(n-1) point-to-point hops a bucket).")
_declare("BAGUA_COMPRESS_INTRA", "str", "auto",
         "Per-link codec policy of the intra-node tier and the flat ring: "
         "`auto` (default) keeps it full precision; `off` forces full "
         "precision; a codec name "
         "(minmax_uint8|int8|fp8_e4m3|fp8_e5m2|onebit_ef|topk) makes the "
         "ring hops carry that codec's payload.")
_declare("BAGUA_COMPRESS_INTER", "str", "auto",
         "Per-link codec policy of the inter-node tier of the hierarchical "
         "collectives: `auto` (default) defers to the algorithm family "
         "(ByteGrad and QAdam compress it natively, the exact families keep "
         "it full precision), `off` forces full precision, a codec name "
         "(minmax_uint8|int8|fp8_e4m3|fp8_e5m2|onebit_ef|topk) compresses "
         "the inter-node ring hops for every family.")
_declare("BAGUA_TOPK_RATIO", "float", "0.01",
         "Fraction of each chunk's elements the `topk` ring codec keeps on "
         "the wire (int32 indices and f32 values; 0.01 keeps the top 1% by "
         "magnitude).  Read when the codec is looked up, so a value set "
         "before the trainer is built takes effect.")
_declare("BAGUA_EF_RESIDUAL", "enum", "on",
         "Error-feedback residual of the stateful ring codecs "
         "(onebit_ef|topk): `on` (default) carries each bucket's "
         "quantization error into the next step's gradient; `off` lets the "
         "codec ride without it (biased sign or sparse SGD, a convergence "
         "control).  Set before the trainer is built.", choices=("on", "off"))

_declare("BAGUA_FLAT_RESIDENT", "enum", "auto",
         "Flat-resident training state: keep params/grads/optimizer state "
         "as bucket-flat buffers across steps (`on`), keep the per-parameter "
         "layout (`off`), or engage it wherever the algorithm family "
         "supports it and the optimizer is elementwise (`auto`).",
         choices=("auto", "on", "off"))
_declare("BAGUA_GRAD_GUARD", "enum", "off",
         "Gradient-health sentinel policy: per-bucket isfinite checks on "
         "every step's gradients.  `warn` logs unhealthy steps, `skip` "
         "rewinds them (params/optimizer state untouched) and escalates to "
         "abort after a consecutive-skip budget, `abort` raises the comm "
         "abort flag on the first unhealthy step.",
         choices=("off", "warn", "skip", "abort"))
_declare("BAGUA_FAULT_PLAN", "str", "",
         "Deterministic fault-injection plan (JSON list of specs: point, "
         "kind, step/op trigger, count, seed) armed at the first fault-point "
         "query; drills and tests only, never production.  The port reaches "
         "async.partition and grad.poison.  See bagua_tpu_torch.faults.inject.")
_declare("BAGUA_ASYNC_MAX_STALENESS", "int", "4",
         "Bounded-staleness cap of async model average: when any rank's "
         "applied-round count reaches this many rounds behind the launched "
         "count (async.partition drops stall it), that negotiated boundary "
         "forces a synchronous catch-up average that leaves every rank's "
         "weights bitwise equal, so the lag never exceeds the cap.  0 "
         "disables the bound.")


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


def env_float(name: str) -> float:
    v = _raw(name)
    if v is None:
        return float(ENV_REGISTRY[name].default)
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}") from None


def env_enum(name: str) -> str:
    """The value, lower-cased, checked against the variable's choices."""
    v = env_str(name).strip().lower() or ENV_REGISTRY[name].default
    choices = ENV_REGISTRY[name].choices
    if choices and v not in choices:
        raise ValueError(f"{name} must be {'|'.join(choices)}, got {v!r}")
    return v


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


def get_local_world_size() -> Optional[int]:
    """Ranks per node from ``LOCAL_WORLD_SIZE`` (the launcher's), or None
    when unset: the default intra-node group size."""
    v = _int_env("LOCAL_WORLD_SIZE", 0)
    return v if v > 0 else None


def get_default_bucket_size() -> int:
    """Default bucket size in bytes; 10 MiB like the reference."""
    return env_int("BAGUA_DEFAULT_BUCKET_SIZE")


def get_overlap_mode() -> str:
    """Overlap scheduler gate: ``auto`` (default), ``on`` or ``off``."""
    return env_enum("BAGUA_OVERLAP")


def get_overlap_chunk_bytes() -> int:
    """Target bytes a rank of one ring sub-collective under the overlap
    scheduler; 0 (default) keeps one collective a bucket."""
    return env_int("BAGUA_OVERLAP_CHUNK_BYTES")


def get_overlap_chunk_bytes_intra() -> int:
    """Ring chunk target of the intra-node tier and the flat ring; 0
    (default) falls back to :func:`get_overlap_chunk_bytes`."""
    return env_int("BAGUA_OVERLAP_CHUNK_BYTES_INTRA")


def get_overlap_chunk_bytes_inter() -> int:
    """Ring chunk target of the inter-node tier; 0 (default) falls back to
    :func:`get_overlap_chunk_bytes`."""
    return env_int("BAGUA_OVERLAP_CHUNK_BYTES_INTER")


def get_max_ring_chunks() -> int:
    """Cap on a chunked ring's sub-collectives (default 32)."""
    return env_int("BAGUA_MAX_RING_CHUNKS")


def get_compress_intra() -> str:
    """Codec policy of the fast tier and the flat ring (``auto``; validated
    by :func:`bagua_tpu_torch.compression.codecs.validate_codec_policy`)."""
    return env_str("BAGUA_COMPRESS_INTRA")


def get_compress_inter() -> str:
    """Codec policy of the inter-node tier (``auto``: the family's own)."""
    return env_str("BAGUA_COMPRESS_INTER")


def get_topk_ratio() -> float:
    """Fraction of each chunk the ``topk`` codec keeps (default 0.01); read
    each time the codec is looked up."""
    return env_float("BAGUA_TOPK_RATIO")


def is_ef_residual_disabled() -> bool:
    """True when ``BAGUA_EF_RESIDUAL=off``: the stateful codecs ride without
    their residual."""
    return env_enum("BAGUA_EF_RESIDUAL") == "off"


def get_flat_resident_mode() -> str:
    """Flat-resident training state: ``auto`` (default: engage wherever the
    algorithm family supports it), ``on``, or ``off`` (the per-parameter
    layout)."""
    return env_enum("BAGUA_FLAT_RESIDENT")


def get_grad_guard_mode() -> str:
    """Gradient-health sentinel policy: ``off`` (default), ``warn``,
    ``skip`` (rewind unhealthy steps), or ``abort``."""
    return env_enum("BAGUA_GRAD_GUARD")


def get_fault_plan_raw() -> Optional[str]:
    """The raw JSON fault-injection plan (None when unset); parsed by
    :mod:`bagua_tpu_torch.faults.inject`."""
    return _raw("BAGUA_FAULT_PLAN")


def get_async_max_staleness() -> int:
    """Bounded-staleness cap of async model average (0: unbounded)."""
    return env_int("BAGUA_ASYNC_MAX_STALENESS")

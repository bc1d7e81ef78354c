"""Consolidated execution configuration (:class:`ExecConfig`).

One documented entry point for the execution knobs that were previously
scattered across engine kwargs and ``REPRO_EXEC_*`` environment variables:

===========  =========================  =====================================
field        env fallback               meaning
===========  =========================  =====================================
backend      (none)                     execution backend ("numpy" | "torch" |
                                        an ``ExecBackend`` instance)
wave         ``REPRO_EXEC_WAVE``        shards per batched dispatch wave
partitions   ``REPRO_EXEC_PARTITIONS``  execution partitions per query
fused        ``REPRO_EXEC_FUSED``       single fused dispatch per wave
profile      ``REPRO_EXEC_PROFILE``     per-stage device sync + timing
===========  =========================  =====================================

Resolution order is **explicit field > environment variable > default** for
every knob but ``backend``: a field left ``None`` defers to the env var (and
then the built-in default), while a set field wins even when the env var
disagrees — ``ExecConfig(fused=True)`` keeps fusion on under
``REPRO_EXEC_FUSED=0``.  ``backend`` reads no environment variable: left
``None`` it is ``"torch"``, on CUDA, so nothing outside the program can
move the card's path onto the host oracle.  None of these knobs switches a
kernel to its plain version.

``Session``, ``AdHocEngine``, ``FlumeEngine``, and ``QueryServer`` all
accept ``config=ExecConfig(...)``; the legacy per-field kwargs
(``backend=``, ``wave=``, ``partitions=``) remain as shims that fill the
corresponding unset config fields.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Optional

__all__ = ["ExecConfig", "WAVE_ENV", "PARTITIONS_ENV", "FUSED_ENV",
           "PROFILE_ENV"]

WAVE_ENV = "REPRO_EXEC_WAVE"
PARTITIONS_ENV = "REPRO_EXEC_PARTITIONS"
FUSED_ENV = "REPRO_EXEC_FUSED"
PROFILE_ENV = "REPRO_EXEC_PROFILE"


@dataclass(frozen=True)
class ExecConfig:
    backend: Any = None                  # name | ExecBackend | None
    wave: Optional[int] = None
    partitions: Optional[int] = None
    fused: Optional[bool] = None
    profile: Optional[bool] = None

    # -- construction -------------------------------------------------------
    def fill(self, **legacy) -> "ExecConfig":
        """Fields set here win; ``None`` fields take the legacy kwarg.

        This is the deprecation shim behind ``AdHocEngine(backend=...,
        wave=...)`` and friends — engine kwargs flow in through it so the
        config object stays the single source of truth.
        """
        updates = {k: v for k, v in legacy.items()
                   if v is not None and getattr(self, k) is None}
        return replace(self, **updates) if updates else self

    def replace(self, **kw) -> "ExecConfig":
        return replace(self, **kw)

    # -- resolution (explicit > env > default) ------------------------------
    def resolve_backend(self):
        from .backend import as_backend
        return as_backend(self.backend)

    def resolve_wave(self, backend=None) -> int:
        from .batched import wave_size
        return wave_size(self.wave, backend)

    def resolved_fused(self) -> bool:
        if self.fused is not None:
            return bool(self.fused)
        return os.environ.get(FUSED_ENV, "") != "0"

    def resolved_profile(self) -> bool:
        if self.profile is not None:
            return bool(self.profile)
        return os.environ.get(PROFILE_ENV) == "1"

"""Execution engines: Warp:AdHoc (interactive) and Warp:Flume (batch).

Both engines run the same logical plan through a pluggable
:class:`ExecBackend` (``numpy`` host oracle, ``torch`` CUDA kernel
dispatch) — see :mod:`repro_torch.exec.backend`.
"""
from .backend import (ExecBackend, NumpyBackend, TorchBackend, as_backend,
                      backend_names, get_backend, register_backend)
from .config import ExecConfig
from .batched import (DEFAULT_WAVE, partition_waves, run_wave_task,
                      wave_size)
from .catalog import Catalog, StructureManager, ResourceManager, default_catalog
from .adhoc import AdHocEngine, QueryResult, default_engine
from .flume import FlumeEngine
from .device_cache import DeviceCache
from .failures import FaultPlan, TaskFailure

__all__ = ["ExecConfig",
           "Catalog", "StructureManager", "ResourceManager",
           "default_catalog", "AdHocEngine", "QueryResult", "default_engine",
           "FlumeEngine", "FaultPlan", "TaskFailure",
           "ExecBackend", "NumpyBackend", "TorchBackend", "get_backend",
           "as_backend", "register_backend", "backend_names",
           "DEFAULT_WAVE", "wave_size", "partition_waves", "run_wave_task",
           "DeviceCache"]

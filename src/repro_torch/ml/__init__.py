"""ML stack: layers, attention, Mamba, MoE, the unified LM, the training
step (losses, optimizer, ``ModelBundle``), WFL integration (§5) and the
carry-over of the JAX package's parameters."""
from .integration import ColumnModel, MLPRegressor
from .model import ModelBundle, TrainConfig
from .params import from_jax_params
from .transformer import LM, cycle_len

__all__ = ["LM", "cycle_len", "ModelBundle", "TrainConfig", "ColumnModel",
           "MLPRegressor", "from_jax_params"]

"""The training-pod substrate of the port (the JAX package's
``repro.distributed`` without its mesh modules): the straggler runtime
and its pod policies.  Importing it registers ``start-pod``,
``start-eager-pod``, ``start-pod-online`` and ``start-pod-service``."""
from repro_torch.distributed.straggler_runtime import (ActionKind, HostAction,
                                                       RuntimeConfig,
                                                       StragglerRuntime,
                                                       backup_mask)

__all__ = ["StragglerRuntime", "RuntimeConfig", "HostAction", "ActionKind",
           "backup_mask"]

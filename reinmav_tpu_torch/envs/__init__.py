from .core import EnvDef, StepOut, control_rollout, controller_policy, rollout
from .registry import make, register, registered_ids

__all__ = [
    "EnvDef", "StepOut", "make", "register", "registered_ids",
    "rollout", "control_rollout", "controller_policy",
]

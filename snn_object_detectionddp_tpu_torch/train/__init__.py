from .checkpoint import load_checkpoint, resume_or_init, save_checkpoint  # noqa: F401
from .schedule import onecycle_lr  # noqa: F401
from .step import TrainStepFns, make_optimizer, make_step_fns  # noqa: F401

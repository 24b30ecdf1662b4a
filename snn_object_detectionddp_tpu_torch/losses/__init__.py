from .detection import DetectionLoss, detection_loss  # noqa: F401
from .tal import task_aligned_assign  # noqa: F401

from .build import Solver, YOLOXSolver
from .schedules import yolox_cosine_lr

__all__ = ["Solver", "YOLOXSolver", "yolox_cosine_lr"]

from .build import DefaultSolver, DetSolver, Solver, YOLOXSolver
from .schedules import multistep_lr, yolox_cosine_lr

__all__ = ["DefaultSolver", "DetSolver", "Solver", "YOLOXSolver", "multistep_lr", "yolox_cosine_lr"]

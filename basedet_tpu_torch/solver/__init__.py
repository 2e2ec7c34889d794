from .build import DefaultSolver, DetrSolver, DetSolver, Solver, YOLOXSolver
from .schedules import cosine_lr, multistep_lr, yolox_cosine_lr

__all__ = ["DefaultSolver", "DetSolver", "DetrSolver", "Solver", "YOLOXSolver", "cosine_lr", "multistep_lr",
           "yolox_cosine_lr"]

from .registry import build_evaluator, build_model, build_trainer, registers

__all__ = ["build_evaluator", "build_model", "build_trainer", "registers"]

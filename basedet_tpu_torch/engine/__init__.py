from .build import SimpleHookList, YOLOXHookList
from .hooks import BaseHook, CheckpointHook, EvalHook, LoggerHook, LRSchedulerHook, ResumeHook
from .progress import Progress
from .tester import BaseTester
from .train_state import TrainState, ema_momentum, make_train_step
from .trainer import DetTrainer

__all__ = [
    "BaseHook",
    "BaseTester",
    "CheckpointHook",
    "DetTrainer",
    "EvalHook",
    "LRSchedulerHook",
    "LoggerHook",
    "Progress",
    "ResumeHook",
    "SimpleHookList",
    "TrainState",
    "YOLOXHookList",
    "ema_momentum",
    "make_train_step",
]

from . import checkpoint, optimizer, train_loop
from .optimizer import OptConfig
from .train_loop import SimulatedPreemption, Trainer, TrainLoopConfig

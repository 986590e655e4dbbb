"""Training substrate: optimizer, step builder, checkpoint, fault tolerance
(the single-device path of ``repro.train``)."""
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import TrainingRunner
from repro_torch.train.optimizer import AdamW, cosine_schedule, global_norm
from repro_torch.train.train_loop import TrainState, build_train_step, init_train_state

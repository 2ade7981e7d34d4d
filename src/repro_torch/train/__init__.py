"""Training on PyTorch (``repro/train``): loss, AdamW, the train step and
checkpoints. The reference's ``compression`` (an int8 all-reduce across
data-parallel devices) and ``reshard_checkpoint`` need several devices and
wait (``ROADMAP.md``)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.train.loss import cross_entropy, make_labels  # noqa: F401
from repro_torch.train.train_step import TrainConfig, make_train_step, make_eval_step  # noqa: F401
from repro_torch.train.checkpoint import (  # noqa: F401
    save_checkpoint, load_checkpoint, latest_step,
)

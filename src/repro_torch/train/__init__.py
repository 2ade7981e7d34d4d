"""Training on PyTorch (``repro/train``): loss, AdamW, the train step,
checkpoints with ``reshard_checkpoint``, and the int8 error-feedback
all-reduce across data-parallel workers (``compression``)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.train.loss import cross_entropy, make_labels  # noqa: F401
from repro_torch.train.train_step import TrainConfig, make_train_step, make_eval_step  # noqa: F401
from repro_torch.train.checkpoint import (  # noqa: F401
    save_checkpoint, load_checkpoint, latest_step, reshard_checkpoint,
)
from repro_torch.train.compression import (  # noqa: F401
    compress_int8, compressed_psum, decompress_int8, init_error_buffer, make_compressed_psum,
)

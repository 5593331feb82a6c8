from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401

from .store import (AsyncCheckpointWriter, CheckpointManager, latest_step,  # noqa: F401
                    load_checkpoint, save_checkpoint)

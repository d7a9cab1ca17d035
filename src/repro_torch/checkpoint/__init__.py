from .store import (CheckpointManager, latest_step, load_checkpoint,  # noqa: F401
                    save_checkpoint)

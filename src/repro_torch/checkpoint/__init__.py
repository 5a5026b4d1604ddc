from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.checkpoint.async_writer import AsyncCheckpointer

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

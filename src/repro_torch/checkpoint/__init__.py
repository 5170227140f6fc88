"""repro_torch.checkpoint — atomic directory checkpoints in the reference's
layout (``arrays.npz`` + ``meta.msgpack``), with the port's own MessagePack
codec (``msgpack_lite``), ``restore`` into a template and the keep-last-N
``CheckpointManager``."""
from repro_torch.checkpoint import manager, msgpack_lite
from repro_torch.checkpoint.manager import (CheckpointManager, load_arrays,
                                            restore, save)

__all__ = ["CheckpointManager", "load_arrays", "manager", "msgpack_lite",
           "restore", "save"]

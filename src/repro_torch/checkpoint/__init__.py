"""repro_torch.checkpoint — atomic directory checkpoints in the reference's
layout (``arrays.npz`` + ``meta.msgpack``), with the port's own MessagePack
codec (``msgpack_lite``)."""
from repro_torch.checkpoint import manager, msgpack_lite

__all__ = ["manager", "msgpack_lite"]

"""Channels between processes (counterpart of ``ray_tpu.experimental``):
the shared-memory ``Channel`` with its tensor lane, and ``DeviceChannel``,
which moves CUDA tensors over CUDA IPC."""

from .channel import Channel, ChannelClosed, ChannelTimeout
from .device_channel import DeviceChannel

__all__ = ["Channel", "ChannelClosed", "ChannelTimeout", "DeviceChannel"]

"""Device layer: Places over torch devices.

``CUDAPlace(i)`` is card i; ``CPUPlace()`` the host, and so is
``CUDAPinnedPlace()`` (page-locked host memory is the port's own
business: ``staging.PinnedStaging``). A place resolves to a
``torch.device``; asking for a card that is not there raises rather than
running on the CPU.
"""

from __future__ import annotations

import torch


class Place:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    @property
    def torch_device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace(Place):
    @property
    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: no CUDA device is available; pass CPUPlace() "
                "to run on the host")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA "
                "device(s) present")
        return torch.device("cuda", self.device_id)


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a host place, as ``CPUPlace``."""

    def __init__(self, *args):
        super().__init__()


def core_device_count() -> int:
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def cpu_places(device_count=None):
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """A ``CUDAPlace`` for each of ``device_ids``, by default every CUDA
    device."""
    if device_ids is None:
        device_ids = range(core_device_count())
    return [CUDAPlace(int(i)) for i in device_ids]


def cuda_pinned_places(device_count=None):
    return [CUDAPinnedPlace() for _ in range(device_count or 1)]

"""Energy the cards draw, from NVML's cumulative counter
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
loaded), read through ``ctypes`` on ``libnvidia-ml.so.1``, and each
card's enforced power limit.  A machine without the library or the
counter gives no reading: the benchmark then reports no energy metric and
never an estimate."""
from __future__ import annotations

import ctypes


class NvmlError(RuntimeError):
    pass


class Cards:
    """NVML handles of the given CUDA devices, matched by UUID."""

    def __init__(self, uuids: list[str]):
        try:
            self._nvml = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise NvmlError(f"libnvidia-ml.so.1: {e}") from e
        self._call("nvmlInit_v2")
        self._handles = []
        for uuid in uuids:
            h = ctypes.c_void_p()
            self._call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                       ctypes.byref(h))
            self._handles.append(h)

    def _call(self, fn: str, *args) -> None:
        rc = getattr(self._nvml, fn)(*args)
        if rc != 0:
            raise NvmlError(f"{fn} returned NVML error {rc}")

    def energy_j(self) -> list[float]:
        """Each card's cumulative energy, in joules."""
        out = []
        for h in self._handles:
            mj = ctypes.c_ulonglong()
            self._call("nvmlDeviceGetTotalEnergyConsumption", h,
                       ctypes.byref(mj))
            out.append(mj.value / 1e3)
        return out

    def power_limit_w(self) -> list[float]:
        out = []
        for h in self._handles:
            mw = ctypes.c_uint()
            self._call("nvmlDeviceGetEnforcedPowerLimit", h, ctypes.byref(mw))
            out.append(mw.value / 1e3)
        return out


def cuda_uuids(devices) -> list[str]:
    """NVML's ``GPU-...`` UUID strings of the given CUDA devices."""
    import torch

    return [f"GPU-{torch.cuda.get_device_properties(d).uuid}" for d in devices]


def open_cards(devices):
    """:class:`Cards` for the CUDA ``devices``, or ``(None, reason)`` where
    NVML or its energy counter is not there."""
    try:
        cards = Cards(cuda_uuids(devices))
        cards.energy_j()
        return cards, None
    except NvmlError as e:
        return None, str(e)

"""Hardware probe: the port's counterpart of the reference's cpuid
detection (reference src/hardware.c:25-189, pll_hardware_probe).

Port of libpll2_tpu/utils/hardware.py, whose fields it keeps: the JAX
package reports its device topology, this one the torch view of it (the
CUDA devices, or the CPU without one, and the processes of an initialized
`torch.distributed`). `dump` mirrors pll_hardware_dump.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List

import torch


@dataclass
class HardwareInfo:
    platform: str
    device_kind: str
    device_count: int
    local_device_count: int
    process_count: int
    devices: List[str] = field(default_factory=list)


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def probe() -> HardwareInfo:
    """'gpu' with the CUDA devices of this process, else 'cpu'. The device
    count is the local count times the processes of an initialized
    torch.distributed group (one card a process)."""
    procs = _world_size()
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return HardwareInfo(
            platform="gpu", device_kind=torch.cuda.get_device_name(0),
            device_count=n * procs, local_device_count=n,
            process_count=procs,
            devices=[f"cuda:{i} {torch.cuda.get_device_name(i)}"
                     for i in range(n)])
    return HardwareInfo(platform="cpu", device_kind="cpu",
                        device_count=procs, local_device_count=1,
                        process_count=procs, devices=["cpu"])


def dump(file=None) -> HardwareInfo:
    """pll_hardware_dump analog."""
    info = probe()
    out = file or sys.stdout
    print(f"platform: {info.platform}", file=out)
    print(f"device kind: {info.device_kind}", file=out)
    print(f"devices: {info.device_count} "
          f"({info.local_device_count} local, "
          f"{info.process_count} processes)", file=out)
    return info

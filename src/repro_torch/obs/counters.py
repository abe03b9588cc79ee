"""Program counters kept on the device: int64 tensors that the model adds
to where it runs, inside a CUDA graph too (an in-place add on a tensor the
graph holds, no host sync), and that the host reads after a run. A
counter is made at its first use, which is eager (a graph's warm-up runs
before its capture), so the graph captures the add into it.

The dropless MoE layers count the rows routed to each expert,
``moe.routed_rows`` (MoE layers, experts)."""

from __future__ import annotations

from typing import Dict

import torch


class DeviceCounters:
    """Named int64 counters on the device."""

    def __init__(self):
        self._t: Dict[str, torch.Tensor] = {}

    def get(self, name: str, shape: tuple, device) -> torch.Tensor:
        """The counter `name`, zeros of `shape` at its first use."""
        t = self._t.get(name)
        if t is None:
            t = self._t[name] = torch.zeros(shape, dtype=torch.int64,
                                            device=device)
        return t

    def read(self) -> Dict[str, torch.Tensor]:
        """Each counter's value, copied to the host (a sync)."""
        return {k: v.cpu() for k, v in self._t.items()}

    def reset(self) -> None:
        """Every counter back to zero, in place (a graph keeps adding to
        the same tensors)."""
        for v in self._t.values():
            v.zero_()

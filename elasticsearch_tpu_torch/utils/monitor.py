"""Device probes for the node's stats.

Counterpart of `elasticsearch_tpu/utils/monitor.py`, trimmed to
`device_stats`: the CUDA devices and their memory, the working set's
home (the reference reports its accelerators the same way).
"""

from __future__ import annotations

import torch


def device_stats() -> dict:
    """The CUDA devices with their name and memory: total and free
    (`torch.cuda.mem_get_info`), allocated and peak allocated by this
    process's caching allocator. No CUDA device: count 0."""
    if not torch.cuda.is_available():
        return {"count": 0, "devices": []}
    devices = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        devices.append({
            "id": i, "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "memory": {"bytes_in_use": int(torch.cuda.memory_allocated(i)),
                       "bytes_limit": int(total),
                       "bytes_free": int(free),
                       "peak_bytes_in_use": int(
                           torch.cuda.max_memory_allocated(i))}})
    return {"count": len(devices), "devices": devices}

"""Device selection for the port's entry points, and its host syncs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(as the tests do). Without a card they raise: nothing carries on quietly
on the CPU. No JAX counterpart (JAX picks its backend globally).
"""

from __future__ import annotations

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.utils import metrics


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


# -- host syncs --------------------------------------------------------------
#
# Every place where the port makes the host wait for the device goes
# through one of these two: an upload of host data (a copy from pageable
# memory, which waits for the stream to drain) and a host read of device
# data or an event wait. Each call counts one ``HostSyncs.<layer>`` under
# the thread's innermost layer span (``utils/metrics.py``), on every
# device, so the counts per keyframe do not depend on it; while tracing it
# also records a ``sync`` span of the wait with the site's name.


def upload(arr, device, dtype=None, *, site: str) -> torch.Tensor:
    """``arr`` (an array or a Python number or list) on ``device``, as
    ``torch.as_tensor(arr, dtype=dtype).to(device)``: a blocking copy."""
    _count()
    with metrics.MetricManager.span("sync", site=site):
        return _upload(arr, device, dtype)


def sync(x, *, site: str):
    """The host's wait for the device: a tensor's host copy (``x.cpu()``,
    the tensor itself on the CPU), a CUDA event waited on (returns None),
    or None, a copy already done on the CPU."""
    _count()
    with metrics.MetricManager.span("sync", site=site):
        return _sync(x)


def _count():
    metrics.MetricManager.instance().counters(
        "HostSyncs." + metrics.current_layer()).increment()


def _upload(arr, device, dtype):
    if isinstance(arr, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype is not None:
            t = t.to(dtype)
    else:
        t = torch.as_tensor(arr, dtype=dtype)
    return t.to(device)


def _sync(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu()
    x.synchronize()
    return None

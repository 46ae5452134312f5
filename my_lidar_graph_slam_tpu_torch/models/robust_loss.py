"""Robust M-estimator loss functions on tensors.

Counterpart of ``my_lidar_graph_slam_tpu/models/robust_loss.py``: all seven
losses of the reference (robust_loss_function.{hpp,cpp}): Squared, Huber,
Cauchy, Fair, Geman-McClure, Welsch, DCS. Each provides ``loss(t)`` and
``weight(t)`` on the SQUARED error t, elementwise, matching the formulas at
robust_loss_function.cpp:26-188.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RobustLoss:
    name: str
    loss: Callable
    weight: Callable


def _squared(scale: float) -> Tuple[Callable, Callable]:
    del scale

    def loss(t):
        return t

    def weight(t):
        return torch.ones_like(t)

    return loss, weight


def _huber(s: float):
    def loss(t):
        return torch.where(t <= s, t, 2.0 * torch.sqrt(s * t) - s)

    def weight(t):
        return torch.where(t <= s, torch.ones_like(t),
                           torch.sqrt(s / torch.clamp(t, min=1e-30)))

    return loss, weight


def _cauchy(s: float):
    def loss(t):
        return s * torch.log1p(t / s)

    def weight(t):
        return s / (s + t)

    return loss, weight


def _fair(s: float):
    def loss(t):
        sq = torch.sqrt(t / s)
        return 2.0 * s * (sq - torch.log1p(sq))

    def weight(t):
        return 1.0 / (1.0 + torch.sqrt(t / s))

    return loss, weight


def _geman_mcclure(s: float):
    def loss(t):
        return s * t / (s + t)

    def weight(t):
        return (s * s) / ((s + t) * (s + t))

    return loss, weight


def _welsch(s: float):
    def loss(t):
        return s * -torch.expm1(-t / s)

    def weight(t):
        return torch.exp(-t / s)

    return loss, weight


def _dcs(s: float):
    def loss(t):
        return s * t / (s + t)

    def weight(t):
        return torch.where(t <= s, torch.ones_like(t),
                           (2.0 * s / (s + t)) ** 2)

    return loss, weight


_FACTORY: Dict[str, Callable] = {
    "Squared": _squared,
    "Huber": _huber,
    "Cauchy": _cauchy,
    "Fair": _fair,
    "GemanMcClure": _geman_mcclure,
    "Welsch": _welsch,
    "DCS": _dcs,
}


def create(name: str, scale: float = 1.0) -> RobustLoss:
    """Factory by reference type name (slam_launcher.cpp:603)."""
    if name not in _FACTORY:
        raise ValueError(f"unknown robust loss: {name}")
    loss, weight = _FACTORY[name](scale)
    return RobustLoss(name=name, loss=loss, weight=weight)

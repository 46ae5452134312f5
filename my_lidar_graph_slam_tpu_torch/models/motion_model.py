"""Velocity motion model: pose sampling and covariance propagation.

Counterpart of ``my_lidar_graph_slam_tpu/models/motion_model.py``, the
reference's MotionModelVelocity (motion_model_velocity.{hpp,cpp}), which
its launcher builds but never instantiates. Batched: ``sample_poses``
draws a batch of particles in one call, and covariance propagation
composes the pose and velocity Jacobians (motion_model_velocity.cpp:
85-140).

The noise is drawn from an explicit ``torch.Generator`` by
:meth:`MotionModelVelocity.draw_noise`, and turned into poses by
:meth:`MotionModelVelocity.poses_from_noise`: ``torch`` and ``jax.random``
give different numbers for one seed, so a test hands both packages the
same normals through the second function.
"""

from __future__ import annotations

import dataclasses

import torch

from my_lidar_graph_slam_tpu_torch.utils import se2

TRANS_VELOCITY_MIN = 0.01   # motion_model_velocity.hpp:149
ANGULAR_VELOCITY_MIN = 0.01  # :151


@dataclasses.dataclass(frozen=True)
class AlphaCoefficients:
    """Variance = alpha-weighted squared velocities
    (motion_model_velocity.cpp:152-161)."""

    alpha_trans: float = 0.01
    alpha_angular_to_trans: float = 0.001
    alpha_trans_to_angular: float = 0.001
    alpha_angular: float = 0.01

    def variances(self, trans_velocity, angular_velocity, time_diff):
        del time_diff
        t2 = trans_velocity ** 2
        a2 = angular_velocity ** 2
        trans_var = self.alpha_trans * t2 + self.alpha_angular_to_trans * a2
        ang_var = self.alpha_trans_to_angular * t2 + self.alpha_angular * a2
        return trans_var, ang_var


@dataclasses.dataclass(frozen=True)
class StandardDeviations:
    """Variance = stddev-weighted absolute velocities / dt
    (motion_model_velocity.cpp:162-178)."""

    std_dev_trans: float = 0.05
    std_dev_rot_to_trans: float = 0.05
    std_dev_trans_to_rot: float = 0.05
    std_dev_rot: float = 0.05

    def variances(self, trans_velocity, angular_velocity, time_diff):
        trans_var = (self.std_dev_trans ** 2 * torch.abs(trans_velocity) +
                     self.std_dev_rot_to_trans ** 2 *
                     torch.abs(angular_velocity)) / time_diff
        ang_var = (self.std_dev_trans_to_rot ** 2 *
                   torch.abs(trans_velocity) +
                   self.std_dev_rot ** 2 *
                   torch.abs(angular_velocity)) / time_diff
        return trans_var, ang_var


@dataclasses.dataclass(frozen=True)
class MotionModelVelocity:
    """Poses are f32 tensors ``[..., 3]``; ``time_diff`` is a number."""

    params: object = AlphaCoefficients()

    def velocities(self, rel_pose, time_diff):
        """Velocities from a relative pose
        (motion_model_velocity.cpp:17-33)."""
        trans = torch.hypot(rel_pose[..., 0], rel_pose[..., 1]) / time_diff
        ang = rel_pose[..., 2] / time_diff
        return (torch.clamp(trans, min=TRANS_VELOCITY_MIN),
                torch.clamp(ang, min=ANGULAR_VELOCITY_MIN))

    def draw_noise(self, generator: torch.Generator, num_samples: int,
                   device=None):
        """Standard normals f32[2, num_samples] from ``generator`` (rows:
        translational, angular), on the generator's device unless
        ``device`` is given."""
        device = generator.device if device is None else device
        return torch.randn((2, num_samples), generator=generator,
                           device=device, dtype=torch.float32)

    def poses_from_noise(self, prev_pose, rel_pose, time_diff, noise):
        """Noisy next poses f32[N, 3] from standard normals ``noise``
        [2, N] (the batched particle form of motion_model_velocity.cpp:
        36-82)."""
        tv, av = self.velocities(rel_pose, time_diff)
        tv_var, av_var = self.params.variances(tv, av, time_diff)
        tn = tv + torch.sqrt(tv_var) * noise[0]
        an = av + torch.sqrt(av_var) * noise[1]

        theta0 = prev_pose[2]
        new_theta = se2.normalize_angle(theta0 + an * time_diff)
        # Arc motion; straight-line fallback when the angular velocity is
        # almost zero (motion_model_velocity.cpp:58-67).
        straight = torch.abs(an) < 1e-4
        safe_an = torch.where(straight, torch.ones_like(an), an)
        radius = tn / safe_an
        arc_x = prev_pose[0] - radius * torch.sin(theta0) + \
            radius * torch.sin(new_theta)
        arc_y = prev_pose[1] + radius * torch.cos(theta0) - \
            radius * torch.cos(new_theta)
        line_x = prev_pose[0] + tn * torch.cos(theta0) * time_diff
        line_y = prev_pose[1] + tn * torch.sin(theta0) * time_diff
        x = torch.where(straight, line_x, arc_x)
        y = torch.where(straight, line_y, arc_y)
        return torch.stack([x, y, new_theta], dim=-1)

    def sample_poses(self, generator: torch.Generator, prev_pose, rel_pose,
                     time_diff, num_samples: int):
        """Draw ``num_samples`` noisy next poses f32[N, 3]."""
        noise = self.draw_noise(generator, num_samples, prev_pose.device)
        return self.poses_from_noise(prev_pose, rel_pose, time_diff, noise)

    def compute_covariance(self, prev_pose, rel_pose, time_diff, prev_cov):
        """Propagate the pose covariance f32[3, 3] through the motion
        (motion_model_velocity.cpp:85-140). Each 3x3 product is a
        multiply-and-sum, so the card's TF32 settings do not reach it."""
        tv, av = self.velocities(rel_pose, time_diff)
        tv_var, av_var = self.params.variances(tv, av, time_diff)
        c = torch.cos(prev_pose[2])
        s = torch.sin(prev_pose[2])
        zero = torch.zeros_like(c)
        one = torch.ones_like(c)
        dt = torch.full_like(c, time_diff)
        pose_jac = torch.stack([
            torch.stack([one, zero, -tv * time_diff * s]),
            torch.stack([zero, one, tv * time_diff * c]),
            torch.stack([zero, zero, one])])
        vel_jac = torch.stack([
            torch.stack([time_diff * c, zero]),
            torch.stack([time_diff * s, zero]),
            torch.stack([zero, dt])])
        vel_cov = torch.diag(torch.stack([tv_var, av_var]))
        return _sandwich(pose_jac, prev_cov) + _sandwich(vel_jac, vel_cov)


def _sandwich(jac, cov):
    """``jac @ cov @ jac.T`` as multiply-and-sum."""
    tmp = (jac[:, :, None] * cov[None, :, :]).sum(dim=1)
    return (tmp[:, None, :] * jac[None, :, :]).sum(dim=-1)

"""Camera-trajectory accumulation, plotting, and npz persistence.

Counterpart of `pytorch_model/vo/trajectory.py:19-263` (the reference's only
checkpoint/resume mechanism, SURVEY.md §5).
A copy of ``onnx_image_processing_tpu/vo/trajectory.py``.
"""

from __future__ import annotations

import numpy as np

from .pose import (
    compose_transformation,
    transformation_to_matrix,
    matrix_to_transformation,
)


class Trajectory:
    """Sequence of world-frame camera poses, starting at identity."""

    def __init__(self):
        self.poses: list[np.ndarray] = [np.eye(4, dtype=np.float64)]
        self.positions: list[np.ndarray] = [np.zeros(3, dtype=np.float64)]

    def add_relative_pose(self, r: np.ndarray, t: np.ndarray) -> None:
        """Append pose = last_pose @ [R|t]."""
        r_last, t_last = matrix_to_transformation(self.poses[-1])
        r_new, t_new = compose_transformation(r_last, t_last, r, t)
        self.poses.append(transformation_to_matrix(r_new, t_new))
        self.positions.append(t_new.ravel())

    def get_current_pose(self) -> np.ndarray:
        return self.poses[-1]

    def get_current_position(self) -> np.ndarray:
        return self.positions[-1]

    def get_positions_array(self) -> np.ndarray:
        return np.array(self.positions)

    def get_trajectory_length(self) -> float:
        pos = self.get_positions_array()
        if len(pos) < 2:
            return 0.0
        return float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())

    def __len__(self) -> int:
        return len(self.poses)

    # -- visualization ------------------------------------------------------

    def plot_2d(self, ax=None, show_orientation: bool = False,
                title: str = "Camera Trajectory (Top View)"):
        """X-Z top-view path plot; green start, red end, optional heading arrows."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(10, 10))
        pos = self.get_positions_array()
        ax.plot(pos[:, 0], pos[:, 2], "b-", linewidth=2, label="Trajectory")
        ax.plot(pos[0, 0], pos[0, 2], "go", markersize=10, label="Start")
        ax.plot(pos[-1, 0], pos[-1, 2], "ro", markersize=10, label="End")
        if show_orientation:
            step = max(1, len(self.poses) // 20)
            for i in range(0, len(self.poses), step):
                r, t = matrix_to_transformation(self.poses[i])
                fwd = r[:, 2] * 0.5
                ax.arrow(t[0], t[2], fwd[0], fwd[2], head_width=0.1,
                         head_length=0.1, fc="red", ec="red", alpha=0.5)
        ax.set_xlabel("X (meters)")
        ax.set_ylabel("Z (meters)")
        ax.set_title(title)
        ax.axis("equal")
        ax.grid(True)
        ax.legend()
        return ax

    def plot_3d(self, ax=None, show_orientation: bool = False,
                title: str = "Camera Trajectory (3D)"):
        """3-D path with equal aspect and optional pose axes."""
        import matplotlib.pyplot as plt

        if ax is None:
            fig = plt.figure(figsize=(12, 10))
            ax = fig.add_subplot(111, projection="3d")
        pos = self.get_positions_array()
        ax.plot(pos[:, 0], pos[:, 1], pos[:, 2], "b-", linewidth=2,
                label="Trajectory")
        ax.scatter(*pos[0], c="green", marker="o", s=100, label="Start")
        ax.scatter(*pos[-1], c="red", marker="o", s=100, label="End")
        if show_orientation:
            step = max(1, len(self.poses) // 20)
            for i in range(0, len(self.poses), step):
                r, t = matrix_to_transformation(self.poses[i])
                for j, color in enumerate("rgb"):
                    axis = r[:, j] * 0.3
                    ax.plot([t[0], t[0] + axis[0]], [t[1], t[1] + axis[1]],
                            [t[2], t[2] + axis[2]], color=color, alpha=0.5,
                            linewidth=1)
        ax.set_xlabel("X (meters)")
        ax.set_ylabel("Y (meters)")
        ax.set_zlabel("Z (meters)")
        ax.set_title(title)
        ax.legend()
        half = max((pos.max(0) - pos.min(0)).max() / 2.0, 1e-6)
        mid = (pos.max(0) + pos.min(0)) / 2.0
        ax.set_xlim(mid[0] - half, mid[0] + half)
        ax.set_ylim(mid[1] - half, mid[1] + half)
        ax.set_zlim(mid[2] - half, mid[2] + half)
        return ax

    # -- persistence ---------------------------------------------------------

    def save_to_file(self, filepath: str) -> None:
        np.savez(filepath, poses=np.array(self.poses),
                 positions=np.array(self.positions))

    @classmethod
    def load_from_file(cls, filepath: str) -> "Trajectory":
        data = np.load(filepath)
        traj = cls()
        traj.poses = list(data["poses"])
        traj.positions = list(data["positions"])
        return traj

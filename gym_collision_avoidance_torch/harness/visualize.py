"""Trajectory plotting / animation (host-side matplotlib); a copy of
:mod:`gym_collision_avoidance_tpu.harness.visualize`, which imports no JAX.

It takes numpy arrays: callers holding tensors pass ``.cpu().numpy()``.
matplotlib, imageio and cv2 are imported inside the functions that use them.

Functional port of the reference's visualization pipeline
(``envs/visualize.py:18-303``): per-agent color cycle, fading circles along
the trajectory with timestamps, per-episode PNGs, and GIF assembly — but
fed from device trajectory arrays ([T, A, 2] positions) instead of Agent
history buffers.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# matplotlib color cycle from the reference (envs/visualize.py:18-25).
PLT_COLORS = [
    [0.8500, 0.3250, 0.0980],  # orange
    [0.0, 0.4470, 0.7410],     # blue
    [0.4660, 0.6740, 0.1880],  # green
    [0.4940, 0.1840, 0.5560],  # purple
    [0.9290, 0.6940, 0.1250],  # yellow
    [0.3010, 0.7450, 0.9330],  # cyan
    [0.6350, 0.0780, 0.1840],  # chocolate
]


def _rgba2rgb(rgba):
    """envs/util.py:158-167 (white background alpha blend)."""
    alpha = rgba[3]
    return [
        max(min((1 - alpha) * 1.0 + alpha * c, 1.0), 0.0) for c in rgba[:3]
    ]


def plot_episode(
    positions: np.ndarray,
    radii: np.ndarray,
    goals: Optional[np.ndarray] = None,
    steps: Optional[int] = None,
    dt: float = 0.1,
    circles_along_traj: bool = True,
    limits=None,
    fig_size=(10, 8),
    title: str = "",
    save_path: Optional[str] = None,
    show: bool = False,
    static_map: Optional[np.ndarray] = None,
    map_extent=None,
    in_collision: Optional[np.ndarray] = None,
    perturbed: Optional[dict] = None,
):
    """Plot one episode's trajectories (cf. ``plot_episode``/``draw_agents``,
    envs/visualize.py:90-257).

    Args:
        positions: [T, A, 2] global-frame positions.
        radii: [A].
        goals: [A, 2] (drawn as stars).
        steps: only the first `steps` timesteps are drawn.
        in_collision: optional [A] bool; if any, the figure is ALSO saved
            under ``<dir>/collisions/<name>`` next to ``save_path`` — the
            reference's failed-episode copy (envs/visualize.py:34-35,
            148-149).
        perturbed: optional adversarial-perturbation overlay (the
            robustness-paper tooling, envs/visualize.py:259-303), a dict
            with keys ``other_pos`` [2] (true other-agent position),
            ``perturbed_pos`` [2] (perturbed position), ``radius`` float,
            and optionally ``steps`` [K, 2] (the perturbation's global-frame
            path, drawn as fading segments).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T, A, _ = positions.shape
    if steps is not None:
        T = min(T, int(steps))
    fig, ax = plt.subplots(figsize=fig_size)
    ax.set_aspect("equal")

    if static_map is not None:
        ax.imshow(
            static_map, cmap="Greys", origin="upper",
            extent=map_extent or (-8, 8, -8, 8), alpha=0.6,
        )

    for a in range(A):
        color = PLT_COLORS[a % len(PLT_COLORS)]
        xy = positions[:T, a]
        ax.plot(xy[:, 0], xy[:, 1], color=color, ls="-", linewidth=2)
        if circles_along_traj:
            # fading circles along the trajectory (visualize.py:178-231)
            stride = max(1, T // 12)
            for t in range(0, T, stride):
                alpha = 0.2 + 0.6 * t / max(T - 1, 1)
                c = _rgba2rgb(color + [alpha])
                ax.add_patch(
                    plt.Circle(xy[t], radius=radii[a], fc=c, ec=c)
                )
            ax.add_patch(
                plt.Circle(xy[T - 1], radius=radii[a],
                           fc=_rgba2rgb(color + [0.9]), ec=color)
            )
            # sparse timestamps (visualize.py:236-247)
            for t in range(0, T, max(1, 3 * stride)):
                ax.text(xy[t, 0] - 0.15, xy[t, 1] + 0.1,
                        f"{t * dt:.1f}", fontsize=8)
        if goals is not None:
            ax.plot(goals[a, 0], goals[a, 1], marker="*", markersize=14,
                    color=color)

    if perturbed is not None:
        _draw_perturbed_overlay(ax, plt, perturbed)

    if limits is not None:
        ax.set_xlim(limits[0])
        ax.set_ylim(limits[1])
    ax.set_title(title)
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        if in_collision is not None and np.any(np.asarray(in_collision)):
            cdir = os.path.join(os.path.dirname(save_path) or ".",
                                "collisions")
            os.makedirs(cdir, exist_ok=True)
            fig.savefig(os.path.join(cdir, os.path.basename(save_path)),
                        dpi=100, bbox_inches="tight")
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return save_path


def _draw_perturbed_overlay(ax, plt, perturbed: dict):
    """Adversarial-perturbation overlay (envs/visualize.py:259-303,
    re-designed without the Perturber class): the perturbed other-agent
    position as an open circle, x-markers at true/perturbed positions, and
    the perturbation path as segments fading in."""
    from matplotlib.collections import LineCollection

    adv_color = PLT_COLORS[-1]
    other = np.asarray(perturbed["other_pos"], float)
    pert = np.asarray(perturbed["perturbed_pos"], float)
    r = float(perturbed.get("radius", 0.3))
    ax.add_patch(plt.Circle(pert, radius=r, fill=False, ec=adv_color))
    ax.plot(*other, "x", color=PLT_COLORS[1], zorder=4)
    ax.plot(*pert, "x", color=adv_color, zorder=4)
    steps = perturbed.get("steps")
    if steps is not None and len(steps) >= 2:
        ps = np.asarray(steps, float)
        K = ps.shape[0] - 1
        colors = np.zeros((K, 4))
        colors[:, :3] = adv_color
        colors[:, 3] = np.linspace(0.2, 1.0, K)
        segs = np.stack([ps[:-1], ps[1:]], axis=1)
        ax.add_collection(LineCollection(segs, colors=colors,
                                         linestyle="solid"))


def animate_episode(
    positions: np.ndarray,
    radii: np.ndarray,
    goals: Optional[np.ndarray] = None,
    steps: Optional[int] = None,
    dt: float = 0.1,
    period_steps: int = 5,
    save_path: str = "episode.gif",
    save_mp4: bool = False,
    **plot_kwargs,
):
    """Assemble a GIF from per-step partial-trajectory frames
    (cf. ``animate_episode``, envs/visualize.py:40-88).  With ``save_mp4``
    the same frames are also encoded as ``<save_path minus .gif>.mp4``
    (the reference's gif→mp4 conversion, envs/visualize.py:81-88 — done
    here via OpenCV since neither moviepy nor ffmpeg is required)."""
    import imageio.v2 as imageio
    import tempfile

    T = positions.shape[0] if steps is None else int(steps)
    frames = []
    with tempfile.TemporaryDirectory() as td:
        for t in range(period_steps, T + period_steps, period_steps):
            f = os.path.join(td, f"f{t:05d}.png")
            plot_episode(
                positions, radii, goals=goals, steps=min(t, T), dt=dt,
                save_path=f, **plot_kwargs,
            )
            frames.append(imageio.imread(f))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    imageio.mimsave(save_path, frames, duration=0.1)
    if save_mp4:
        frames_to_mp4(frames, os.path.splitext(save_path)[0] + ".mp4")
    return save_path


def frames_to_mp4(frames, mp4_path: str, fps: int = 10) -> str:
    """Encode RGB(A) frames to MP4 with OpenCV (VideoWriter wants uniform
    even dims and BGR order)."""
    import cv2

    h = min(f.shape[0] for f in frames) // 2 * 2
    w = min(f.shape[1] for f in frames) // 2 * 2
    writer = cv2.VideoWriter(
        mp4_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    if not writer.isOpened():  # pragma: no cover
        raise RuntimeError("OpenCV mp4 writer failed to open")
    for f in frames:
        rgb = np.asarray(f)[:h, :w, :3]
        writer.write(rgb[:, :, ::-1].copy())
    writer.release()
    return mp4_path

"""3D point-cloud plotting (reference utils/pcutil.py:109-152, util.py:87-92).

A copy of ``hyperpocket_tpu/utils/plotting.py`` (numpy and matplotlib, no
framework); matplotlib is imported at use, with the Agg backend.
"""

from __future__ import annotations

from os.path import join

import numpy as np


def plot_3d_point_cloud(
    x, y, z, *, show=False, in_u_sphere=False, marker=".", s=8, alpha=0.8,
    figsize=(5, 5), elev=10, azim=240, axis=None, title=None, **kwargs
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if axis is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = axis
        fig = axis.figure
    if title is not None:
        plt.title(title)
    sc = ax.scatter(x, y, z, marker=marker, s=s, alpha=alpha, **kwargs)
    ax.view_init(elev=elev, azim=azim)
    if in_u_sphere:
        ax.set_xlim3d(-0.5, 0.5)
        ax.set_ylim3d(-0.5, 0.5)
        ax.set_zlim3d(-0.5, 0.5)
    else:
        lim = (min(np.min(x), np.min(y), np.min(z)), max(np.max(x), np.max(y), np.max(z)))
        ax.set_xlim(*lim)
        ax.set_ylim(*lim)
        ax.set_zlim(*lim)
    if show:
        import matplotlib.pyplot as plt

        plt.show()
    return fig


def save_plot(cloud_3n: np.ndarray, epoch, k, results_dir: str, tag: str) -> str:
    """Save one (3, N) cloud rendering; returns the figure path (util.py:87-92)."""
    import matplotlib.pyplot as plt

    fig = plot_3d_point_cloud(
        cloud_3n[0], cloud_3n[1], cloud_3n[2], in_u_sphere=True, show=False,
        title=f"{tag}_{k} epoch: {epoch}",
    )
    fig_path = join(results_dir, f"{epoch}_{k}_{tag}.png")
    fig.savefig(fig_path)
    plt.close(fig)
    return fig_path

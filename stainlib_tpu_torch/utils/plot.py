"""Notebook plotting helpers.

The port's own copy of the JAX package's ``utils/plot.py``: parity with
``stainlib/utils/plot_utils.py:5-37`` (``_plot_imagegrid``), a labeled
image-grid figure. matplotlib is imported lazily so the core library
carries no plotting dependency. Images may be numpy arrays or torch
tensors; a tensor on the card is copied to the host first.
"""

from __future__ import annotations

from typing import Optional, Sequence


def _host(image):
    """``image`` as a numpy array (a tensor goes through ``.cpu()``)."""
    import numpy as np

    if hasattr(image, "detach"):
        image = image.detach().cpu()
    return np.asarray(image)


def plot_image_grid(images: Sequence, titles: Optional[Sequence[str]] = None,
                    cols: int = 4, figsize_per_image: float = 3.0,
                    save_path: Optional[str] = None):
    """Show (or save) a grid of images with optional per-image titles."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(
        rows, cols,
        figsize=(cols * figsize_per_image, rows * figsize_per_image),
        squeeze=False,
    )
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(_host(images[i]))
            if titles is not None and i < len(titles):
                ax.set_title(str(titles[i]), fontsize=9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig

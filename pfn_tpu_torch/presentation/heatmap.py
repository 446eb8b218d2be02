"""Bar-distribution heatmaps: the PFN posterior p(y | x, D) drawn over (x, y).

Port of ``pfn_tpu/presentation/heatmap.py`` (reference
presentation/heatmap_bardistribution.py): the variable-size-box heatmap
(:21-35), ``plot_bar_distribution`` (:41-60) and the posterior-against-truth
plots ``plot_model_w_eval_pos`` and ``plot_model_and_orig_curve`` (:63-95),
on the port's model (which holds its weights: no ``params`` argument) and
criterion. The JAX module's two deviations from the reference stay: no
module-level ``print(ax.get_ylim())`` (the reference's :38, which breaks its
import), and one ``pcolormesh`` over the contiguous boxes in place of a
Rectangle patch per cell. matplotlib and seaborn are imported inside the
functions.
"""

from __future__ import annotations

import numpy as np
import torch


def _default_cmap():
    try:
        import seaborn as sns
    except ImportError:
        import matplotlib.pyplot as plt

        return plt.get_cmap("magma")
    return sns.color_palette("rocket", as_cmap=True)


def heatmap_with_box_sizes(ax, data, x_starts, x_ends, y_starts, y_ends, palette=None, set_lims=True):
    """Heatmap with per-column x-extents and per-row y-extents.

    data: (num_rows, num_cols); every start/end array sorted ascending and
    contiguous (``x_ends[i] == x_starts[i+1]``), as bar-distribution plots
    are by construction. Parity: heatmap_with_box_sizes (:21-35) without the
    per-cell Rectangle loop.
    """
    data = np.asarray(data, dtype=np.float64)
    x_starts, x_ends = np.asarray(x_starts), np.asarray(x_ends)
    y_starts, y_ends = np.asarray(y_starts), np.asarray(y_ends)
    if palette is None:
        palette = _default_cmap()
    if set_lims:
        ax.set_xlim(float(x_starts[0]), float(x_ends[-1]))
        ax.set_ylim(float(y_starts[0]), float(y_ends[-1]))
    data = (data - data.min()) / (data.max() - data.min() + 1e-12)
    x_edges = np.concatenate([x_starts, x_ends[-1:]])
    y_edges = np.concatenate([y_starts, y_ends[-1:]])
    return ax.pcolormesh(x_edges, y_edges, data, cmap=palette, shading="flat")


def plot_bar_distribution(ax, x, bar_borders, predictions, **kwargs):
    """Per-query bucket probabilities drawn as densities over (x, y).

    x: (T,) or (T, 1[, 1]) query inputs; predictions: (T, num_bars)
    probabilities (softmaxed logits); bar_borders: (num_bars + 1,). Parity:
    plot_bar_distribution (:41-60): sorted by x, divided by the bucket
    widths (probability to density), x-boxes spanning the midpoints between
    consecutive sorted xs.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    predictions = np.asarray(predictions, dtype=np.float64).reshape(len(x), -1)
    bar_borders = np.asarray(bar_borders, dtype=np.float64)
    if len(bar_borders) - 1 != predictions.shape[1]:
        raise ValueError(f"{len(bar_borders)} borders for {predictions.shape[1]} bars")

    order = np.argsort(x)
    x = x[order]
    density = predictions[order] / (bar_borders[1:] - bar_borders[:-1])
    mids = (x[1:] + x[:-1]) / 2
    x_starts = np.concatenate([x[:1], mids])
    x_ends = np.concatenate([mids, x[-1:]])
    return heatmap_with_box_sizes(ax, density.T, x_starts, x_ends, bar_borders[:-1], bar_borders[1:], **kwargs)


@torch.no_grad()
def plot_model_w_eval_pos(ax, model, criterion, x, y, single_eval_pos, min_max_y=None, **kwargs):
    """Forward the PFN (on its device) and draw the posterior at the eval
    positions.

    x: (T, F) or (1, T, F); y: (T,) or (1, T). Parity: plot_model_w_eval_pos
    (:63-76), with the min_max_y bucket windowing.
    """
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=device)
    if x.ndim == 2:
        x = x[None]
    if y.ndim == 1:
        y = y[None]
    logits = model(x, y, single_eval_pos)[0, single_eval_pos:]
    probs = torch.softmax(logits, dim=-1).cpu().numpy()
    borders = criterion.bar.borders.cpu().numpy().astype(np.float64)
    if min_max_y is not None:
        lo = int(np.searchsorted(borders, min_max_y[0]))
        hi = min(int(np.searchsorted(borders, min_max_y[1])), len(borders))
        probs = probs[..., lo: hi - 1]
        borders = borders[lo:hi]
    return plot_bar_distribution(ax, x[0, single_eval_pos:, 0].cpu().numpy(), borders, probs, **kwargs)


def plot_model_and_orig_curve(ax, model, criterion, x, y, given_indices=(0,)):
    """The ground-truth curve, the context points and the posterior heatmap
    everywhere.

    x: (T, 1) dense curve inputs, y: (T,). ``given_indices`` are the context
    points shown to the model; the posterior is drawn over all of x. Parity:
    plot_model_and_orig_curve (:79-95).
    """
    x = np.asarray(x, dtype=np.float32).reshape(-1, 1)
    y = np.asarray(y, dtype=np.float32).reshape(-1)
    gi = list(given_indices)
    x_winput = np.concatenate([x[gi], x], axis=0)
    y_winput = np.concatenate([y[gi], y], axis=0)

    ax.plot(x[:, 0], y, color="grey")
    ax.plot(x[gi, 0], y[gi], "o", color="black")
    try:
        import seaborn as sns
    except ImportError:
        import matplotlib.pyplot as plt

        palette = plt.get_cmap("Blues")
    else:
        palette = sns.cubehelix_palette(start=2, rot=0, dark=0.4, light=1, as_cmap=True)
    return plot_model_w_eval_pos(ax, model, criterion, x_winput, y_winput, len(gi),
                                 min_max_y=(float(y.min()) - 0.3, float(y.max()) + 0.3), palette=palette)

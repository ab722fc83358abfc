"""Loss / VI / AP / count-difference plotting.

The port of ``iterseg_tpu/eval/plots.py`` with its ``matplotlib``,
``seaborn`` and ``pandas`` imports moved inside the functions, so that the
metrics path imports none of them. A function that is handed the column
dicts of ``eval.metrics`` builds the frame it needs from them. Where those
packages are not installed a plot raises ``ImportError``.

API parity with iterseg ``plots.py`` for the functions the framework's
entry points use: ``save_loss_plot``, ``plot_loss``,
``save_channel_loss_plot``, ``plot_channel_losses``, ``VI_plot``,
``VI_plot_compare``, ``experiment_VI_plots``, ``plot_AP``,
``plot_count_difference``, ``compare_count_difference``, ``compare_AP``,
``comparison_plots``. Rendering uses a shared box+strip helper instead of
the reference's per-function duplication; outputs (files, axes content) are
equivalent.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np

__all__ = [
    "save_loss_plot",
    "plot_loss",
    "save_channel_loss_plot",
    "plot_channel_losses",
    "VI_plot",
    "VI_plot_compare",
    "experiment_VI_plots",
    "plot_AP",
    "plot_count_difference",
    "compare_count_difference",
    "compare_AP",
    "comparison_plots",
]

_NON_CHANNEL_COLS = ["Unnamed: 0", "epoch", "batch_num", "loss", "data_id"]


def _pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _box_strip(x, y, data, ax, palette="Set2", orient="h"):
    import seaborn as sns

    sns.boxplot(x=x, y=y, hue=x, data=data, palette=palette, ax=ax,
                legend=False)
    sns.stripplot(
        x=x, y=y, hue=x, data=data, palette=palette, edgecolor="white",
        ax=ax, size=3, jitter=1, zorder=0, dodge=True, linewidth=0.3,
        legend=False,
    )


# ---------------------------------------------------------------------------
# Loss plots
# ---------------------------------------------------------------------------


def save_loss_plot(path, loss_function, v_path=None, show=True):
    import pandas as pd

    df = pd.read_csv(path)
    vdf = pd.read_csv(v_path) if v_path is not None else None
    p = Path(path)
    out_path = os.path.join(p.parents[0], p.stem + "_loss.png")
    return plot_loss(df, vdf=vdf, x_lab="Iteration", y_lab=loss_function,
                     save=out_path, show=show)


def _loss_series(df):
    """(iterations, loss, last-batch-of-each-epoch indices) from a loss
    CSV frame."""
    if "Unnamed: 0" in df:
        iterations = df["Unnamed: 0"].to_numpy()
    else:
        iterations = df.index.to_numpy()
    n_epochs = df["epoch"].nunique()
    per_epoch = len(iterations) // max(n_epochs, 1)
    last_of_epoch = per_epoch * np.arange(1, n_epochs + 1) - 1
    return iterations, df["loss"].to_numpy(), last_of_epoch


def _validation_series(vdf, iterations, last_of_epoch):
    """Validation overlay points: per-epoch means when the CSV holds one
    row per validation batch, the raw column otherwise."""
    if len(vdf) > len(last_of_epoch):
        grouped = vdf.groupby("batch_id").mean(numeric_only=True)
        return vdf["batch_id"].unique(), grouped["validation_loss"].to_numpy()
    return iterations[last_of_epoch], vdf["validation_loss"].to_numpy()


def plot_loss(df, vdf=None, x_lab="Iteration", y_lab="BCE Loss", save=None,
              show=True):
    """Training-loss curve with epoch-end markers and an optional
    validation overlay. Figure-content parity with the reference
    (plots.py:30-66): identical series, markers, labels, legend, canvas
    size and dpi.
    """
    plt = _pyplot()
    iterations, loss, last_of_epoch = _loss_series(df)
    fig, ax = plt.subplots()
    ax.plot(iterations, loss, linewidth=2)
    ax.scatter(iterations[last_of_epoch], loss[last_of_epoch])
    series = ["loss"]
    title = "Training loss"
    if vdf is not None:
        v_iter, v_loss = _validation_series(vdf, iterations, last_of_epoch)
        ax.plot(v_iter, v_loss, linewidth=2, marker="o")
        series.append("validation loss")
        title += " with validation loss"
    ax.set(xlabel=x_lab, ylabel=y_lab)
    ax.set_title(title)
    ax.legend(series)
    fig.set_size_inches(13, 9)
    if save is not None:
        plt.savefig(save, dpi=300)
    if show:
        plt.show()
    plt.close(fig)
    return fig, ax


def save_channel_loss_plot(path, show=True):
    import pandas as pd

    df = pd.read_csv(path)
    p = Path(path)
    out_path = os.path.join(p.parents[0], p.stem + "_channel-loss.png")
    return plot_channel_losses(df, save=out_path, show=show)


def plot_channel_losses(df, x_lab="Iteration", y_lab="BCE Loss", save=None,
                        show=True):
    """Per-channel loss curves: 2×2 grid by channel family when >5
    channels, otherwise affinities + interior panels
    (parity: plots.py:80-141)."""
    plt = _pyplot()
    cols = list(df.columns)
    x = df.index.values if "Unnamed: 0" not in df else df["Unnamed: 0"].values
    channel_losses = [c for c in cols if c not in _NON_CHANNEL_COLS]

    def _style(n):
        return ["-", "--", ":"][min(n, 2)]

    if len(channel_losses) > 5:
        fig, axs = plt.subplots(2, 2)
        panels = {
            "z": (axs[0, 0], "Z affinities losses"),
            "y": (axs[0, 1], "Y affinities losses"),
            "x": (axs[1, 0], "X affinities losses"),
            "c": (axs[1, 1], "Object interior losses"),
        }
        seen = {k: [] for k in panels}
        for col in channel_losses:
            key = (
                col[0] if col[0] in "zyx"
                else ("c" if col.startswith("cent") or col == "mask"
                      else None)
            )
            if key is None:
                continue
            ax, _ = panels[key]
            ax.plot(x, df[col].values, linewidth=1,
                    linestyle=_style(len(seen[key])))
            seen[key].append(col)
        for key, (ax, title) in panels.items():
            ax.set_title(title)
            ax.legend(seen[key])
        fig.set_size_inches(13, 9)
    else:
        fig, axs = plt.subplots(2, 1)
        affs, cs = [], []
        for col in channel_losses:
            if col[0] in "zyx":
                axs[0].plot(x, df[col].values, linewidth=2,
                            linestyle=_style(len(affs)))
                affs.append(col)
            elif col.startswith("cent") or col == "mask":
                axs[1].plot(x, df[col].values, linewidth=2)
                cs.append(col)
        axs[0].set_title("Affinities losses")
        axs[0].legend(affs)
        axs[1].set_title("Object interior losses")
        axs[1].legend(cs)
        fig.set_size_inches(14, 14)
    for ax in np.asarray(axs).flat:
        ax.set(xlabel=x_lab, ylabel=y_lab)
    if save is not None:
        plt.savefig(save, dpi=300)
    if show:
        plt.show()
    plt.close(fig)
    return fig, axs


# ---------------------------------------------------------------------------
# VI plots
# ---------------------------------------------------------------------------


def VI_plot(df, cond_ent_over="GT | Output", cond_ent_under="Output | GT",
            lab="Variation of information", save=False, show=True, ax=None,
            title=True, palette="Set2", orient="h", sigma=0.2,
            compare=False):
    import pandas as pd

    plt = _pyplot()
    overseg = np.asarray(df[cond_ent_over])
    underseg = np.asarray(df[cond_ent_under])
    data = pd.DataFrame({
        lab: [cond_ent_over] * len(overseg) + [cond_ent_under] * len(
            underseg
        ),
        "Conditional entropy": np.concatenate([overseg, underseg]),
    })
    created = ax is None
    if created:
        f, ax = plt.subplots(figsize=(8, 6))
    _box_strip(lab, "Conditional entropy", data, ax, palette, orient)
    if save and title:
        ax.set_title(Path(save).stem)
    if save:
        plt.savefig(save, bbox_inches="tight")
    if show:
        plt.show()
    if created:
        plt.close(ax.figure)


def VI_plot_compare(df, ax0, ax1, comparison_name, conditions,
                    cond_ent_over="VI: GT | Output",
                    cond_ent_under="VI: Output | GT", palette="Set2",
                    orient="h", sigma=0.2, name="model_name"):
    import seaborn as sns

    for ax, col in ((ax0, cond_ent_over), (ax1, cond_ent_under)):
        _box_strip(name, col, df, ax, palette, orient)
        ax.set_ylabel(comparison_name)
        sns.despine(ax=ax)
        ax.legend([], [], frameon=False)


def experiment_VI_plots(dfs, names, title, out_name, out_dir,
                        cond_ent_over="GT | Output",
                        cond_ent_under="Output | GT", show=True):
    import pandas as pd

    plt = _pyplot()
    plt.rcParams.update({"font.size": 16})
    groups, ce0, ce1 = [], [], []
    for i, df in enumerate(dfs):
        ce0.append(np.asarray(df[cond_ent_over]))
        ce1.append(np.asarray(df[cond_ent_under]))
        groups += [names[i]] * len(ce0[-1])
    data = pd.DataFrame({
        "Experiment": groups,
        cond_ent_over: np.concatenate(ce0),
        cond_ent_under: np.concatenate(ce1),
    })
    f, axs = plt.subplots(1, 2, figsize=(8, 6))
    _box_strip("Experiment", cond_ent_over, data, axs[0])
    axs[0].set_title("Over-segmentation conditional entropy")
    _box_strip("Experiment", cond_ent_under, data, axs[1])
    axs[1].set_title("Under-segmentation conditional entropy")
    f.suptitle(title)
    os.makedirs(out_dir, exist_ok=True)
    save_path = os.path.join(out_dir, out_name + "_VI_rainclould_plots.png")
    plt.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(f)


# ---------------------------------------------------------------------------
# AP & count-difference plots
# ---------------------------------------------------------------------------


def plot_AP(dfs, names, out_path, title, thresh_name="threshold",
            ap_name="average_precision", show=True, add_title=True):
    plt = _pyplot()
    plt.rcParams.update({"font.size": 16})
    fig = plt.figure(figsize=(8, 8))
    for df in dfs:
        plt.plot(np.asarray(df[thresh_name]), np.asarray(df[ap_name]))
    plt.xlabel("IoU threshold")
    plt.ylabel("Average precision")
    if add_title:
        plt.title(title)
    plt.legend(names)
    fig.savefig(out_path)
    if show:
        plt.show()
    plt.close(fig)


def plot_count_difference(df, title, out_path, col_name="Count difference",
                          show=True):
    import pandas as pd

    plt = _pyplot()
    plt.rcParams.update({"font.size": 16})
    n_diff = np.asarray(df[col_name])
    data = pd.DataFrame({
        "Experiment": ["model"] * len(n_diff),
        "n_diff": n_diff,
    })
    f, ax = plt.subplots(figsize=(10, 10))
    _box_strip("Experiment", "n_diff", data, ax)
    plt.title(title)
    f.savefig(out_path)
    if show:
        plt.show()
    plt.close(f)


def compare_count_difference(df, ax, comparison_name, conditions,
                             col_name="Count difference", palette="Set2",
                             orient="h", sigma=0.2, name="model_name"):
    import seaborn as sns

    _box_strip(name, col_name, df, ax, palette, orient)
    ax.set_ylabel(comparison_name)
    sns.despine(ax=ax)
    ax.legend([], [], frameon=False)


def compare_AP(df, ax, palette, conditions, name="model_name",
               ap_col="average_precision", thresh_col="threshold"):
    import pandas as pd
    import seaborn as sns

    conditions = pd.unique(df[name])
    sns.lineplot(x=thresh_col, y=ap_col, hue=name, hue_order=conditions,
                 data=df, ax=ax, palette=palette)
    ax.set_xlabel("IOU threshold")
    ax.set_ylabel("Average precision")
    sns.despine(ax=ax)


# ---------------------------------------------------------------------------
# Multi-model comparison figure
# ---------------------------------------------------------------------------


def comparison_plots(
    comparison_directory: str,
    save_name: str,
    file_exstention: str = "pdf",
    output_directory: Union[str, None] = None,
    variation_of_information: bool = True,
    object_difference: bool = True,
    average_precision: bool = True,
    n_rows: int = 2,
    n_col: int = 2,
    comparison_name: str = "Model comparison",
    VI_indexs: tuple = (0, 1),
    OD_index: int = 2,
    AP_index: int = 3,
    fig_size: tuple = (7, 6),
    raincloud_orientation: str = "h",
    raincloud_sigma: float = 0.2,
    palette: str = "Set2",
    top_white_space: float = 5,
    left_white_space: float = 15,
    right_white_space: float = 5,
    bottom_white_space: float = 10,
    horizontal_white_space: float = 40,
    vertical_white_space: float = 40,
    font_size: int = 30,
    style: str = "ticks",
    context: str = "paper",
    show: bool = True,
):
    """Collate all ``*_scores.csv`` / ``*_AP_curve.csv`` in a directory into
    one comparison figure (parity: plots.py:430-639)."""
    import matplotlib
    import pandas as pd
    import seaborn as sns

    plt = _pyplot()
    VIOD_files = [
        os.path.join(comparison_directory, f)
        for f in os.listdir(comparison_directory)
        if f.endswith("_scores.csv")
    ]
    metrics_VIOD = pd.concat(
        [pd.read_csv(p) for p in VIOD_files]
    ).reset_index(drop=True)
    AP_files = [
        os.path.join(comparison_directory, f)
        for f in os.listdir(comparison_directory)
        if f.endswith("_AP_curve.csv")
    ]
    metrics_AP = pd.concat([pd.read_csv(p) for p in AP_files]).reset_index(
        drop=True
    )
    conditions = pd.unique(metrics_VIOD["model_name"])

    matplotlib.rcParams.update({"font.size": font_size})
    sns.set_context(context)
    sns.set_style(style)
    plt.rcParams["svg.fonttype"] = "none"
    fig, axs = plt.subplots(nrows=n_rows, ncols=n_col)
    is_int = []
    if variation_of_information:
        is_int += [isinstance(VI_indexs[0], int),
                   isinstance(VI_indexs[1], int)]
    if average_precision:
        is_int.append(isinstance(AP_index, int))
    if object_difference:
        is_int.append(isinstance(OD_index, int))
    if np.sum(is_int) == len(is_int):
        axs = np.asarray(axs).ravel()
    fig.set_size_inches(fig_size)
    if variation_of_information:
        VI_plot_compare(
            metrics_VIOD, axs[VI_indexs[0]], axs[VI_indexs[1]],
            comparison_name, conditions, palette=palette,
            orient=raincloud_orientation, sigma=raincloud_sigma,
        )
    if object_difference:
        compare_count_difference(
            metrics_VIOD, axs[OD_index], comparison_name, conditions,
            palette=palette, orient=raincloud_orientation,
            sigma=raincloud_sigma,
        )
    if average_precision:
        compare_AP(metrics_AP, axs[AP_index], palette, conditions)

    fig.subplots_adjust(
        right=1 - right_white_space / 100,
        left=left_white_space / 100,
        bottom=bottom_white_space / 100,
        top=1 - top_white_space / 100,
        wspace=horizontal_white_space / 100,
        hspace=vertical_white_space / 100,
    )
    if output_directory is None:
        output_directory = comparison_directory
    save_path = os.path.join(output_directory,
                             save_name + "." + file_exstention)
    fig.savefig(save_path)
    if show:
        plt.show()
    plt.close(fig)
    return save_path
